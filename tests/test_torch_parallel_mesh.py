"""``pointrcnn_tpu_torch.parallel.mesh`` on the CPU: the slices a rank
holds, the identities of a world of one, the batch statistics and their
gradients over two ``gloo`` ranks whose rows differ (against one process on
all the rows), the bucketed gradient all-reduce, ``entry.train_entry``'s
joint stage refused under a group, and
``entry.dryrun_multichip(2)`` (the counterpart of
``__graft_entry__.dryrun_multichip``) with its config against JAX's.

The statistics are sums in another order on two ranks: within 1e-6 of
their magnitude (measured in the comment of ``STAT_TOL``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pointrcnn_tpu.config import default_config as jax_default_config

from pointrcnn_tpu_torch.entry import dryrun_config, dryrun_multichip
from pointrcnn_tpu_torch.parallel import mesh

from test_torch_port_slice import _plain, one_torch_thread  # noqa: F401 (fixture)
from torch_ranks import bn_rows, joint_entry_error, reduce_grads, run_ranks

# f32 sums of 2 x 64 rows taken as two partial sums: relative to each
# quantity's largest magnitude
STAT_TOL = 1e-6


def test_shards_follow_the_data_axis():
    batch = {"pts_input": np.arange(24).reshape(6, 4), "gt_valid": torch.arange(6),
             "scalar": np.float32(2.0), "other": np.zeros(3)}
    parts = [mesh.shard_batch(batch, r, 3) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate([p["pts_input"] for p in parts]),
                                  batch["pts_input"])
    assert [p["gt_valid"].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    assert all(p["scalar"] is batch["scalar"] and p["other"] is batch["other"] for p in parts)
    with pytest.raises(ValueError, match="a batch of 6 frames does not divide over a world "
                                         "of 4 ranks"):
        mesh.shard_batch(batch, 0, 4)
    # eval's slices of a batch the world does not divide: a frame apart, in order
    assert [mesh.shard_bounds(3, r, 2, even=False) for r in range(2)] == [(0, 1), (1, 3)]
    assert [mesh.shard_bounds(1, r, 2, even=False) for r in range(2)] == [(0, 0), (0, 1)]


def test_world_of_one_is_the_identity():
    assert not mesh.active() and (mesh.rank(), mesh.world()) == (0, 1)
    x = torch.ones(3, requires_grad=True)
    grads = [torch.ones(2)]
    assert mesh.all_reduce_sum(x) is x and mesh.all_reduce_grads(grads) is grads
    assert mesh.local_rows(x) is x and mesh.global_shape((3, 4)) == (3, 4)
    batch = {"pts_input": np.zeros((3, 2))}
    assert mesh.shard_batch(batch) is batch
    with mesh.process_group("cpu") as device:
        assert device == torch.device("cpu") and not mesh.active()
    assert mesh.gather_to_rank0(5) == [5] and mesh.broadcast_object(5) == 5


def test_batch_stats_and_gradients_over_two_ranks(tmp_path):
    rng = np.random.RandomState(0)
    # the ranks' rows differ in scale and offset
    rows = np.concatenate([rng.normal(0, 1, (2, 32, 5)), rng.normal(3, 0.2, (2, 32, 5))])
    rows = rows.astype(np.float32)
    weights = rng.uniform(-1, 1, rows.shape).astype(np.float32)
    want = bn_rows(rows, weights)
    got = run_ranks(bn_rows, 2, tmp_path, rows, weights)
    for r, g in enumerate(got):
        assert g["n"] == want["n"] == 128
        for k in ("loss", "mean", "var", "grad_scale"):
            np.testing.assert_allclose(g[k], want[k], rtol=0,
                                       atol=STAT_TOL * float(want[k].abs().max()), err_msg=k)
        for a, b in zip(g["running"], want["running"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=STAT_TOL * float(b.abs().max()))
        # each rank's rows get the gradient of the global loss
        ref = want["grad_rows"][2 * r:2 * r + 2]
        np.testing.assert_allclose(g["grad_rows"], ref, rtol=0,
                                   atol=STAT_TOL * float(ref.abs().max()))
        assert torch.equal(g["running"][0], got[0]["running"][0])
    # a backward that keeps the rank's own cotangent misses the other rank's
    # share of the mean's and variance's: the bound catches it
    cut = run_ranks(bn_rows, 2, tmp_path / "cut", rows, weights, True)
    d = float((cut[0]["grad_rows"] - want["grad_rows"][:2]).abs().max())
    assert d > 100 * STAT_TOL * float(want["grad_rows"][:2].abs().max())


def test_gradients_summed_in_buckets(tmp_path):
    rng = np.random.RandomState(1)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (100,), (2,), (7, 9))]
    for bucket in (16, 1 << 20):
        got = run_ranks(reduce_grads, 2, tmp_path / str(bucket), grads, bucket)
        for g, ref in zip(got[0], grads):
            np.testing.assert_allclose(g, 3 * ref, rtol=1e-6)
        assert all(torch.equal(a, b) for a, b in zip(*got))


def test_joint_train_entry_refuses_a_group(tmp_path):
    """The joint stage's batch moves gt boxes with a forward in training,
    whose dropout draws a rank would keep only its share of: it is built in
    one process, and under a group it raises."""
    errors = run_ranks(joint_entry_error, 2, tmp_path)
    assert all("not under a process group (world 2)" in e for e in errors), errors


def test_dryrun_config_is_the_graft_entry_config():
    """``entry.DRYRUN_OVERRIDES`` against ``__graft_entry__.py:116-153``'s
    assignments (copied here), with the cloud's channel count set as the
    port reads it."""
    cfg = jax_default_config()
    cfg.RPN.NUM_POINTS = 4096
    cfg.RPN.SA_CONFIG.NPOINTS = [1024, 256, 64]
    cfg.RPN.SA_CONFIG.RADIUS = [[0.2, 0.6], [0.6, 1.2], [1.2, 2.4]]
    cfg.RPN.SA_CONFIG.NSAMPLE = [[8, 16], [8, 16], [8, 16]]
    cfg.RPN.SA_CONFIG.MLPS = [[[8, 16], [8, 16]], [[16, 32], [16, 32]], [[32, 32], [32, 32]]]
    cfg.RPN.FP_MLPS = [[32, 32], [32, 32], [32, 32]]
    cfg.RPN.CLS_FC = [32]
    cfg.RPN.REG_FC = [32]
    cfg.RPN.LOSS_CLS = "SigmoidFocalLoss"
    cfg.RPN.NMS_MAX_CANDIDATES = 256
    cfg.RCNN.ENABLED = True
    cfg.RCNN.ROI_SAMPLE_JIT = True
    cfg.RCNN.NUM_POINTS = 64
    cfg.RCNN.ROI_PER_IMAGE = 16
    cfg.RCNN.ROI_FG_AUG_TIMES = 3
    cfg.RCNN.SA_CONFIG.NPOINTS = [32, -1]
    cfg.RCNN.SA_CONFIG.RADIUS = [0.4, 100]
    cfg.RCNN.SA_CONFIG.NSAMPLE = [8, 16]
    cfg.RCNN.SA_CONFIG.MLPS = [[32, 32], [32, 64]]
    cfg.RCNN.XYZ_UP_LAYER = [32, 32]
    cfg.RCNN.CLS_FC = [32]
    cfg.RCNN.REG_FC = [32]
    cfg.RCNN.MAX_GT_BOXES = 4
    cfg.TRAIN.RPN_PRE_NMS_TOP_N = 256
    cfg.TRAIN.RPN_POST_NMS_TOP_N = 32
    cfg.TEST.RPN_PRE_NMS_TOP_N = 256
    cfg.TEST.RPN_POST_NMS_TOP_N = 16
    cfg.TRAIN.OPTIMIZER = "adam_onecycle"
    cfg.RPN.USE_INTENSITY = False
    assert _plain(dryrun_config()) == _plain(cfg.freeze())


def test_dryrun_multichip_two_ranks(capsys):
    record = dryrun_multichip(2, device="cpu", timeout_s=300)
    assert (record["world"], record["backend"], record["device"]) == (2, "gloo", "cpu")
    assert len(record["losses"]) == 3 and np.isfinite(record["losses"]).all()
    assert np.isfinite(record["resumed_loss"])
    # one rcnn row a roi of each frame: 2 frames x TEST.RPN_POST_NMS_TOP_N
    # on the CPU a frame's outputs are the same bits in either batch
    assert record["eval_shape"] == [2 * 16, 1]
    assert record["eval_max_rel"] == 0.0 and record["eval_rois_agree"] == 1.0
    assert record["launches"] == {k: 0 for k in record["launches"]}  # plain versions
    out = capsys.readouterr().out
    assert "3 train steps OK" in out and "checkpoint round-trip OK" in out
    assert "sharded joint-eval step OK" in out
