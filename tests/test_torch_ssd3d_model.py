"""3DSSD in the port (``models/ssd3d.py``, ``evaluator.build_ssd3d_eval_step``,
the eval CLI) against its plain f32 reference (``tests/ssd3d_reference.py``)
on the CPU, at ``tests/cfgs_3dssd_tiny.yaml``: the published layer
structure with fewer points, picks and channels.

Each stage is held given the port's own inputs to it (a flipped pick or
neighbour would part the two runs for good): the sampling's and the ball
query's index sets exactly; the SA features, the vote offsets and the
head's outputs within a tolerance (below); the decoded boxes and the NMS
survivors exactly."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pointrcnn_tpu_torch import ssd3d_config
from pointrcnn_tpu_torch.eval.__main__ import main
from pointrcnn_tpu_torch.eval.evaluator import build_ssd3d_eval_step
from pointrcnn_tpu_torch.models.ssd3d import SSD3D, postprocess
from pointrcnn_tpu_torch.train.checkpoint import save_checkpoint
from pointrcnn_tpu_torch.train.state import TrainState

import ssd3d_reference as ref
from kitti_fixture import make_mini_kitti
from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_CFG = str(REPO / "tests" / "cfgs_3dssd_tiny.yaml")
SHIPPED_CFG = str(REPO / "pointrcnn_tpu_torch" / "cfgs" / "3dssd_car.yaml")
# relative max-norm gaps, the largest gap over the reference's largest
# magnitude.  f32: the port folds BN into the weights and sums in another
# order, a few ulps a layer (measured below 3e-6).  bf16: every MLP operand
# is rounded to bf16 (2^-9 relative) through stacks up to five layers deep
# (measured 2e-3 - 1.2e-2; computing in fp8 reads 5e-2 and more).
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _rel(p, r) -> float:
    return float((p.float() - r.float()).abs().max() / r.float().abs().max())


def _weights(model, seed):
    """Seeded BN statistics and biases beside the initialisers' weights."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("_var"):
                v.copy_(0.8 + 0.4 * torch.rand(v.shape, generator=g))
            elif k.endswith(("_mean", "_bias", ".bias")) or k.rsplit(".", 1)[-1].startswith("b"):
                v.copy_(0.1 * torch.rand(v.shape, generator=g) - 0.05)
        model.reg_out.bias[3:6] += torch.tensor([1.9, 0.8, 0.8])
        model.reg_out.weight.mul_(0.1)


def _points(batch, n, seed):
    """Points in an 8 m x 8 m patch, so that car-sized boxes around the
    votes overlap and the NMS suppresses some."""
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(batch, n, 3, generator=g) * torch.tensor([8.0, 2.0, 8.0])
    inten = torch.rand(batch, n, 1, generator=g)
    return torch.cat([xyz + torch.tensor([-4.0, 0.0, 10.0]), inten], -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_the_reference_stage_by_stage(dtype, seed):
    cfg = ssd3d_config.load_config(TINY_CFG, ["COMPUTE_DTYPE", dtype])
    model = SSD3D(cfg, torch.Generator().manual_seed(seed)).eval()
    _weights(model, seed)
    p, c = model.state_dict(), ref.plain(cfg)
    pts = _points(2, cfg.NUM_POINTS, seed)
    with torch.inference_mode():
        out = model(pts)
        xyz, feats = pts[..., :3], pts[..., 3:]
        for k in range(3):
            s = f"sa{k + 1}"
            assert torch.equal(out[f"{s}_sample_idx"].long(), ref.sa_sample(c, k, xyz, feats))
            centres = ref.gather(xyz, out[f"{s}_sample_idx"])
            assert torch.equal(out[f"{s}_xyz"], centres)
            q = ref.sa_query(c, k, xyz, centres)
            assert all(torch.equal(a.long(), b) for a, b in zip(out[f"{s}_query_idx"], q))
            f = ref.sa_features(p, c, k, xyz, feats, centres, q)
            assert _rel(out[f"{s}_features"], f) < TOL[dtype], (s, _rel(out[f"{s}_features"], f))
            xyz, feats = centres, out[f"{s}_features"]
        n = cfg.VOTE.NUM_POINTS
        v = ref.votes(p, c, xyz[:, :n], feats[:, :n])
        assert _rel(out["votes"] - xyz[:, :n], v - xyz[:, :n]) < TOL[dtype]
        q = ref.agg_query(c, xyz, out["votes"])
        assert all(torch.equal(a.long(), b) for a, b in zip(out["agg_query_idx"], q))
        cls, reg = ref.head(p, c, ref.agg_features(p, c, xyz, feats, out["votes"], q))
        assert _rel(out["cls"], cls) < TOL[dtype] and _rel(out["reg"], reg) < TOL[dtype]
        post = postprocess(cfg, out)
        scores, boxes, kept = ref.post(c, out["votes"], out["cls"], out["reg"])
    assert torch.equal(post["scores"], scores) and torch.equal(post["pred_boxes3d"], boxes)
    for f in range(2):
        assert torch.equal(post["sel_idx"][f][post["sel_valid"][f]], kept[f])
    # boxes of car size around the votes: the NMS suppresses some
    assert 0 < sum(len(k) for k in kept) < 2 * n


def test_eval_step_and_reference_forward_agree_at_f32():
    """The whole eval step (the port's f32 setting) and the reference's
    whole forward on their own inputs: every index set, the survivors."""
    cfg = ssd3d_config.load_config(TINY_CFG, ["COMPUTE_DTYPE", "float32"])
    model = SSD3D(cfg, torch.Generator().manual_seed(3)).eval()
    _weights(model, 3)
    pts = _points(2, cfg.NUM_POINTS, 3)
    seen = {}
    model.register_forward_hook(lambda m, a, o: seen.update(o))
    got = build_ssd3d_eval_step(model, cfg, with_gt=False)(pts)
    c = ref.plain(cfg)
    with torch.inference_mode():
        want = ref.forward(model.state_dict(), c, pts)
        _, _, kept = ref.post(c, want["votes"], want["cls"], want["reg"])
    for k in ("sa1_sample_idx", "sa2_sample_idx", "sa3_sample_idx"):
        assert torch.equal(seen[k].long(), want[k])
    assert _rel(seen["reg"], want["reg"]) < TOL["float32"]
    for f in range(2):
        assert torch.equal(got["sel_idx"][f][got["sel_valid"][f]], kept[f])


def test_shipped_config_is_the_published_one():
    cfg = ssd3d_config.load_config(SHIPPED_CFG)
    assert cfg == ssd3d_config.default_config().freeze()
    model = SSD3D(cfg)
    widths = [getattr(model.backbone.SetAbstractionMSG_2, f"SharedMLP_{i}").w0.shape
              for i in range(3)]
    assert widths == [(131, 128)] * 3
    assert model.vote_aggregation.SharedMLP_1.w0.shape == (259, 256)
    assert model.shared.w0.shape == (1536, 512) and model.reg_out.weight.shape == (30, 128)
    assert ssd3d_config.family_of(SHIPPED_CFG) == "3dssd"
    assert ssd3d_config.family_of(str(REPO / "cfgs" / "default.yaml")) == "pointrcnn"


def test_reference_copy_is_verbatim_and_imports_no_program():
    assert (REPO / "benchmark" / "reference" / "ssd3d.py").read_text() == \
        (REPO / "tests" / "ssd3d_reference.py").read_text()
    code = ("import sys; sys.path.insert(0, 'tests'); import ssd3d_reference; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'pointrcnn_tpu', 'pointrcnn_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"


def test_eval_cli_runs_3dssd_to_its_result_files(tmp_path):
    tree = str(tmp_path / "kitti")
    make_mini_kitti(tree, num_samples=4, n_points=2500, seed=5, split="val")
    cfg = ssd3d_config.load_config(TINY_CFG)
    model = SSD3D(cfg, torch.Generator().manual_seed(0))
    _weights(model, 0)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), TrainState(step=0, model=model, opt_state={}),
                           3, 0)
    out = tmp_path / "out"
    ret = main(["--cfg_file", TINY_CFG, "--eval_mode", "rcnn", "--ckpt", ckpt, "--data_root",
                tree, "--batch_size", "2", "--workers", "1", "--device", "cpu",
                "--output_dir", str(out)])
    files = sorted(os.listdir(out / "final_result" / "data"))
    assert files == [f"{i:06d}.txt" for i in range(4)]
    data = out / "final_result" / "data"
    lines = [ln for f in files for ln in (data / f).read_text().splitlines()]
    assert lines and all(ln.startswith("Car ") and len(ln.split()) == 16 for ln in lines)
    assert ret["total_gt_bbox"] >= 1 and 0.0 <= ret["recall_0.1"] <= 1.0
    assert any(k.startswith("Car_") for k in ret), sorted(ret)
    with pytest.raises(ValueError, match="--eval_mode rcnn"):
        main(["--cfg_file", TINY_CFG, "--eval_mode", "rpn", "--ckpt", ckpt, "--data_root", tree,
              "--device", "cpu", "--output_dir", str(out)])
