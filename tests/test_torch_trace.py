"""The port's tracing (``pointrcnn_tpu_torch/trace.py``) and host-sync
counters (``ops/counts.py``) on the CPU at a tiny size.

- a tiny eval step and a tiny rcnn train step: one root a step, and every
  span under the parent the layer map gives it;
- ``greedy_suppress`` on hand-built overlap matrices whose Jacobi step
  count is known: ``nms.jacobi`` counts one read a step;
- ``counts.read()`` keeps its keys, ``reset()`` zeroes the syncs;
- the outputs bit for bit the same with tracing enabled and disabled;
- nothing recorded while tracing is disabled.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.config import load_config
from pointrcnn_tpu_torch.entry import rcnn_config, synthetic_scene, train_entry
from pointrcnn_tpu_torch.eval.evaluator import build_joint_eval_step
from pointrcnn_tpu_torch.models import point_rcnn
from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN
from pointrcnn_tpu_torch.ops import counts
from pointrcnn_tpu_torch.ops.nms import greedy_suppress
from pointrcnn_tpu_torch.train import state as train_state

from test_torch_port_slice import TINY, one_torch_thread  # noqa: F401 (fixture)

_CFG = pathlib.Path(__file__).resolve().parent.parent / "cfgs" / "default.yaml"
# the rcnn stage's TRAIN proposal budget cut to the tiny cloud
RCNN_TINY = TINY + ["TRAIN.RPN_PRE_NMS_TOP_N", "256", "TRAIN.RPN_POST_NMS_TOP_N", "32",
                    "RCNN.ROI_PER_IMAGE", "16"]
SA, FP = ["pointnet2.SA1", "pointnet2.SA2", "pointnet2.SA3"], \
    ["pointnet2.FP1", "pointnet2.FP2", "pointnet2.FP3"]


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.disable()
    trace.reset()
    counts.reset()
    yield
    trace.disable()
    trace.reset()


def _eval_step(seed=0, batch=2):
    cfg = load_config(str(_CFG), TINY)
    model = PointRCNN(cfg, mode="TEST", generator=torch.Generator().manual_seed(seed)).eval()
    scene = synthetic_scene(batch, cfg.RPN.NUM_POINTS, cfg.RCNN.MAX_GT_BOXES, seed)
    args = (torch.from_numpy(scene["pts_input"]), torch.from_numpy(scene["gt_boxes3d"]),
            torch.from_numpy(scene["gt_valid"]))
    return build_joint_eval_step(model, cfg, with_gt=True), args


def _parents(recs):
    """{span name: set of its parents' names}."""
    out = {}
    for r in recs:
        out.setdefault(r.name, set()).add(r.parent)
    return out


def _check_roots(recs, root_name, steps):
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == [root_name] * steps
    ids = {r.id for r in roots}
    assert all(r.root in ids for r in recs)
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.parent is not None:
            p = by_id[r.parent_id]
            assert p.name == r.parent and p.root == r.root
            assert p.host_start_ns <= r.host_start_ns <= r.host_end_ns <= p.host_end_ns
        assert r.device_start_ns is None  # no card: no events
    return roots


def test_eval_step_spans_nest():
    step, args = _eval_step()
    trace.enable()
    for _ in range(2):
        step(*args)
    recs = trace.records()
    roots = _check_roots(recs, "eval.step", 2)
    parents = _parents(recs)
    want = {"models.rpn": {"eval.step"}, "models.proposal": {"eval.step"},
            "ops.nms": {"models.proposal", "eval.postprocess"},
            "ops.roipool3d": {"eval.step"}, "models.rcnn": {"eval.step"},
            "eval.postprocess": {"eval.step"},
            **{n: {"models.rpn"} for n in SA + FP}}
    assert parents == {**want, "eval.step": {None}}
    # two zones a frame in the proposal layer, one batched final NMS
    nms = [r for r in recs if r.name == "ops.nms" and r.root == roots[0].id]
    assert [r.parent for r in nms] == ["models.proposal"] * 4 + ["eval.postprocess"]
    # every counted read of the run lies in some step, and a step's syncs
    # are its spans' own
    syncs = counts.read_syncs()
    assert syncs["nms.jacobi"][0] > 0 and syncs["proposal.zone2"][0] == 2
    assert sum(r.syncs for r in roots) == sum(n for n, _ in syncs.values())
    for root in roots:
        inner = [r for r in recs if r.root == root.id and r.parent == "eval.step"]
        assert sum(r.syncs for r in inner) <= root.syncs
        assert root.sync_wait_ns >= sum(r.sync_wait_ns for r in inner)


def test_rcnn_train_step_spans_nest():
    step, (state, batch) = train_entry(batch=2, device="cpu", seed=3,
                                       cfg=rcnn_config(RCNN_TINY), stage="rcnn")
    trace.enable()
    for _ in range(2):
        state, _ = step(state, batch)
    recs = trace.records()
    _check_roots(recs, "train.step", 2)
    parents = _parents(recs)
    want = {"train.step": {None}, "forward": {"train.step"}, "loss + labels": {"train.step"},
            "backward": {"train.step"}, "optimizer": {"train.step"},
            "models.rpn": {"forward"}, "models.proposal": {"forward"},
            "ops.nms": {"models.proposal"}, "targets": {"forward"},
            "ops.roipool3d": {"targets"}, "models.rcnn": {"forward"},
            **{n: {"models.rpn"} for n in SA + FP}}
    assert parents == want
    assert [r.name for r in recs if r.parent == "train.step"][:4] == [
        "forward", "loss + labels", "backward", "optimizer"]


def test_phases_are_trace_spans():
    assert train_state.phase is trace.span and point_rcnn.phase is trace.span


@pytest.mark.parametrize("chain,steps", [(1, 1), (2, 2), (3, 3), (5, 5), (0, 1)])
def test_greedy_suppress_counts_jacobi_steps(chain, steps):
    """A chain of ``chain`` boxes, each overlapping the next, among 6: the
    Jacobi iteration settles one link a step, so it tests ``chain`` times
    (once with no overlap at all), and keeps every other box of the chain."""
    K = 6
    over = torch.zeros((K, K), dtype=torch.bool)
    for i in range(chain - 1):
        over[i, i + 1] = over[i + 1, i] = True
    kept = greedy_suppress(over)
    want = [i >= chain or i % 2 == 0 for i in range(K)]
    assert kept.tolist() == want
    assert counts.read_syncs() == {"nms.jacobi": (steps, counts.read_syncs()["nms.jacobi"][1])}


def test_counts_read_keys_and_reset():
    before = counts.read()
    assert list(before) == list(counts.COUNTERS)
    assert all(isinstance(v, int) for v in before.values())
    with counts.sync("test.site", reads=2):
        pass
    with counts.sync("test.site"):
        pass
    n, wait = counts.read_syncs()["test.site"]
    assert n == 3 and wait >= 0
    total = counts.sync_totals()
    counts.reset()
    assert counts.read_syncs() == {} and counts.read() == dict.fromkeys(counts.COUNTERS, 0)
    assert counts.sync_totals() == total  # the spans' running total is never reset


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_outputs_identical_traced_and_untraced():
    step, args = _eval_step(seed=1)
    plain = step(*args)
    trace.enable()
    traced = step(*args)
    assert trace.records()
    _same(plain, traced)

    runs = []
    for on in (False, True):
        trace.disable()
        trace.reset()
        if on:
            trace.enable()
        step_fn, (state, batch) = train_entry(batch=2, device="cpu", seed=4,
                                              cfg=rcnn_config(RCNN_TINY), stage="rcnn")
        state, tb = step_fn(state, batch)
        assert bool(trace.records()) == on
        runs.append((tb, {k: v.detach().clone() for k, v in state.model.state_dict().items()}))
    _same(runs[0][0], runs[1][0])
    _same(runs[0][1], runs[1][1])


def test_nothing_recorded_while_disabled():
    step, args = _eval_step(seed=2)
    step(*args)
    assert trace.records() == [] and not trace.enabled()
    with trace.span("outside"):
        pass
    assert trace.records() == []
    trace.enable()
    with trace.span("inside"):
        pass
    trace.disable()
    step(*args)
    recs = trace.records()
    assert [r.name for r in recs] == ["inside"] and recs[0].root == recs[0].id
    trace.reset()
    assert trace.records() == []


def test_records_keep_their_order_and_sync_deltas():
    trace.enable()
    with trace.span("a"):
        with counts.sync("x"):
            pass
        with trace.span("b"):
            with counts.sync("x", reads=3):
                pass
    with trace.span("c"):
        pass
    recs = trace.records()
    assert [(r.name, r.parent, r.root, r.syncs) for r in recs] == [
        ("a", None, 0, 4), ("b", "a", 0, 3), ("c", None, 2, 0)]
    assert np.all([r.host_end_ns >= r.host_start_ns for r in recs])


def test_spans_are_profiler_ranges():
    """Under a profiler every span is a range of its name (tracing enabled
    or not); without one a span opens none."""
    from torch.profiler import ProfilerActivity, profile

    step, args = _eval_step(seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(*args)
    ranges = {e.key for e in prof.key_averages()}
    assert {"eval.step", "models.rpn", "pointnet2.SA1", "models.proposal", "ops.nms",
            "ops.roipool3d", "models.rcnn", "eval.postprocess"} <= ranges
    with trace.span("quiet") as s:
        assert s._rf is None
