"""The readers of the per-layer metrics that read the program's own spans
and host-sync counts (``harness/program_trace.py``), on a fake run: they
trace steps of their own once, at install, and leave the trace off for the
window; they take those steps' roots only, divide by their count, and give
None when nothing was recorded or the program has no tracing."""

import types

import pytest

from benchmark.harness import program_trace, spec
from pointrcnn_tpu_torch import trace

MS = 1_000_000  # ns


def rec(name, id, parent=None, root=None, syncs=0, wait_ms=0.0, dev_ms=None):
    r = trace.Record(name, id, parent.name if parent else None, parent.id if parent else None,
                     root, host_start_ns=id, host_end_ns=id + 1, syncs=syncs,
                     sync_wait_ns=int(wait_ms * MS))
    if dev_ms is not None:
        r.device_start_ns, r.device_end_ns = 10 * MS * id, 10 * MS * id + int(dev_ms * MS)
    return r


def step(root_name, first_id, syncs, wait_ms, nms_ms, other_nms_ms, proposal_ms):
    """One step's records: a root, the proposal layer with two NMS calls,
    and the post-process with one."""
    root = rec(root_name, first_id, syncs=syncs, wait_ms=wait_ms, dev_ms=100)
    prop = rec("models.proposal", first_id + 1, root, first_id, dev_ms=proposal_ms)
    post = rec("eval.postprocess", first_id + 4, root, first_id, dev_ms=5)
    return [root, prop,
            rec("ops.nms", first_id + 2, prop, first_id, dev_ms=nms_ms / 2),
            rec("ops.nms", first_id + 3, prop, first_id, dev_ms=nms_ms / 2),
            post, rec("ops.nms", first_id + 5, post, first_id, dev_ms=other_nms_ms)]


class Run:
    """A fake run whose ``extra`` steps record ``records``, with the
    benchmark's own spans (``spans``)."""

    def __init__(self, records, monkeypatch):
        self.calls = []
        self.spans = types.SimpleNamespace(cleared=0)
        self.spans.clear = lambda: setattr(self.spans, "cleared", self.spans.cleared + 1)
        monkeypatch.setattr(trace, "records", lambda: records)

    def extra(self, steps):
        self.calls.append((steps, trace.enabled()))


def installed(readers, d):
    for r in readers.values():
        r.install(d)
    return d


@pytest.fixture
def readers():
    names = ["host_syncs.eval", "sync_wait_ms.eval", "nms_ms.eval", "host_syncs.rcnn",
             "sync_wait_ms.rcnn", "proposal_ms.rcnn"]
    return {n: spec.load_reader(n) for n in names}


def test_traced_roots_only_and_divisors(readers, monkeypatch):
    """Two traced steps and a span outside any step: the steps count, over
    two; the proposal layer's NMS, not the post-process's."""
    recs = (step("eval.step", 0, 400, 8.0, 10.0, 3.0, 12.0)
            + step("eval.step", 10, 600, 12.0, 6.0, 3.0, 9.0)
            + [rec("elsewhere", 20, syncs=1000, wait_ms=50.0, dev_ms=50)])
    d = installed(readers, Run(recs, monkeypatch))
    assert readers["host_syncs.eval"].read(d) == pytest.approx(500)
    assert readers["sync_wait_ms.eval"].read(d) == pytest.approx(10.0)
    assert readers["nms_ms.eval"].read(d) == pytest.approx(8.0)
    # the eval readers take eval.step roots, the rcnn ones train.step roots
    assert readers["host_syncs.rcnn"].read(d) is None

    recs = (step("train.step", 0, 300, 3.0, 10.0, 0.0, 20.0)
            + step("train.step", 10, 500, 5.0, 10.0, 0.0, 30.0)
            + step("train.step", 30, 7000, 70.0, 10.0, 0.0, 700.0))
    d = installed(readers, Run(recs, monkeypatch))
    assert readers["host_syncs.rcnn"].read(d) == pytest.approx(2600)
    assert readers["sync_wait_ms.rcnn"].read(d) == pytest.approx(26.0)
    assert readers["proposal_ms.rcnn"].read(d) == pytest.approx(250.0)


def test_none_when_nothing_recorded(readers, monkeypatch):
    # no records at all
    d = installed(readers, Run([], monkeypatch))
    assert all(r.read(d) is None for r in readers.values())
    # spans without device times (a run on the CPU)
    recs = [rec("train.step", 0, syncs=4), rec("models.proposal", 1, root=0)]
    recs[1].parent, recs[1].parent_id = "train.step", 0
    d = installed(readers, Run(recs, monkeypatch))
    assert readers["host_syncs.rcnn"].read(d) == 4
    assert readers["proposal_ms.rcnn"].read(d) is None


def test_program_without_tracing(readers, monkeypatch):
    """A program without ``pointrcnn_tpu_torch.trace`` (the parent of the
    change that added it): install and read raise nothing, read gives None
    and runs no step."""
    monkeypatch.setattr(program_trace, "trace", None)
    d = Run([], monkeypatch)
    for r in readers.values():
        r.install(d)
        assert r.read(d) is None
    assert d.calls == []


def test_readers_trace_steps_of_their_own(readers, monkeypatch):
    """The first install traces ``STEPS`` steps, once for every reader,
    turns the trace off for the window and the profiled steps, and drops
    what the benchmark's spans recorded in those steps."""
    trace.disable()
    trace.reset()
    d = installed(readers, Run(step("eval.step", 0, 1, 1.0, 1.0, 1.0, 1.0), monkeypatch))
    assert d.calls == [(program_trace.STEPS, True)]
    assert d.spans.cleared == 1
    assert not trace.enabled()
    assert readers["host_syncs.eval"].read(d) == 1
