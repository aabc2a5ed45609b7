"""The port's spans: a named range around the work of each layer, from a
step down to each hand-written kernel's launch.

``with span(name):`` opens a ``torch.profiler.record_function`` range
whenever a profiler is collecting, so every profiler trace names what the
host was doing; with none, the span reads one flag (an open range costs
the host 7-12 us even when nothing collects it, about 40 spans a step).
After :func:`enable`, each span also keeps a record in
memory (:class:`Record`): its name, its parent span, the root of its step
(a span opened with no other open is a root: one a step), its host start
and end (``time.perf_counter_ns``), a pair of CUDA events on the card's
current stream when tracing a card, and the host syncs
(:mod:`pointrcnn_tpu_torch.ops.counts`) it covered.

:func:`enable` synchronises the card and records an anchor event beside a
host timestamp; :func:`records` reads every event once, after a
synchronise and a second such anchor, and maps its device time onto the
host clock linearly between the two anchors (the card's event timer and
the host's clock may run at rates a part in a thousand apart), so both
intervals of a span share one timebase.  Nothing is written to disk.

The names follow the layer map: ``eval.step`` and ``train.step`` (roots),
``models.rpn`` with ``pointnet2.SA1``... and ``pointnet2.FP1``...,
``models.proposal``, ``ops.nms``, ``ops.roipool3d``, ``models.rcnn``,
``eval.postprocess``, the train step's phases (``train.state.phase``,
``models.point_rcnn.phase``), 3DSSD's eval step (``ssd3d.step``, a root,
with ``ssd3d.SA1``..., ``ssd3d.vote``, ``ssd3d.vote_aggregation``,
``ssd3d.head``, ``ssd3d.decode``), ``ops.ball_query_<method>`` around each
SA-MSG stage's ball query (``ops.ball_query_exact`` in 3DSSD), and each
kernel's launch under its counter's name (``ops.counts.COUNTERS``, opened by
``_build.launch`` around the C call).
"""

from __future__ import annotations

import time

import torch
from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

from pointrcnn_tpu_torch.ops import counts

_on = False
_device: torch.device | None = None
_anchor: tuple | None = None  # (event, host ns) of the last anchor
_open: list = []    # the open records, outermost first
_records: list = []  # every record since the last reset, in start order
_resolved = 0  # records before this index have their device times


class Record:
    """One span: ``name``; ``id`` (its position since the last reset);
    ``parent`` and ``parent_id`` (the span around it, or None); ``root``
    (the id of its step's root); host start and end in ns; device start
    and end in ns on the host clock (None without a card); ``syncs`` and
    ``sync_wait_ns``, the host syncs it covered and the host's wait at
    them."""

    __slots__ = ("name", "id", "parent", "parent_id", "root", "host_start_ns",
                 "host_end_ns", "device_start_ns", "device_end_ns", "syncs", "sync_wait_ns",
                 "_events", "_sync0")

    def __init__(self, name, id, parent=None, parent_id=None, root=None, host_start_ns=0,
                 host_end_ns=None, device_start_ns=None, device_end_ns=None, syncs=0,
                 sync_wait_ns=0):
        self.name, self.id, self.parent, self.parent_id = name, id, parent, parent_id
        self.root = id if root is None else root
        self.host_start_ns, self.host_end_ns = host_start_ns, host_end_ns
        self.device_start_ns, self.device_end_ns = device_start_ns, device_end_ns
        self.syncs, self.sync_wait_ns = syncs, sync_wait_ns
        self._events = self._sync0 = None

    def device_ms(self) -> float | None:
        if self.device_start_ns is None:
            return None
        return (self.device_end_ns - self.device_start_ns) / 1e6

    def __repr__(self):
        return (f"Record({self.name!r}, id={self.id}, parent={self.parent!r}, "
                f"root={self.root}, syncs={self.syncs})")


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(_device))
    return ev


def _begin(name: str) -> Record:
    parent = _open[-1] if _open else None
    rec = Record(name, len(_records), parent.name if parent else None,
                 parent.id if parent else None, parent.root if parent else None)
    rec._sync0 = counts.sync_totals()
    _records.append(rec)
    _open.append(rec)
    # the host interval holds the events: a device start never precedes it
    rec.host_start_ns = time.perf_counter_ns()
    if _device is not None:
        rec._events = (_event(), None)
    return rec


def _end(rec: Record) -> None:
    if rec._events is not None:
        rec._events = (rec._events[0], _event())
    rec.host_end_ns = time.perf_counter_ns()
    n, wait = counts.sync_totals()
    rec.syncs, rec.sync_wait_ns = n - rec._sync0[0], wait - rec._sync0[1]
    if _open and _open[-1] is rec:
        _open.pop()
    elif rec in _open:
        _open.remove(rec)


class span:
    """A profiler range ``name`` around the body, and, while tracing is
    enabled, a :class:`Record` of it."""

    __slots__ = ("name", "_rf", "_rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiler_enabled():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self._rec = _begin(self.name) if _on else None
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            _end(self._rec)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def enable() -> None:
    """Start keeping records (a no-op while enabled), with device times on
    the current CUDA device's current stream when there is a card."""
    global _on, _device, _anchor
    if _on:
        return
    _device = (torch.device("cuda", torch.cuda.current_device())
               if torch.cuda.is_available() else None)
    _anchor = _take_anchor() if _device is not None else None
    _on = True


def _take_anchor() -> tuple:
    """(an event, the host ns beside it) on an idle card."""
    torch.cuda.synchronize(_device)
    ev = _event()
    ns = time.perf_counter_ns()
    ev.synchronize()
    return ev, ns


def disable() -> None:
    """Stop keeping records; those kept stay until :func:`reset`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Drop every record (spans still open finish without one)."""
    global _resolved
    _records.clear()
    _open.clear()
    _resolved = 0


def records() -> list:
    """The finished records since the last reset, in start order, with
    their device times (read once, after a synchronise)."""
    global _resolved, _anchor
    done = [r for r in _records if r.host_end_ns is not None]
    pending = [r for r in _records[_resolved:] if r._events is not None
               and r._events[1] is not None]
    if pending:
        (ev0, ns0), (ev1, ns1) = _anchor, _take_anchor()
        # host ns per device ms between the two anchors
        scale = (ns1 - ns0) / ev0.elapsed_time(ev1)
        for r in pending:
            a, b = r._events
            r.device_start_ns = ns0 + round(ev0.elapsed_time(a) * scale)
            r.device_end_ns = ns0 + round(ev0.elapsed_time(b) * scale)
            r._events = None
        _anchor = (ev1, ns1)
    while _resolved < len(_records) and _records[_resolved].host_end_ns is not None:
        _resolved += 1
    return done
