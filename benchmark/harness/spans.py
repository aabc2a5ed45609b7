"""Device spans around the program's layers, from the benchmark's side.

A span is a pair of CUDA events recorded before and after a call, inside a
``record_function`` range of the same name (so a profiler trace names what
the host was doing): around a module's forward by hooks, around a module
function by wrapping it where the caller looks it up, or around a phase by
handing the program a context (``train.state.phase``,
``models.point_rcnn.phase``).  The mechanism is a copy of
``pointrcnn_tpu_torch/profile_forward.py::_Spans``.  Events are read once,
after the window: recording one costs the host a few microseconds and adds
no synchronisation.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
from torch.profiler import record_function


class Spans:
    def __init__(self):
        self.events = defaultdict(list)
        self._open = []
        self._undo = []
        # per-call records a reader attaches to its spans: name -> [(start, end, info)]
        self.calls = defaultdict(list)

    def enter(self, name):
        rf = record_function(name)
        rf.__enter__()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        self._open.append((name, rf, start))
        return start

    def exit(self):
        name, rf, start = self._open.pop()
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        rf.__exit__(None, None, None)
        self.events[name].append((start, end))
        return start, end

    @contextlib.contextmanager
    def span(self, name):
        self.enter(name)
        try:
            yield
        finally:
            self.exit()

    def hook_module(self, name: str, module: torch.nn.Module) -> None:
        """A span ``name`` around every forward of ``module``."""
        def pre(m, a):
            self.enter(name)

        def post(m, a, o):
            self.exit()

        h1 = module.register_forward_pre_hook(pre)
        h2 = module.register_forward_hook(post)
        self._undo += [h1.remove, h2.remove]

    def wrap(self, owner, attr: str, name: str) -> None:
        """A span ``name`` around every call of ``owner.attr`` made through
        ``owner`` (a module whose global the caller looks up at call time)."""
        orig = getattr(owner, attr)

        def wrapped(*a, **kw):
            with self.span(name):
                return orig(*a, **kw)

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, orig))

    def set_phase(self, owner, attr: str = "phase") -> None:
        """Hand ``owner.attr`` (a context factory taking a name) this span."""
        orig = getattr(owner, attr)
        setattr(owner, attr, self.span)
        self._undo.append(lambda: setattr(owner, attr, orig))

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()

    def clear(self) -> None:
        self.events.clear()
        self.calls.clear()

    def total_ms(self, name: str) -> float | None:
        """Sum of the spans ``name`` in ms (after a synchronise), None if
        none was recorded."""
        ev = self.events.get(name)
        if not ev:
            return None
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev)
