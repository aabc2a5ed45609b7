"""The launch counts of the hand-written kernels, by kernel name: each
launch through ``_build.launch`` adds one under its kernel's name.  Beside them two route counts: ``bn_train_plain``, the training
batch-norm layers on the card that ran on the plain versions, the kernels
refusing them (``ops/cuda_bn.py``), and ``generic_grouped_train``, the
training forwards of BN-free grouped stacks that missed the fused route
(``models/layers.py``).  ``chip_smoke.py``, the benchmark, the tools and the
data-parallel runs on the card (``entry.dryrun_multichip``,
``tools.dp_step``) read them.

Beside them, the host syncs by site: :class:`sync` goes around each read
that makes the host wait for the card (a value read back, a copy from
pageable host memory), counts it and adds the host's wait there.  Always
on: an int add and two clock reads, next to a sync's tens of us."""

from __future__ import annotations

import time

# read() gives the counts in this order
COUNTERS = ("fps", "ffps", "three_nn", "group_gather", "fused_group_mlp_max", "ball_query",
            "ball_query_banded", "ball_query_first_k", "gather_backward",
            "fused_group_mlp_backward", "bn_train_stats", "bn_train_apply", "bn_train_bwd_sums",
            "bn_train_bwd_apply", "bn_train_plain", "generic_grouped_train")

_counts = dict.fromkeys(COUNTERS, 0)

# site -> [reads, host wait ns] since the last reset
_syncs: dict[str, list] = {}
# every site's reads and wait since import, never reset (spans take deltas)
_total = [0, 0]


class sync:
    """Context around ``reads`` blocking reads at ``site``: counts them and
    adds the host's wait inside to the site."""

    __slots__ = ("site", "reads", "_t0")

    def __init__(self, site: str, reads: int = 1):
        self.site, self.reads = site, reads

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        wait = time.perf_counter_ns() - self._t0
        rec = _syncs.get(self.site)
        if rec is None:
            rec = _syncs[self.site] = [0, 0]
        rec[0] += self.reads
        rec[1] += wait
        _total[0] += self.reads
        _total[1] += wait
        return False


def add(name: str) -> None:
    """One more under ``name`` (one of :data:`COUNTERS`)."""
    _counts[name] += 1


def reset() -> None:
    """Zero every count and the host syncs."""
    for name in COUNTERS:
        _counts[name] = 0
    _syncs.clear()


def read() -> dict:
    """The counts by name, in :data:`COUNTERS`' order."""
    return dict(_counts)


def read_syncs() -> dict:
    """{site: (reads, host wait ns)} since the last reset."""
    return {site: (n, wait) for site, (n, wait) in _syncs.items()}


def sync_totals() -> tuple:
    """(reads, host wait ns) over every site since import."""
    return _total[0], _total[1]
