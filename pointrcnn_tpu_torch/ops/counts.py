"""The launch counts of the hand-written kernels, by kernel name: each
kernel's wrapper adds one to its module's counter where it launches the
kernel, and nowhere else.  Beside them ``bn_train_plain``: the training
batch-norm layers on the card that ran on the plain versions, the kernels
refusing them (``ops/cuda_bn.py``).  ``chip_smoke.py`` and the data-parallel runs on
the card (``entry.dryrun_multichip``, ``tools.dp_step``) read them.

Beside them, the host syncs by site: :class:`sync` goes around each read
that makes the host wait for the card (a value read back, a copy from
pageable host memory), counts it and adds the host's wait there.  Always
on: an int add and two clock reads, next to a sync's tens of us."""

from __future__ import annotations

import importlib
import time

# kernel -> (module under pointrcnn_tpu_torch.ops, counter)
COUNTERS = {
    "fps": ("cuda_fps", "launches"),
    "three_nn": ("cuda_knn", "launches"),
    "group_gather": ("cuda_gather", "launches"),
    "fused_group_mlp_max": ("cuda_mlp", "launches"),
    "ball_query": ("cuda_ballquery", "launches"),
    "ball_query_banded": ("cuda_ballquery", "banded_launches"),
    "gather_backward": ("cuda_gather", "bwd_launches"),
    "fused_group_mlp_backward": ("cuda_mlp", "bwd_launches"),
    "bn_train_stats": ("cuda_bn", "stats_launches"),
    "bn_train_apply": ("cuda_bn", "apply_launches"),
    "bn_train_bwd_sums": ("cuda_bn", "bwd_sums_launches"),
    "bn_train_bwd_apply": ("cuda_bn", "bwd_apply_launches"),
    "bn_train_plain": ("cuda_bn", "plain_layers"),
}


def _module(name: str):
    return importlib.import_module(f"pointrcnn_tpu_torch.ops.{name}")


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


def reset() -> None:
    """Zero every launch counter and the host syncs."""
    for mod, attr in COUNTERS.values():
        setattr(_module(mod), attr, 0)
    _syncs.clear()


def read() -> dict:
    """Launches by kernel name."""
    return {name: getattr(_module(mod), attr) for name, (mod, attr) in COUNTERS.items()}


def read_syncs() -> dict:
    """{site: (reads, host wait ns)} since the last reset."""
    return {site: (n, wait) for site, (n, wait) in _syncs.items()}


def sync_totals() -> tuple:
    """(reads, host wait ns) over every site since import."""
    return _total[0], _total[1]
