# Frozen copy of chip_smoke.py's PEAK_* constants and bound(): the H100's
# published peaks and the least time of a call from its bytes and operations.
"""The H100 SXM's published peaks at 700 W (dense) and the roofline bound.

The f32 rate is one operation a lane a clock (132 SMs x 128 lanes x 1.98
GHz), half the published 67 TFLOP/s, which counts an FMA as two: the
port's kernels are built with ``--fmad=false``, so no two counted
operations fuse.  A share of a peak is stated beside the card's power limit
(``nvidia-smi``): a card set below 700 W runs slower under load.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 33.5e12
PEAK_BF16_PER_S = 989e12


def bound_s(n_bytes: float, ops: float, peak_ops_per_s: float = PEAK_BF16_PER_S,
            latency_s: float = 0.0) -> tuple[float, str]:
    """(bound seconds, the term that sets it): the largest of bytes over the
    memory rate, operations over the peak rate of their type and, for a
    chain of dependent steps, the chain's latency."""
    terms = {"bytes": n_bytes / PEAK_BYTES_PER_S, "operations": ops / peak_ops_per_s,
             "latency": latency_s}
    term = max(terms, key=terms.get)
    return terms[term], term
