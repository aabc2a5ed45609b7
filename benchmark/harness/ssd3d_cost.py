"""3DSSD's analytic costs, from the config's widths: the step's matmul
operations (``mfu.eval``'s numerator in the 3DSSD cell, through the
driver's ``flops_per_step``) and K9's (F-FPS) least time (the
``ffps_roofline.ssd3d`` numerator).

Matmul operations count 2 M K N a layer, every layer of a grouped stack at
its B x S x K neighbourhood rows (layer 0 takes 3 + C inputs), the
aggregation, vote and head convs at their B x S rows.

K9's least time, a launch of B rows of n points of d values and ``npoint``
picks, is the largest of K1's three terms (``PERF.md``'s kernel table) with
the row width in them: the table's bytes (read once) and the indices'
over 3.35 TB/s; the operations, (npoint - 1) steps of n points of d
subtractions, d multiplications, d - 1 additions, a minimum and a compare,
over the f32 rate of ``roofline.PEAK_F32_PER_S`` (``--fmad=false``: no two
fuse); and the chain's latency, (npoint - 1) times K1's shortest dependent
step (``fps_step_probe``).
"""

from __future__ import annotations

from benchmark.harness import roofline


def _chain(rows: int, cin: int, widths) -> float:
    ops = 0.0
    for c in widths:
        ops += 2.0 * rows * cin * c
        cin = c
    return ops


def step_flops(cfg, batch: int) -> float:
    """Matmul operations of one eval step of ``batch`` frames."""
    bb = cfg.BACKBONE
    cin = 1 if cfg.USE_INTENSITY else 0
    ops = 0.0
    for k in range(len(bb.MLPS)):
        S = sum((2 if m == "FS" else 1) * n for m, n in zip(bb.FPS_MODS[k], bb.NPOINTS[k]))
        for ns, mlp in zip(bb.NSAMPLE[k], bb.MLPS[k]):
            ops += _chain(batch * S * ns, 3 + cin, mlp)
        ops += _chain(batch * S, sum(m[-1] for m in bb.MLPS[k]), [bb.AGGREGATION[k]])
        cin = bb.AGGREGATION[k]
    nv = cfg.VOTE.NUM_POINTS
    ops += _chain(batch * nv, cin, list(cfg.VOTE.CONV) + [3])
    agg = cfg.VOTE_AGGREGATION
    for ns, mlp in zip(agg.NSAMPLE, agg.MLPS):
        ops += _chain(batch * nv * ns, 3 + cin, mlp)
    head = cfg.HEAD
    width = sum(m[-1] for m in agg.MLPS)
    ops += _chain(batch * nv, width, head.SHARED)
    ops += _chain(batch * nv, head.SHARED[-1], list(head.CLS) + [1])
    ops += _chain(batch * nv, head.SHARED[-1], list(head.REG) + [6 + 2 * head.NUM_DIR_BINS])
    return ops


def ffps_launches(cfg, batch: int) -> list[tuple[int, int, int, int]]:
    """The K9 launches of one step, in order: (rows, n, d, npoint)."""
    bb = cfg.BACKBONE
    n_rows = cfg.NUM_POINTS
    out = []
    for k in range(len(bb.MLPS)):
        d = 3 + (bb.AGGREGATION[k - 1] if k else (1 if cfg.USE_INTENSITY else 0))
        start, S = 0, 0
        for m, npoint, end in zip(bb.FPS_MODS[k], bb.NPOINTS[k], bb.FPS_RANGES[k]):
            end = n_rows if end == -1 else end
            if m in ("F-FPS", "FS"):
                out.append((batch, end - start, d, npoint))
            S += 2 * npoint if m == "FS" else npoint
            start = end
        n_rows = S
    return out


def ffps_bound_s(rows: int, n: int, d: int, npoint: int, t_step_s: float) -> float:
    """K9's least time for one launch (seconds)."""
    n_bytes = 4.0 * rows * (n * d + npoint)
    ops = float(rows) * (npoint - 1) * n * (3 * d + 1)
    return roofline.bound_s(n_bytes, ops, roofline.PEAK_F32_PER_S,
                            (npoint - 1) * t_step_s)[0]
