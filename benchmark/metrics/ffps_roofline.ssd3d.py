"""K9 (F-FPS) against its roofline, in %: over the ``ffps`` launches of the
batches traced before the window (``harness/program_trace.py``), the sum
of each launch's least time over the sum of its span's device interval.

A launch's least time (``harness/ssd3d_cost.py::ffps_bound_s``) is the
largest of its table's bytes over 3.35 TB/s, its operations over the f32
rate, and (npoint - 1) times K1's shortest dependent FPS step, which the
program's probe (``cuda_fps.step_probe_ms``) times on the card as the
difference of two chain lengths over their difference, as
``chip_smoke.py`` takes it.  The launches of a step follow the config's
sampler specs in order (``ssd3d_cost.ffps_launches``)."""

from benchmark.harness import program_trace, ssd3d_cost

PROBE_STEPS = (2048, 18432)


def install(d):
    program_trace.trace_steps(d)


def _t_step_s() -> float:
    from pointrcnn_tpu_torch.ops import cuda_fps

    lo, hi = (cuda_fps.step_probe_ms(n) for n in PROBE_STEPS)
    return (hi - lo) / (PROBE_STEPS[1] - PROBE_STEPS[0]) * 1e-3


def read(d):
    t = program_trace.traced(d, "ssd3d.step")
    if t is None:
        return None
    roots, recs = t
    shapes = ssd3d_cost.ffps_launches(d.cfg, d.batch)
    spans = [r for r in recs if r.name == "ffps"]
    if len(spans) != len(roots) * len(shapes) or any(r.device_start_ns is None for r in spans):
        return None
    t_step = _t_step_s()
    bound = len(roots) * sum(ssd3d_cost.ffps_bound_s(*s, t_step) for s in shapes)
    span_s = sum(r.device_end_ns - r.device_start_ns for r in spans) * 1e-9
    return 100.0 * bound / span_s
