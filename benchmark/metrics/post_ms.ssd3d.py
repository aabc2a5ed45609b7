"""ms a batch of 3DSSD's test-time step after the head: the box decode
(``ssd3d.decode``) and the axis-aligned BEV NMS (``ops.nms``, each Jacobi
step's stop test a host sync), CUDA events of the program's spans under
the ``ssd3d.step`` root in the batches traced before the window
(``harness/program_trace.py``), over their count."""

from benchmark.harness import program_trace


def install(d):
    program_trace.trace_steps(d)


def read(d):
    parts = [program_trace.device_ms_per_step(d, "ssd3d.step", "ssd3d.decode"),
             program_trace.device_ms_per_step(d, "ssd3d.step", "ops.nms", "ssd3d.step")]
    return None if any(p is None for p in parts) else sum(parts)
