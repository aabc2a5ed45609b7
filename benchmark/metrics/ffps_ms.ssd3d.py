"""Device ms a batch of the F-FPS kernel (K9, ``ops/cuda_fps.py``): CUDA
events of the program's ``ffps`` spans (one a launch: SA2's F-FPS half of
fusion sampling, SA3's F-FPS) in the batches traced before the window
(``harness/program_trace.py``), over their count."""

from benchmark.harness import program_trace


def install(d):
    program_trace.trace_steps(d)


def read(d):
    return program_trace.device_ms_per_step(d, "ssd3d.step", "ffps")
