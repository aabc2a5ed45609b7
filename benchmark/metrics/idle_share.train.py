"""The device's idle share of a step, in %: 1 - (the device's busy time a
step: the union of the device intervals in the profiler's trace of the
steps profiled after the window, over their count) / (the wall time a step
of the measured window).  The window's step time, not the profiled one,
is the base: under the profiler the host runs slower, which would
overstate the idle share; the device's work a step is the same."""


def install(d):
    pass


def read(d):
    t = d.trace
    if not t["busy_s"] or not d.attempted:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / t["steps"]) / (d.window_s / d.attempted))
