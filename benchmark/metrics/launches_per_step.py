"""launches_per_step: operations on the device per train step in the
traced window (the port's kernels and the libraries' kernels, copies and
fills alike), from the profiler's device trace. Moves step_ms: each launch
costs the host its launch time, and the step is paced by them where the
device waits."""


def read(ctx):
    if not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.trace.steps
