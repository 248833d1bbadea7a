"""device_idle: the share of the traced window (host wall time of the
traced steps, synchronized) in which no operation runs on the device:
one less the union of the kernels' intervals over the window, in
percent."""

from harness.trace import busy_us


def read(ctx):
    if not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - busy_us(ctx.trace.kernels) * 1e-6
                    / ctx.trace.wall_s)
