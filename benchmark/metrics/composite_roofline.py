"""composite_roofline: the least time of the step's compositor calls
(per call and direction, the larger of bytes / HBM bandwidth and
operations / float32 peak; harness/work.py counts them from the
reference's binning of the traced steps' inputs) as a share of the device
time of the compositor kernels per traced step, in percent."""

KERNELS = ("window_fwd_kernel", "window_bwd_kernel", "dense_fwd_kernel",
           "dense_bwd_kernel")


def read(ctx):
    us = sum(k.us for k in ctx.trace.kernels
             if any(name in k.name for name in KERNELS))
    if us <= 0 or not ctx.work:
        return None
    device_s = us * 1e-6 / ctx.trace.steps
    least_s = sum(w.composite_least_s(ctx.bandwidth, ctx.peak_flops)
                  for w in ctx.work) / len(ctx.work)
    return 100.0 * least_s / device_s
