"""flow_ms: device time per step of the kernels launched inside the
benchmark's span around the flow_fn that it hands to make_train_step
(PWC-Net on the 2 (S - 1) sub-frame pairs and the warp's forward), from
the profiler's trace of one step with the host's ops."""

from harness.trace import FLOW_SPAN


def read(ctx):
    us = ctx.trace.span_us.get(FLOW_SPAN, 0.0)
    return us / 1e3 if us > 0 else None
