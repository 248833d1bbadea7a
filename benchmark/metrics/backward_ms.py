"""backward_ms: device time per step of the kernels launched inside the
port's span ``d4.step.backward`` (loss.backward(): the compositors'
backward, the gathers' scatter-adds, the losses' backward), those the
autograd engine's thread launches included, with the device-only pass's
times charged to spans as the spans pass charges its kernels
(harness/spans.py). None where the trace carries no spans or the port
records none."""


def read(ctx):
    s = (getattr(ctx.trace, "spans", None) or {}).get("d4.step.backward")
    return s["ms"] if s and s["ms"] > 0 else None
