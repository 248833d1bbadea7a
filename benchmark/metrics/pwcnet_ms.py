"""pwcnet_ms: device time per step of the kernels launched inside the
port's span ``d4.flow.pwcnet`` (PWC-Net's forward on the 2 (S - 1)
sub-frame pairs, under no_grad; models/pwcnet.py): the union of their
intervals, user annotations left out, with the device-only pass's times
charged to spans as the spans pass charges its kernels
(harness/spans.py). None where the trace carries no spans or the port
records none."""


def read(ctx):
    s = (getattr(ctx.trace, "spans", None) or {}).get("d4.flow.pwcnet")
    return s["ms"] if s and s["ms"] > 0 else None
