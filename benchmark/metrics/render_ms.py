"""render_ms: device time per step of the kernels launched inside the
port's span ``d4.render`` (models/scene.py::render, forward: deformation,
projection, binning, packing, the compositors' forward), summed over the
step's renders, with the device-only pass's times charged to spans as the
spans pass charges its kernels (harness/spans.py). None where the trace
carries no spans or the port records none."""


def read(ctx):
    s = (getattr(ctx.trace, "spans", None) or {}).get("d4.render")
    return s["ms"] if s and s["ms"] > 0 else None
