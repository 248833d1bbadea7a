"""host_syncs_per_step: blocking runtime calls per step made inside the
port's span ``d4.step`` (cudaStreamSynchronize, cudaDeviceSynchronize,
cudaEventSynchronize and non-async cudaMemcpy: a host value copied to the
card, or a device value read on the host, waits for the card and drains
the launch queue), from the spans pass (harness/spans.py). A count, so 0
is a reading; None where the trace carries no spans or the port records
none."""


def read(ctx):
    s = (getattr(ctx.trace, "spans", None) or {}).get("d4.step")
    return s["syncs"] if s else None
