"""step_mfu: the operations the train step needs (harness/work.py:
compositing forward and backward, deformation and projection, the losses,
PWC-Net and its warp, Adam; recomputation not counted) per traced step
time, as a share of the card's float32 peak, in percent."""


def read(ctx):
    if not ctx.work or ctx.trace.wall_s <= 0:
        return None
    ops = sum(w.total_ops() for w in ctx.work) / len(ctx.work)
    step_s = ctx.trace.wall_s / ctx.trace.steps
    return 100.0 * ops / (step_s * ctx.peak_flops)
