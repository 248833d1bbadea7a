#!/usr/bin/env python3
"""The readings that the limits of a cell's correctness check are set
from (benchmark/workloads/<cell>.json, "limits"), at the cell's own size.

    python3 benchmark/calibrate.py --workload high.stage2 \
        --seeds 101 102 ... --faulted 3

For every seed: the port's checked steps against the reference's (sound
runs: the lower readings). For the first ``--faulted`` seeds also the
control, the reference with TF32 on (the nearest precision below the
configuration's float32), and the reference with half of each image loss
left out (the mean over the other half), each against the reference in
float32: the upper readings. One JSON line per seed on standard output.
The benchmark's own runs do not run this.
"""

import argparse
import gc
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def half_batch(trainer):
    """Plant the fault in the reference's trainer: each image loss over
    the top half of its rows only. Returns the undo."""
    orig = trainer.rgb_l1_ssim

    def rgb_l1_ssim(pred, gt, mask=None):
        h = pred.shape[1] // 2
        return orig(pred[:, :h], gt[:, :h],
                    None if mask is None else mask[:, :h])

    trainer.rgb_l1_ssim = rgb_l1_ssim
    return lambda: setattr(trainer, "rgb_l1_ssim", orig)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faulted", type=int, default=3)
    args = p.parse_args(argv)

    import torch
    from harness import check, gen, runner, sides, spec

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    ref_trainer = importlib.import_module("reference.train.trainer")
    cell = spec.load_cell(args.workload)
    cfg, traffic = cell.config, cell.traffic
    num = lambda cmp: {k: v for k, (v, _) in cmp.items()}
    for i, seed in enumerate(args.seeds):
        inputs = gen.make_inputs(cfg, traffic, seed, "cuda",
                                 sides.pwcnet_meta())
        prog = sides.build(sides.PORT, inputs, cfg, traffic, "cuda")
        prog_read = check.checked_steps(prog, inputs,
                                        traffic["checked_steps"])
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        ref = runner.reference_readings(inputs, cfg, traffic, "cuda")
        sound = check.compare(prog_read, ref)
        med = sorted(ref.grad.values())[len(ref.grad) // 2]
        line = {"seed": seed, "sound": num(sound),
                "sound_leaf": {k: d for k, (_, d) in sound.items()},
                "loss": prog_read.loss,
                "grad_gap": {n: abs(prog_read.grad[n] - ref.grad[n])
                             / max(ref.grad[n], med) for n in ref.grad},
                "ref_grad": ref.grad}
        if i < args.faulted:
            ctrl = runner.reference_readings(inputs, cfg, traffic, "cuda",
                                             tf32=True)
            line["control"] = num(check.compare(ctrl, ref))
            again = runner.reference_readings(inputs, cfg, traffic, "cuda")
            line["ref_again"] = num(check.compare(again, ref))
            undo = half_batch(ref_trainer)
            try:
                half = runner.reference_readings(inputs, cfg, traffic, "cuda")
            finally:
                undo()
            line["half_batch"] = num(check.compare(half, ref))
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
