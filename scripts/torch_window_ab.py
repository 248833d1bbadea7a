"""A/B timing of the port's window compositor kernels on one CUDA card.

    python3 scripts/torch_window_ab.py [--baseline DIR]
                                       [--variants nosum nowalk strict]

Builds, with ops/cuda_build.py, the kernel library of this checkout, of a
baseline checkout DIR (for example a parent commit unpacked with
`git archive <commit>`) and of this checkout's sources built with one of the
ablations of csrc/composite_common.cuh (-DD4GS_ABLATE=<n>), each into its
own directory under build/window_ab/. It drives one bench-shape stage-2
train step (chip_smoke.py's) with this checkout's kernels, records its 16
window calls, and times every library on them with CUDA events, forward and
backward, all calls and by channel count (nchan 5: the three static
windows; 11: the dynamic one), in the order built and again in reverse.
The checkout and the baseline are held against the plain twins on the first
64 rows of each call and on chip_smoke.py's edge buckets, at its bars; the
`strict` ablation (an inexact cull) must fail the edge buckets. Last, every
library is timed on the 12 split (K4) calls of one 64x48 stage-2 step.
Prints the card's name and power limit first. Needs one card and nvcc;
imports no JAX.
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from deblur4dgs_tpu_torch.ops import cuda_build  # noqa: E402
from deblur4dgs_tpu_torch.ops import rasterize as tr  # noqa: E402

OUT_DIR = ROOT / "build" / "window_ab"
ABLATIONS = {"nosum": 1, "nowalk": 2, "strict": 3}  # D4GS_ABLATE values
EXACT = ("checkout", "baseline")


def build_all(baseline, variants):
    """{name: library}: the checkout's own build, the baseline's and the
    ablations', all builds started together."""
    jobs = {}
    if baseline:
        jobs["baseline"] = dict(
            csrc_dir=Path(baseline) / "deblur4dgs_tpu_torch" / "csrc",
            build_dir=OUT_DIR / "baseline")
    for v in variants:
        jobs[v] = dict(build_dir=OUT_DIR / v,
                       defines=(f"D4GS_ABLATE={ABLATIONS[v]}",))
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        main = pool.submit(cuda_build.load)
        paths = {n: pool.submit(cuda_build.build, **kw)
                 for n, kw in jobs.items()}
        libs = {"checkout": main.result()}
        libs.update({n: cuda_build.open_library(p.result())
                     for n, p in paths.items()})
    return libs


def record(kind, drive):
    """The calls of ``kind`` that ``drive()`` makes."""
    with cs.recording(tr, kind) as rec:
        drive()
        torch.cuda.synchronize()
    return rec


def record_stage2():
    """The 16 window calls of one bench-shape stage-2 step (after one
    warm-up step)."""
    state, drive = cs.bench_state(cs.DEV, "stage2")
    state, _, _ = drive(state)
    rec = record("window", lambda: drive(state))
    del state
    torch.cuda.empty_cache()
    return rec


def record_split():
    """The split (K4) calls of one 64x48 stage-2 step."""
    from deblur4dgs_tpu_torch import configs as C
    from deblur4dgs_tpu_torch.convert import scene_from_numpy
    from deblur4dgs_tpu_torch.train import trainer as TT

    arrays, inputs = cs.small_inputs((64, 48), "stage2")
    kinds = (TT.FrameBatch, TT.FrameBatch, TT.TrackBatch, TT.FrameBatch,
             None)
    state, step = cs.make_step("stage2", scene_from_numpy(arrays, device=cs.DEV),
                               8, C.RenderConfig(num_exposure=3, tile_cap=256))
    conv = lambda x: torch.as_tensor(x, device=cs.DEV)
    args = [None if x is None else (conv(x) if k is None else k(*map(conv, x)))
            for k, x in zip(kinds, inputs)]
    return record("split", lambda: step(state, cs.EPOCH, *args))


def edge_errors():
    """Max relative errors (fwd, bwd) of the current library's window
    kernels against the twins on edge buckets, nchan 11 and 5."""
    worst = [0.0, 0.0]
    for nchan in (11, 5):
        for i, cap in enumerate((128, 512, 1024)):
            seed = 100 + 10 * nchan + i
            fa = cs.edge_bucket(seed, 48, cs.NUM_EXPOSURE, nchan, cap, 80,
                                3600, cs.DEV) + (80, nchan, True)
            worst[0] = max(worst[0], cs.compare_fwd(tr, "window", fa)[1])
            worst[1] = max(worst[1], cs.compare_bwd(
                tr, "window", cs.bwd_args_for(tr, "window", fa, seed))[1])
    return worst


def time_calls(kind, rec, reps):
    """(fwd ms, bwd ms) of the current library over all recorded calls."""
    k_fwd, _, k_bwd, _ = tr._COMPOSITORS[kind]
    return (cs.cuda_ms(lambda: [k_fwd(*a) for a in rec["fwd"]], reps),
            cs.cuda_ms(lambda: [k_bwd(*a) for a in rec["bwd"]], reps))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="a checkout to compare with")
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=sorted(ABLATIONS))
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_window_ab: no CUDA device visible")
    print(f"# card: {cs.nvidia_smi_line()}")
    libs = build_all(a.baseline, a.variants)
    main_lib = libs["checkout"]
    rec = record_stage2()
    errs = cs.Errs()
    cut = lambda x: tuple(t[:64] if torch.is_tensor(t) else t for t in x)
    for name, lib in libs.items():
        cuda_build.use(lib)
        fwd_rel, bwd_rel = edge_errors()
        print(f"# {name}: edge buckets max rel err fwd {fwd_rel:.3e}, bwd "
              f"{bwd_rel:.3e} (bars {cs.FWD_TOL}, {cs.BWD_TOL})")
        if name == "strict":
            cs.check(fwd_rel > cs.FWD_TOL or bwd_rel > cs.BWD_TOL,
                     "the edge buckets did not catch the inexact cull")
        if name in EXACT:
            errs.add(f"{name} fwd", fwd_rel, fwd_rel, cs.FWD_TOL, "edge")
            errs.add(f"{name} bwd", bwd_rel, bwd_rel, cs.BWD_TOL, "edge")
            for fa, ba in zip(rec["fwd"], rec["bwd"]):
                errs.add(f"{name} fwd", *cs.compare_fwd(tr, "window", cut(fa)),
                         cs.FWD_TOL, "recorded call")
                errs.add(f"{name} bwd", *cs.compare_bwd(tr, "window", cut(ba)),
                         cs.BWD_TOL, "recorded call")
    print(f"# max error vs twins (abs, rel): {errs.v}")
    order = list(libs) + list(reversed(list(libs)))
    for name in order:
        cuda_build.use(libs[name])
        f, b = time_calls("window", rec, a.reps)
        per = {nc: time_calls("window", {
            d: [x for x in rec[d] if x[5 if d == "fwd" else 9] == nc]
            for d in ("fwd", "bwd")}, a.reps) for nc in (5, 11)}
        print(f"# {name}: window fwd {f:.3f} ms, bwd {b:.3f} ms on the "
              f"stage-2 step's {len(rec['fwd'])} calls; nchan 5 "
              f"{per[5][0]:.3f} / {per[5][1]:.3f} ms, nchan 11 "
              f"{per[11][0]:.3f} / {per[11][1]:.3f} ms", flush=True)
    cuda_build.use(main_lib)  # the step also launches K5
    srec = record_split()
    for name in order:
        cuda_build.use(libs[name])
        f, b = time_calls("split", srec, 10 * a.reps)
        print(f"# {name}: split fwd {f:.3f} ms, bwd {b:.3f} ms on the 64x48 "
              f"stage-2 step's {len(srec['fwd'])} calls")
    cuda_build.use(main_lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
