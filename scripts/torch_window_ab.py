"""A/B timing of the port's compositor kernels (window and dense) on one
CUDA card.

    python3 scripts/torch_window_ab.py [--baseline DIR]
                                       [--variants nosum nowalk strict]

Builds, with ops/cuda_build.py, the kernel library of this checkout, of a
baseline checkout DIR (for example a parent commit unpacked with
`git archive <commit>`) and of this checkout's sources built with one of the
ablations of csrc/composite_common.cuh (-DD4GS_ABLATE=<n>), each into its
own directory under build/window_ab/. It drives one bench-shape stage-2
train step (chip_smoke.py's) with this checkout's kernels, records its 16
window calls and its static-reg render's dense (K5) call, and times every
library on them with CUDA events, forward and backward, in the order built
and again in reverse: the window kernels on all 16 calls and by channel
count (nchan 5: the three static windows; 11: the dynamic one); K5 alone
(and, for the indexed kernels, with every count 0: the per-block floor);
and K5's function from the render's inputs (means2d, conics, opacities,
channels) to its outputs and back through autograd: this checkout's table
build + indexed kernels + per-Gaussian reduction, against a baseline
without the indexed entries (no d4gs_dense_kernel_info: an older checkout)
run the way that baseline ran it, the payload gather of
ops/tiling.py::pack_with_binning + its dense-layout kernels + the gather's
backward. The checkout and the baseline are held against the plain twins
(window: the first 64 rows of each call and chip_smoke.py's edge buckets;
dense: the whole call, the baseline's forward only, and for the checkout
the edge cases of chip_smoke.py's phase_edge_dense) at its bars; the
`strict` ablation (an inexact cull) must fail the window edge buckets and
the dense edge cases. Last, every library is timed on the 12 split (K4)
calls of one 64x48 stage-2 step. Prints the card's name and power limit
first. Needs one card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from deblur4dgs_tpu_torch.ops import cuda_build  # noqa: E402
from deblur4dgs_tpu_torch.ops import rasterize as tr  # noqa: E402
from deblur4dgs_tpu_torch.ops import tiling as tt  # noqa: E402

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


def indexed(lib):
    """Whether the library has the indexed K5 entries."""
    return hasattr(lib, "d4gs_dense_kernel_info")


class LegacyDense:
    """The dense-layout K5 entries of a library built before the indexed
    K5: d4gs_dense_fwd(counts, data, accum, tfin, T, F, cap, nchan,
    tiles_x, stream) and d4gs_dense_bwd(counts, data, accum, tfin, gacc, gt,
    gdata, T, F, cap, nchan, tiles_x, stream) on data (T, 7 + D, cap)."""

    def __init__(self, lib):
        vp, i = ctypes.c_void_p, ctypes.c_int
        self.fwd_fn, self.bwd_fn = lib.d4gs_dense_fwd, lib.d4gs_dense_bwd
        self.fwd_fn.argtypes = [vp] * 4 + [i] * 5 + [vp]
        self.bwd_fn.argtypes = [vp] * 7 + [i] * 5 + [vp]
        self.fwd_fn.restype = self.bwd_fn.restype = i

    @staticmethod
    def _call(fn, *args):
        ptrs = [ctypes.c_void_p(a.data_ptr()) if torch.is_tensor(a) else a
                for a in args]
        err = fn(*ptrs, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cs.check(err == 0, f"legacy dense launch failed: {err}")

    def fwd(self, data, counts, tiles_x, nchan):
        T, F, cap = data.shape
        accum = data.new_empty((T, cs.TILE * cs.TILE, nchan))
        tfin = data.new_empty((T, cs.TILE * cs.TILE, 1))
        self._call(self.fwd_fn, counts, data, accum, tfin, T, F, cap, nchan,
                   tiles_x)
        return accum, tfin

    def bwd(self, data, counts, accum, tfin, gacc, gt, tiles_x, nchan):
        T, F, cap = data.shape
        gdata = torch.empty_like(data)
        self._call(self.bwd_fn, counts, data, accum, tfin, gacc, gt, gdata,
                   T, F, cap, nchan, tiles_x)
        return gdata


class _LegacyComposite(torch.autograd.Function):
    """A baseline's dense-layout K5 as an autograd Function (the parent's
    composite_tiles over another library)."""

    @staticmethod
    def forward(ctx, legacy, data, counts, tiles_x, nchan):
        accum, tfin = legacy.fwd(data, counts, tiles_x, nchan)
        ctx.save_for_backward(data, counts, accum, tfin)
        ctx.cfg = (legacy, tiles_x, nchan)
        return accum, tfin

    @staticmethod
    def backward(ctx, gacc, gt):
        data, counts, accum, tfin = ctx.saved_tensors
        legacy, tiles_x, nchan = ctx.cfg
        return (None, legacy.bwd(data, counts, accum, tfin, gacc.contiguous(),
                                 gt.contiguous(), tiles_x, nchan),
                None, None, None)


def record(kind, drive):
    """The calls of ``kind`` that ``drive()`` makes."""
    with cs.recording(tr, kind) as rec:
        drive()
        torch.cuda.synchronize()
    return rec


def record_stage2():
    """The 16 window calls of one bench-shape stage-2 step (after one
    warm-up step), its dense (K5) call and the K5 host parts' arguments."""
    state, drive = cs.bench_state(cs.DEV, "stage2")
    state, _, _ = drive(state)
    with cs.recording(tr, "window") as rec, \
            cs.recording(tr, "dense") as rec_d, \
            cs.recording_dense_host(tr) as host:
        drive(state)
        torch.cuda.synchronize()
    del state
    torch.cuda.empty_cache()
    return rec, rec_d, host


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


class MaxRel:
    """cs.Errs without the bar: the largest relative error per name."""

    def __init__(self):
        self.v = {}

    def add(self, name, err, rel, tol, what):
        self.v[name] = max(self.v.get(name, 0.0), rel)


def dense_edge_errors():
    """Max relative errors (fwd, bwd per slot and per Gaussian) of the
    current library's indexed K5 against the twins on phase_edge_dense's
    cases."""
    errs = MaxRel()
    cs.phase_edge_dense(tr, errs)
    return errs.v["dense_fwd"], errs.v["dense_bwd"]


def time_calls(kind, rec, reps):
    """(fwd ms, bwd ms) of the current library over all recorded calls."""
    k_fwd, _, k_bwd, _ = tr._COMPOSITORS[kind]
    return (cs.cuda_ms(lambda: [k_fwd(*a) for a in rec["fwd"]], reps),
            cs.cuda_ms(lambda: [k_bwd(*a) for a in rec["bwd"]], reps))


class DenseCall:
    """The static-reg render's K5 call, recorded: its indexed kernel args,
    and from the render's inputs the leaves and the binning, to run the
    function either way (indexed, or a legacy baseline's gather path)."""

    def __init__(self, rec_d, host):
        (self.fa,), (self.ba,) = rec_d["fwd"], rec_d["bwd"]
        ((proj, op, ch),) = host["table"]
        self.gacc, self.gt = self.ba[5], self.ba[6]
        self.nchan = ch.shape[1]
        self.tiles_x = self.fa[3]
        self.leaves = [x.detach().clone().requires_grad_(True)
                       for x in (proj.means2d, proj.conics, op, ch)]
        self.rest = [x.detach() for x in proj[2:]]
        self.proj = type(proj)(self.leaves[0], self.leaves[1], *self.rest)
        img_wh = (cs.W, cs.H)
        self.binning = tt.bin_indexed(self.proj, img_wh, cs.TILE_CAP)
        gi, counts, raw, order, _ = tt.bin_gaussians_pairs(
            self.proj, img_wh, cs.TILE_CAP)
        self.pairs = (gi, counts, raw, order, tt.num_tiles(img_wh))

    def packed(self):
        gi, counts, raw, order, tiles_xy = self.pairs
        return tt.pack_with_binning(self.proj, self.leaves[2], self.leaves[3],
                                    gi, counts, raw, order, tiles_xy)

    def outputs(self, legacy=None):
        """The function's forward (accum, tfin) from the leaves, through
        the indexed K5 or a legacy baseline's gather path."""
        if legacy is None:
            b = self.binning
            return tr.composite_indexed(
                tt.dense_table(self.proj, self.leaves[2], self.leaves[3]),
                b.idx, b.counts, b.slot_map, self.tiles_x, self.nchan)
        pk = self.packed()
        return _LegacyComposite.apply(legacy, pk.tile_data, pk.counts,
                                      self.tiles_x, self.nchan)

    def empty_rows(self, reps):
        """(fwd, bwd) device ms (cs.device_ms) of the indexed kernels on the call
        with every count 0: the launch and its 3600 blocks, each writing its
        outputs (the forward) or nothing (the backward), no slot staged.
        What more rows per block could save is below this."""
        k_fwd, _, k_bwd, _ = tr._COMPOSITORS["dense"]
        z = torch.zeros_like(self.fa[2])
        return (cs.device_ms(lambda: k_fwd(*self.fa[:2], z, *self.fa[3:]),
                             reps),
                cs.device_ms(lambda: k_bwd(*self.ba[:2], z, *self.ba[3:]),
                             reps))

    def times(self, legacy, reps):
        """{what: (events ms, device ms)} for the kernels ("fwd", "bwd")
        and the function ("function fwd", "function bwd"); cs.cuda_ms and
        cs.device_ms."""
        if legacy is None:
            k_fwd, _, k_bwd, _ = tr._COMPOSITORS["dense"]
            fns = {"fwd": lambda: k_fwd(*self.fa),
                   "bwd": lambda: k_bwd(*self.ba)}
        else:
            with torch.no_grad():
                pk = self.packed()
                acc, tf = legacy.fwd(pk.tile_data, pk.counts, self.tiles_x,
                                     self.nchan)
            fns = {"fwd": lambda: legacy.fwd(pk.tile_data, pk.counts,
                                             self.tiles_x, self.nchan),
                   "bwd": lambda: legacy.bwd(
                       pk.tile_data, pk.counts, acc, tf, self.gacc, self.gt,
                       self.tiles_x, self.nchan)}
        out = {d: (cs.cuda_ms(f, reps), cs.device_ms(f, reps))
               for d, f in fns.items()}

        def fwd():
            with torch.no_grad():
                return self.outputs(legacy)

        graph = self.outputs(legacy)
        fns = {"function fwd": fwd,
               "function bwd": lambda: torch.autograd.grad(
                   graph, self.leaves, (self.gacc, self.gt),
                   retain_graph=True)}
        out.update({d: (cs.cuda_ms(f, reps), cs.device_ms(f, reps))
                    for d, f in fns.items()})
        return out

    @torch.no_grad()
    def forward_error(self, legacy):
        """Max |accum or tfin - twin| / max(1, |twin|) of the function's
        forward (the whole call)."""
        acc, tf = self.outputs(legacy)
        pa, pt = tr.composite_dense_plain(*self.fa)
        err = max(float((acc - pa).abs().max()), float((tf - pt).abs().max()))
        return err / max(1.0, float(pa.abs().max()))


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
    rec, rec_d, host = record_stage2()
    dense = DenseCall(rec_d, host)
    legacy = {n: None if indexed(lib) else LegacyDense(lib)
              for n, lib in libs.items()}
    errs = cs.Errs()
    cut = lambda x: tuple(t[:64] if torch.is_tensor(t) else t for t in x)
    for name, lib in libs.items():
        cuda_build.use(lib)
        fwd_rel, bwd_rel = edge_errors()
        print(f"# {name}: edge buckets max rel err fwd {fwd_rel:.3e}, bwd "
              f"{bwd_rel:.3e} (bars {cs.FWD_TOL}, {cs.BWD_TOL})")
        d_fwd = d_bwd = None
        if legacy[name] is None:
            d_fwd, d_bwd = dense_edge_errors()
            print(f"# {name}: dense edge cases max rel err fwd {d_fwd:.3e}, "
                  f"bwd {d_bwd:.3e}")
        if name == "strict":
            cs.check(fwd_rel > cs.FWD_TOL or bwd_rel > cs.BWD_TOL,
                     "the edge buckets did not catch the inexact cull")
            cs.check(d_fwd > cs.FWD_TOL or d_bwd > cs.BWD_TOL,
                     "the dense edge cases did not catch the inexact cull")
        if name in EXACT:
            errs.add(f"{name} fwd", fwd_rel, fwd_rel, cs.FWD_TOL, "edge")
            errs.add(f"{name} bwd", bwd_rel, bwd_rel, cs.BWD_TOL, "edge")
            for fa, ba in zip(rec["fwd"], rec["bwd"]):
                errs.add(f"{name} fwd", *cs.compare_fwd(tr, "window", cut(fa)),
                         cs.FWD_TOL, "recorded call")
                errs.add(f"{name} bwd", *cs.compare_bwd(tr, "window", cut(ba)),
                         cs.BWD_TOL, "recorded call")
            r = dense.forward_error(legacy[name])
            errs.add(f"{name} dense fwd", r, r, cs.FWD_TOL, "recorded call")
            if d_fwd is not None:
                errs.add(f"{name} dense fwd", d_fwd, d_fwd, cs.FWD_TOL, "edge")
                errs.add(f"{name} dense bwd", d_bwd, d_bwd, cs.BWD_TOL, "edge")
                (_, rs), (_, rg) = cs.compare_dense_bwd(
                    tr, dense.ba, host["grad"][0][1])
                errs.add(f"{name} dense bwd", rs, rs, cs.BWD_TOL, "per slot")
                errs.add(f"{name} dense bwd", rg, rg, cs.BWD_TOL,
                         "per Gaussian")
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
    for name in order:
        cuda_build.use(libs[name])
        t = dense.times(legacy[name], 4 * a.reps)
        how = ("gather + dense-layout K5 + gather backward" if legacy[name]
               else "table + indexed K5 + per-Gaussian reduction")
        empty = ("" if legacy[name] else "; every row emptied, device: fwd "
                 "%.4f ms, bwd %.4f ms" % dense.empty_rows(4 * a.reps))
        print(f"# {name}: dense K5 (events / device ms) fwd {t['fwd'][0]:.4f}"
              f" / {t['fwd'][1]:.4f}, bwd {t['bwd'][0]:.4f} / "
              f"{t['bwd'][1]:.4f}; function ({how}, autograd from the render's"
              f" inputs) fwd {t['function fwd'][0]:.4f} / "
              f"{t['function fwd'][1]:.4f}, bwd {t['function bwd'][0]:.4f} / "
              f"{t['function bwd'][1]:.4f} on the static-reg call{empty}",
              flush=True)
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
