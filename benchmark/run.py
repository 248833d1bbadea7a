#!/usr/bin/env python3
"""The benchmark of deblur4dgs_tpu_torch, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload high.stage2 --seed 7 --seconds 30 \
        --trace 0

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (BENCHMARK.json). With ``--trace 0`` it prints the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiler trace; either way it checks the port's first steps against the
frozen reference (benchmark/reference/) and prints each number compared
beside its limit, last on standard error and last in the result. The
result is the last line of standard output, one JSON object. Without a
card, or on a card without published peaks, it fails and prints no
result. See benchmark/README.md.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Whole top-level module names that must not be loaded: JAX and the JAX
# package (the port's name begins with the latter's, so compare whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "deblur4dgs_tpu")


def _cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its kernels into build/kernels/ there itself)."""
    base = os.path.join(ROOT, "build", "bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi():
    """{name, power_limit_w, clocks_sm_mhz, clocks_max_sm_mhz} of card 0,
    or {} where nvidia-smi cannot tell."""
    q = "name,power.limit,clocks.sm,clocks.max.sm"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return {}
    vals = [v.strip() for v in out.stdout.splitlines()[0].split(",")]

    def num(v):
        try:
            return float(v)
        except ValueError:
            return None
    return {"name": vals[0], "power_limit_w": num(vals[1]),
            "clocks_sm_mhz": num(vals[2]), "clocks_max_sm_mhz": num(vals[3])}


def _finite(v):
    """A JSON number for a compared value: infinity as 1e300, NaN as
    null (either fails its limit)."""
    if v != v:
        return None
    return min(v, 1e300)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    _cache_dirs()
    sys.path[:0] = [HERE, ROOT]
    from harness import peaks, runner, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    bandwidth, peak_flops, part = peaks.card_peaks(kind)
    torch.set_num_threads(4)
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", (bandwidth, peak_flops), T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {loaded}: the port must load no "
              "JAX and no JAX package", file=sys.stderr)
        return 3
    smi = nvidia_smi()
    print(f"# card {kind} ({part}; peaks {bandwidth:.3e} B/s, "
          f"{peak_flops:.3e} fp32 flop/s), nvidia-smi {smi}")
    print(f"# memory peak {out.memory_peak_bytes} bytes, steps "
          f"{out.attempted}, failed {out.failed}")
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(out.memory_peak_bytes),
              "power_limit_w": smi.get("power_limit_w"), **out.device_extra}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    result = {
        "correct": bool(out.correct),
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in out.metrics.items()},
        "device": device,
    }
    if out.breakdown is not None:
        result["breakdown"] = out.breakdown
    result["checks"] = {name: {"value": _finite(v), "limit": lim}
                        for name, v, lim, _ in out.checks}
    for name, v, lim, detail in out.checks:
        print(f"check {name} {v!r} limit {lim!r} ({detail})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
