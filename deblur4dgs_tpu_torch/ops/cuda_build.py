"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc + ctypes.

No counterpart in the JAX package. On first use, every ``csrc/*.cu`` file is
compiled for Hopper (``sm_90a``) by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain
C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c csrc/<name>.cu -o build/kernels/<name>.o
    nvcc -shared -o build/kernels/libd4gs_kernels.so build/kernels/*.o

The library lands in ``build/kernels/`` at the repository root (listed in
.gitignore) next to a stamp holding the sources' hash (``*.cu`` and
``*.cuh``); it is rebuilt when any source changes. Only the CUDA branches
of the wrappers import this module, so CPU runs never look for nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
LIB_NAME = "libd4gs_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib = None
# What the last build in this process did: {"built": bool, "seconds": float,
# "log": nvcc's output}; chip_smoke.py prints it.
BUILD_INFO: dict = {}


def _sources(csrc_dir: Path) -> list[Path]:
    srcs = sorted(csrc_dir.glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {csrc_dir}")
    return srcs


def _hash(srcs: list[Path], csrc_dir: Path, flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in srcs + sorted(csrc_dir.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put it on PATH)")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise with its output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def build(verbose_ptxas: bool = False, csrc_dir: Path = CSRC_DIR,
          build_dir: Path = BUILD_DIR, defines: tuple[str, ...] = ()) -> Path:
    """Compile csrc_dir/*.cu into build_dir/LIB_NAME unless the stamp
    matches; ``defines`` are passed to nvcc as -D flags."""
    csrc_dir, build_dir = Path(csrc_dir), Path(build_dir)
    srcs = _sources(csrc_dir)
    flags = [*ARCH_FLAGS, *(f"-D{d}" for d in defines)]
    digest = _hash(srcs, csrc_dir, flags)
    lib_path = build_dir / LIB_NAME
    stamp = build_dir / (LIB_NAME + ".sha256")
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        BUILD_INFO.update(built=False, seconds=0.0, log="")
        return lib_path
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [build_dir / f".{src.stem}.{tag}.o" for src in srcs]
    ptxas = ["-Xptxas", "-v"] if verbose_ptxas else []
    t0 = time.time()
    log = _run_all([
        [nvcc, *ptxas, *flags, "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC", "-c", str(src), "-o", str(obj)]
        for src, obj in zip(srcs, objs)
    ])
    tmp = build_dir / f".{LIB_NAME}.{tag}"
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    BUILD_INFO.update(built=True, seconds=time.time() - t0, log=log)
    return lib_path


def load(verbose_ptxas: bool = False):
    """The ctypes handle of the kernel library (built on first use)."""
    global _lib
    if _lib is None:
        _lib = open_library(build(verbose_ptxas))
    return _lib


def use(lib):
    """Make the wrappers launch through ``lib`` (an open_library handle, for
    example of another checkout's sources); returns the one it replaces."""
    global _lib
    old, _lib = _lib, lib
    return old


def open_library(path: Path):
    """ctypes handle of a built kernel library with the C entries' types
    (an entry the library lacks is left out)."""
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for kind in ("window", "window_scatter"):
        fwd, bwd = (getattr(lib, f"d4gs_{kind}_{d}") for d in ("fwd", "bwd"))
        fwd.argtypes = [vp] * 6 + [i] * 8 + [vp]
        fwd.restype = i
        bwd.argtypes = [vp] * 10 + [i] * 8 + [vp]
        bwd.restype = i
    # The indexed K5 entries (idx, counts, table, ...) come with
    # d4gs_dense_kernel_info; an older library's dense-layout entries are
    # left unbound (scripts/torch_window_ab.py binds them for a baseline).
    if hasattr(lib, "d4gs_dense_kernel_info"):
        lib.d4gs_dense_fwd.argtypes = [vp] * 5 + [i] * 5 + [vp]
        lib.d4gs_dense_fwd.restype = i
        lib.d4gs_dense_bwd.argtypes = [vp] * 8 + [i] * 5 + [vp]
        lib.d4gs_dense_bwd.restype = i
    for kind in ("window", "dense"):
        if hasattr(lib, f"d4gs_{kind}_kernel_info"):
            fn = getattr(lib, f"d4gs_{kind}_kernel_info")
            fn.argtypes = [i, ctypes.POINTER(i)]
            fn.restype = i
    lib.d4gs_error_string.argtypes = [i]
    lib.d4gs_error_string.restype = ctypes.c_char_p
    return lib


INFO_KEYS = ("registers", "spill_bytes", "static_smem", "dynamic_smem",
             "blocks_per_sm")


def _kernel_info(kind: str, nchan: int) -> dict:
    out = (ctypes.c_int * 10)()
    err = getattr(load(), f"d4gs_{kind}_kernel_info")(nchan, out)
    if err != 0:
        raise RuntimeError(f"{kind} kernel info failed: {error_string(err)}")
    return {d: dict(zip(INFO_KEYS, out[5 * i : 5 * i + 5]))
            for i, d in enumerate(("fwd", "bwd"))}


def window_kernel_info(nchan: int) -> dict:
    """Resources of the window kernel instances a call with ``nchan``
    channels launches (cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor at 256 threads):
    {"fwd": {...}, "bwd": {...}} keyed by INFO_KEYS; spill_bytes is the
    local memory per thread."""
    return _kernel_info("window", nchan)


def dense_kernel_info(nchan: int) -> dict:
    """window_kernel_info for the dense (K5) instances a call with
    ``nchan`` channels launches."""
    return _kernel_info("dense", nchan)


def error_string(err: int) -> str:
    return f"{err} ({load().d4gs_error_string(err).decode()})"
