"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources compile at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and link into one
shared library with a plain C interface under ``build/slamrs_tpu_torch/``
beside the package; it loads with ``ctypes``.  The library is rebuilt
when a source or header is newer.  Importing this module builds nothing,
so it imports on machines without ``nvcc``.

``--fmad=false`` keeps every multiply and add separately rounded, as
PyTorch's elementwise ops round them, so a kernel agrees with its plain
version up to the ordering of sums.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "slamrs_tpu_torch"
LIB = BUILD_DIR / "libslamrs_tpu_torch_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises if none has it."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((str(Path(home) / "bin" / "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the CUDA toolkit is")


def _run_together(cmds: list[list[str]]) -> None:
    """Start every command at once, wait for all; raise on any failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errs = [proc.communicate()[1] for proc in procs]
    for cmd, proc, err in zip(cmds, procs, errs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{err}")


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into :data:`LIB` unless it is up to date."""
    srcs = sources()
    newest = max(s.stat().st_mtime for s in srcs + sorted(CSRC.glob("*.cuh")))
    if not force and LIB.exists() and LIB.stat().st_mtime >= newest:
        return LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = LIB.with_name(f"{LIB.name}.{tag}.tmp")
    try:
        _run_together([[nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                       for src, obj in zip(srcs, objs)])
        _run_together([[nvcc(), *ARCH, "-shared", "-o", str(tmp),
                        *map(str, objs)]])
        os.replace(tmp, LIB)  # atomic: a loader never sees half a file
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return LIB


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), argtypes set."""
    lib = ctypes.CDLL(str(build()))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.slamrs_fused_update
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp,  # buffers
                   ci, ci, ci, ci, ci, ci, ci, ci, ci, ci,  # shapes, flags
                   cf, cf, cf,  # static bin-units constants
                   vp]  # stream
    fn.restype = ci
    fn = lib.slamrs_fused_update_tiled
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,  # buffers
                   ci, ci, ci, ci, ci, ci, ci, ci, ci, ci,  # shapes, flags
                   cf, cf, cf,  # static bin-units constants
                   vp]  # stream
    fn.restype = ci
    fn = lib.slamrs_cow_copy
    fn.argtypes = [vp, vp, vp, vp,  # grids, src, dst, n_copies
                   ci, ctypes.c_longlong,  # maps, bytes per map
                   vp]  # stream
    fn.restype = ci
    fn = lib.slamrs_nn_argmin
    fn.argtypes = [vp, vp, vp, vp, vp, vp,  # p, q, q_count, partials,
                   # counters, out
                   ci, ci, ci,  # problems, p lanes, q lanes
                   ci, ci, ci,  # threads per group, groups, chunks
                   vp]  # stream
    fn.restype = ci
    fn = lib.slamrs_icp_solve
    fn.argtypes = [vp, vp, vp, vp, vp,  # p, p_mask, q, q_count, corr
                   vp, vp, vp, vp,  # x_in, x_out, p_t, chi
                   ci, ci, ci, ci, ci,  # problems, p lanes, q lanes,
                   # iterations, iteration
                   ci, cf,  # threshold on, threshold squared
                   vp]  # stream
    fn.restype = ci
    ll = ctypes.c_longlong
    fn = lib.slamrs_sim_frame
    fn.argtypes = [vp, vp, vp, vp, vp,  # pose, accumulators, speeds
                   ll, ll, ci,  # speed strides, ticks
                   cf, cf,  # dt, 1 / wheel base
                   vp, vp, ci, cf, ci,  # segments, mask, count, range,
                   # beams
                   vp, vp, vp,  # pose and accumulators out
                   vp, vp, vp, vp, vp,  # angles, distances, strengths,
                   # valid, present
                   ci, vp]  # worlds, stream
    fn.restype = ci
    return lib
