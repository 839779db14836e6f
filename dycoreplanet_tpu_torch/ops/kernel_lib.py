"""Build, load and call the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, all sources in parallel (one ``nvcc`` each),
into ``csrc/_build`` (git-ignored), keyed by a hash of the sources, the
shared header and the flags, so an unchanged tree reuses its libraries.
Nothing here runs at import: the CPU tests import every module.

Every C entry point launches on the caller's stream (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``; callers
raise on a nonzero code via :func:`check`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Tuple

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
SOURCES = ("forcing.cu", "richardson.cu", "projection.cu")
HEADERS = ("shell_common.cuh",)
# no --use_fast_math: divisions and square roots stay IEEE
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's output per source (register / shared-memory use from ptxas -v)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of dycoreplanet_tpu_torch are built from source")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def lib_path(source: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{_digest()}.so")


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel;
    returns the seconds spent. Raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [s for s in SOURCES if not os.path.exists(lib_path(s))]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = f"{lib_path(src)}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG[src] = out
        if proc.returncode != 0:
            failed.append(f"--- {src} (rc {proc.returncode})\n{out}")
        else:
            os.replace(tmp, lib_path(src))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source (built on first use)."""
    lib = _LIBS.get(source)
    if lib is None:
        if not os.path.exists(lib_path(source)):
            build_all()
        lib = ctypes.CDLL(lib_path(source))
        _LIBS[source] = lib
    return lib


def bind(source: str, name: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(library(source), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"the CUDA kernels take float32 or float64, not {dtype}")


def require_cuda(what: str, shapes: Dict[str, Tuple[torch.Tensor, tuple]]
                 ) -> Tuple[torch.device, torch.dtype]:
    """Validate the kernel operands: one CUDA device, one float dtype,
    the expected shapes, C-contiguous. Returns (device, dtype)."""
    dev = dtype = None
    for name, (t, shape) in shapes.items():
        if not torch.is_tensor(t) or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be a CUDA tensor")
        if dev is None:
            dev, dtype = t.device, t.dtype
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {dev}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    suffix(dtype)
    return dev, dtype


# ----------------------------------------------------------------------
# lon-invariant metric channels of the shell, (nr, nlat) each, float64
def shell_channels(geo: Geometry) -> Dict[str, np.ndarray]:
    """Every shell metric the kernels read, as (nr, nlat) arrays: the
    shell's metric terms do not depend on longitude."""
    if geo.kind != "shell":
        raise ValueError("the CUDA kernels take the lat-lon shell only")
    nr, nlat, nlon = geo.cell_shape
    if nlon % 2:
        raise ValueError("the pole ghost rule needs an even nlon")

    def b2(a, rows, cols):
        a = np.asarray(a, np.float64)
        full = np.broadcast_to(a, (rows, cols, a.shape[-1]))
        if not np.allclose(full, full[..., :1]):
            raise ValueError("shell metric is not lon-invariant")
        return np.ascontiguousarray(full[..., 0])

    area_r = b2(geo.face_area[0], nr + 1, nlat)
    dist_r = b2(geo.face_dist[0], nr + 1, nlat)
    area_l = b2(geo.face_area[1], nr, nlat + 1)
    dist_l = b2(geo.face_dist[1], nr, nlat + 1)
    return {
        "vol": b2(geo.vol, nr, nlat),
        "ar_lo": area_r[:nr], "ar_hi": area_r[1:],
        "alat_lo": area_l[:, :nlat], "alat_hi": area_l[:, 1:],
        "alon": b2(geo.face_area[2], nr, nlat),
        "dr_lo": dist_r[:nr], "dr_hi": dist_r[1:],
        "dlat_lo": dist_l[:, :nlat], "dlat_hi": dist_l[:, 1:],
        "dlon": b2(geo.face_dist[2], nr, nlat),
        "rc": b2(geo.extras["r_centers"], nr, nlat),
    }


def lon_invariant(a: np.ndarray, name: str) -> np.ndarray:
    """(..., nr, nlat) slice of a cell-shaped array that must not vary
    along longitude."""
    a = np.asarray(a, np.float64)
    if not np.allclose(a, a[..., :1]):
        raise ValueError(f"{name} is not lon-invariant")
    return a[..., 0]
