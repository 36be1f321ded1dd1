"""Build and load the CUDA kernel library.

All `tpu_ray_torch/csrc/*.cu` files compile with nvcc into one shared
library with a plain C interface, loaded with ctypes: one nvcc process per
source, all started together, then one link. The library is keyed
by a hash of the sources and flags, written to a temporary file and renamed
into `build/tpu_ray_torch/` at the repository root, so concurrent builds
never see a half-written file. A missing nvcc or a failed build raises with
the compiler's output; there is no fallback.

Flags: `--fmad=false` keeps every multiply and add separate, as torch's
elementwise ops are, so a kernel rounds like its plain PyTorch version (the
Mandelbulb iteration is chaotic; contraction alone would flip hits at
fractal edges). Without `--use_fast_math`, division and sqrtf stay IEEE.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_ray_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
# C entry points (csrc/*.cu): each returns cudaGetLastError() after its launch
_SIGNATURES = {
    # o, d, n, params, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8, bounds,
    # n_bounds, t0, max_steps, eps, t_far, t, hit, steps, tmin, counters,
    # stream
    "tr_march": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _I,
                 _F, _I, _F, _F, _P, _P, _P, _P, _P, _P],
    # p, l, t_far_rays, n, params, n_sph, n_pln, n_box, n_mb, mb_iters,
    # mb_pow8, bounds, n_bounds, eps, t_far, steps, bias, vis, ts, counters,
    # stream
    "tr_shadow_hard": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _I,
                       _F, _F, _I, _F, _P, _P, _P, _P],
    # p, l, t_far_rays, n, params, n_sph, n_pln, n_box, n_mb, mb_iters,
    # mb_pow8, eps, t_far, steps, bias, soft_k, vis, ts, counters, stream
    "tr_shadow_soft": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                       _F, _F, _I, _F, _F, _P, _P, _P, _P],
    # o, d, t_init, n, t_far, corners, chunk_aabb, super_aabb, tree,
    # n_supers, perm, perm_len, any_hit, t, tri, hit, counters, stream
    "tr_intersect_packet_streamed": [_P, _P, _P, _I, _F, _P, _P, _P, _P, _I,
                                     _P, _I, _I, _P, _P, _P, _P, _P],
    # o, d, t_init, n, t_far, corners, chunk_aabb, super_aabb, super_order,
    # n_supers, perm, perm_len, any_hit, t, tri, hit, counters, stream
    "tr_intersect_packet_resident": [_P, _P, _P, _I, _F, _P, _P, _P, _P, _I,
                                     _P, _I, _I, _P, _P, _P, _P, _P],
    # o, d, corners, t_bar, tmin, hs, hm, closer, mat, vis, ts, ao_tmesh, n,
    # small, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8, n_mat, n_dir,
    # n_pos, use_sdf, use_mesh, ao_sdf, ao_mesh, soft_diff, soft_sil,
    # mesh_sil, ao_step, ao_strength, soft_k, bias, out, stream
    "tr_shade_fwd": ([_P] * 12 + [_I, _P] + [_I] * 14 + [_F, _F, _D, _F, _F, _F]
                     + [_P, _P]),
    # as tr_shade_fwd with ct after ao_tmesh, then d_o, d_d, d_corners,
    # partials, n_partial_rows, d_small, counters, stream after bias
    "tr_shade_bwd": ([_P] * 13 + [_I, _P] + [_I] * 14 + [_F, _F, _D, _F, _F, _F]
                     + [_P] * 4 + [_I, _P, _P, _P]),
    # rays per block of tr_shade_bwd (one partial row each)
    "tr_shade_bwd_threads": [],
    # o, d, t_bar, tmin, hs, tri, hm, rows, n_tris, n, params, prim_mat,
    # n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8, use_sdf, use_mesh,
    # soft_sil, bias, t, hit, p, n, mat, cov, closer, nf, p_off, stream
    "tr_reconstruct": [_P] * 8 + [_I, _I, _P, _P] + [_I] * 8 + [_F, _F] + [_P] * 10,
    # stage (its index in utils.metrics.STAGES), stream: its empty marker
    "tr_trace_stage": [_I, _P],
    # rows, n_tris, idx, n, out, stream
    "tr_corner_gather": [_P, _I, _P, _I, _P, _P],
    # n, n_tris: the bytes of tr_corner_scatter's scratch
    "tr_corner_scatter_scratch": [_I, _I],
    # ct, idx, n, n_tris, grad, scratch, counters, stream
    "tr_corner_scatter": [_P, _P, _I, _I, _P, _P, _P, _P],
}
# entry points that return something else than a cudaError_t
_RESTYPES = {"tr_corner_scatter_scratch": ctypes.c_longlong}

_LIB = None
BUILD_LOG = {"seconds": 0.0, "built": False, "path": "", "ptxas": ""}


def _nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libtpu_ray_torch_{h.hexdigest()[:16]}.so"


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stderr + proc.stdout


def _compile(out: Path) -> None:
    nvcc = _nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "tpu_ray_torch cannot be built")
    cu, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [out.with_name(f"{out.stem}.{f.stem}.{os.getpid()}.o") for f in cu]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=len(cu)) as pool:
            logs = list(pool.map(_run, [
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
                for src, obj in zip(cu, objs)]))
        _run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
              "-o", str(tmp), *map(str, objs)])
        os.replace(tmp, out)
    finally:
        for f in (tmp, *objs):
            f.unlink(missing_ok=True)
    BUILD_LOG.update(seconds=time.perf_counter() - t0, built=True,
                     ptxas="".join(logs))


def kernel_lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Raises on failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not path.is_file():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    BUILD_LOG["path"] = str(path)
    _LIB = lib
    return lib


def check_launch(name: str, rc: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def check_cuda_inputs(name: str, *tensors) -> None:
    """Raise unless every given tensor is a contiguous float32 CUDA tensor on
    one device that does not require grad (None entries are skipped)."""
    given = [t for t in tensors if t is not None]
    dev = given[0].device
    for t in given:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.requires_grad:
            raise ValueError(f"{name}: the kernel takes no gradient")


def check_counters(name: str, counters, device, names) -> None:
    """Raise unless counters is None or a contiguous int64 tensor of at least
    len(names) on device (a kernel's optional counters)."""
    if counters is not None and (counters.device != device or counters.dtype != torch.int64
                                 or counters.numel() < len(names)
                                 or not counters.is_contiguous()):
        raise ValueError(f"{name}: counters must be a contiguous int64 tensor of "
                         f"{len(names)} on the rays' device")
