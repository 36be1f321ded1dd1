"""The native (C++) packet-accel builder, loaded with ctypes.

`accel_build.cpp` (a copy of the reference's) does the Morton sort and the
corner / box / perm fill of accel/packet.py's build in one multithreaded
pass, bit for bit the numpy build's output, and takes seconds where numpy
takes minutes at 8.4M triangles. It compiles at first use with
`g++ -O3 -fPIC -shared -fopenmp -std=c++17` into `build/tpu_ray_torch/` at
the repository root (as the CUDA kernels do), keyed by a hash of the source
and the ABI tag, written to a per-process temporary file and renamed, so
concurrent builders never load a half-written library.

Unlike the reference, nothing falls back silently: a failed compile raises
with the compiler's message, and a library whose ABI tag differs raises.
Only the switch TPU_RAY_TORCH_NATIVE=0 (or off / false) chooses the numpy
build (`enabled()`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "accel_build.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_ray_torch"
ABI = 1128161  # tpu_ray_accel_abi() of accel_build.cpp
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17"]
ENV_SWITCH = "TPU_RAY_TORCH_NATIVE"

_lib = None
# seconds of the last compile (0 when the library was already built), and
# the library's path
BUILD_LOG = {"seconds": 0.0, "built": False, "path": ""}


def enabled() -> bool:
    """False only when TPU_RAY_TORCH_NATIVE is 0, off or false."""
    return os.environ.get(ENV_SWITCH, "1").strip().lower() not in ("0", "off", "false")


def library_path(src: Path | None = None) -> Path:
    """The library's path under BUILD_DIR, keyed by the source, the ABI tag
    and the flags."""
    src = src or SRC
    tag = hashlib.sha1(src.read_bytes() + f"{ABI}|{' '.join(CXX_FLAGS)}".encode()).hexdigest()
    return BUILD_DIR / f"accel_build_{tag[:16]}.so"


def compile_library(src: Path | None = None, out: Path | None = None) -> Path:
    """Compile the builder (SRC by default) unless its library exists; raises
    RuntimeError with the compiler's output when g++ fails or is missing."""
    src = src or SRC
    out = out or library_path(src)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(src)],
                           capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"tpu_ray_torch.native: g++ failed to run: {e!r}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"tpu_ray_torch.native: g++ failed on {src.name} "
                           f"(exit {r.returncode}):\n{r.stderr}{r.stdout}")
    os.replace(tmp, out)
    BUILD_LOG.update(seconds=time.perf_counter() - t0, built=True)
    return out


def load_library(path: Path):
    """The ctypes library at path, its ABI tag checked and its signatures set."""
    lib = ctypes.CDLL(str(path))
    lib.tpu_ray_accel_abi.restype = ctypes.c_int64
    abi = int(lib.tpu_ray_accel_abi())
    if abi != ABI:
        raise RuntimeError(f"tpu_ray_torch.native: {path.name} has ABI tag {abi}, "
                           f"the port expects {ABI}")
    i64 = ctypes.c_int64
    p = ctypes.POINTER
    lib.tpu_ray_accel_build.restype = ctypes.c_int
    lib.tpu_ray_accel_build.argtypes = [
        p(ctypes.c_double), i64, p(i64), i64, p(i64), p(ctypes.c_float), i64,
        p(ctypes.c_float), i64, p(ctypes.c_float), i64, p(ctypes.c_int32), i64]
    return lib


def accel_lib():
    """The compiled builder (compiled and loaded at the first call)."""
    global _lib
    if _lib is None:
        path = compile_library()
        _lib = load_library(path)
        BUILD_LOG["path"] = str(path)
    return _lib


def build_accel(verts64: np.ndarray, tris: np.ndarray, tri_id_base=None,
                chunk: int = 128, rows_per_chunk: int = 16, super_: int = 16) -> dict:
    """One packet accel of T > 0 triangles as numpy arrays: corners
    (C_pad*16, 128) f32, chunk_aabb (C_pad, 128) f32, super_aabb (S, 128)
    f32 and perm (Tpad,) int32 (tri_id_base[t] in place of t when given)."""
    lib = accel_lib()
    T = tris.shape[0]
    Tpad = -(-T // chunk) * chunk
    S = -(-(Tpad // chunk) // super_)
    C_pad = S * super_
    verts_c = np.ascontiguousarray(verts64, np.float64)
    tris_c = np.ascontiguousarray(tris, np.int64)
    ids_c = None if tri_id_base is None else np.ascontiguousarray(tri_id_base, np.int64)
    out = dict(corners=np.zeros((C_pad * rows_per_chunk, chunk), np.float32),
               chunk_aabb=np.zeros((C_pad, 128), np.float32),
               super_aabb=np.zeros((S, 128), np.float32),
               perm=np.zeros((Tpad,), np.int32))
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    rc = lib.tpu_ray_accel_build(
        ptr(verts_c, ctypes.c_double), verts_c.shape[0], ptr(tris_c, ctypes.c_int64), T,
        None if ids_c is None else ptr(ids_c, ctypes.c_int64),
        ptr(out["corners"], ctypes.c_float), out["corners"].shape[0],
        ptr(out["chunk_aabb"], ctypes.c_float), C_pad,
        ptr(out["super_aabb"], ctypes.c_float), S, ptr(out["perm"], ctypes.c_int32), Tpad)
    if rc != 0:
        raise RuntimeError(f"tpu_ray_torch.native: tpu_ray_accel_build returned {rc} "
                           f"for {T} triangles")
    return out
