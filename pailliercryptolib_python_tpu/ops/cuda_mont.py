"""Montgomery product on NVIDIA GPUs: the CUDA kernel in mont_mul.cu,
called as a JAX operation through the foreign function interface.

It returns the same (L, B) limbs as montgomery._mont_mul_jnp, bit for
bit.  The shared library is built from mont_mul.cu with nvcc at first
use, into build/ beside this file, under a name that carries the
source's hash (so an edited source never loads a stale binary).  Build it
ahead of time with

    python -m pailliercryptolib_python_tpu.ops.cuda_mont

nvcc is looked up on PATH, then under $CUDA_HOME (default
/usr/local/cuda).  A failed build raises: there is no fallback to the
jnp product on the GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import jax
import jax.numpy as jnp

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "mont_mul.cu")
_BUILD_DIR = os.path.join(_HERE, "build")
_TARGET = "paillier_mont_mul"
_ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + _ARCH.encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libmont_mul-{digest}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"cuda_mont: nvcc not found on PATH or at {path}; set CUDA_HOME")
    return path


def build() -> str:
    """Compile mont_mul.cu (if not built yet); returns the library path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", _ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(),
           "-o", tmp, _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"cuda_mont: nvcc failed ({res.returncode}):"
                               f"\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)      # atomic: concurrent builders never clash
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _register() -> None:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.cdll.LoadLibrary(build())
            jax.ffi.register_ffi_target(
                _TARGET, jax.ffi.pycapsule(lib.PaillierMontMul),
                platform="CUDA")
            _lib = lib


def shape_args(a, b, n):
    """Check the operands and bring them to the kernel's contract.

    a, b, n: (L, ·) canonical limbs whose batch widths are each 1 (shared
    across the batch, read with a zero column stride) or the common
    width B; no operand is broadcast or padded in memory, and any B,
    odd or not, is served (the kernel masks the last block).
    Returns (a, b, n, B) with uint32 operands."""
    if a.ndim != 2 or b.ndim != 2 or n.ndim != 2:
        raise ValueError("mont_mul: operands must be (L, B) limb arrays")
    L = a.shape[0]
    if b.shape[0] != L or n.shape[0] != L:
        raise ValueError(f"mont_mul: limb counts differ "
                         f"({a.shape[0]}, {b.shape[0]}, {n.shape[0]})")
    widths = (a.shape[1], b.shape[1], n.shape[1])
    B = max(widths)
    if any(w not in (1, B) for w in widths):
        raise ValueError(f"mont_mul: batch widths {widths} do not broadcast")
    u32 = jnp.uint32
    return a.astype(u32), b.astype(u32), n.astype(u32), B


def mont_mul(a, b, n):
    """a*b*R^-1 mod n (< 2n for inputs < 2n), R = 2^(16L), on the GPU."""
    a, b, n, B = shape_args(a, b, n)
    return _ffi_mont_mul(a, b, n, B)


def _ffi_mont_mul(a, b, n, B):
    _register()
    out = jax.ShapeDtypeStruct((a.shape[0], B), jnp.uint32)
    return jax.ffi.ffi_call(_TARGET, out)(a, b, n)


if __name__ == "__main__":
    print(build())
