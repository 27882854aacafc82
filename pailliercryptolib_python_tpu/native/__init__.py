"""Native (C) host-side helpers with transparent build + Python fallback.

The extension compiles on first import (plain cc, no pybind11 — see
sieve.c) into this directory; `setup.py build_ext` also builds it for
wheels.  Every entry point has a pure-Python fallback so the framework
works without a toolchain.
"""

from __future__ import annotations

import os
import subprocess
import sysconfig

_HERE = os.path.dirname(__file__)
_native = None


def _try_build():
    src = os.path.join(_HERE, "sieve.c")
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(_HERE, "_paillier_native" + suffix)
    try:
        src_mtime = os.path.getmtime(src)
    except OSError:
        # binary-only install (sieve.c absent): use the prebuilt .so
        return out if os.path.exists(out) else None
    if os.path.exists(out) and os.path.getmtime(out) >= src_mtime:
        return out
    include = sysconfig.get_paths()["include"]
    cc = os.environ.get("CC", "cc")
    # build beside the target and rename: processes that import the
    # package at the same time never load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cc, "-O3", "-shared", "-fPIC", f"-I{include}", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _native
    if _native is not None:
        return _native
    # rebuild first when sieve.c is newer than the prebuilt .so (cheap
    # mtime check) so a stale extension is never imported
    _try_build()
    try:
        from . import _paillier_native
        _native = _paillier_native
        return _native
    except ImportError:
        pass
    _native = False
    return _native


def sieve_window(base: int, count: int, primes) -> bytearray:
    """mask[i] == 1 iff base + 2i survives trial division by `primes`."""
    mod = _load()
    nb = max(1, (base.bit_length() + 7) // 8)
    if mod:
        return mod.sieve_window(base.to_bytes(nb, "little"), count,
                                tuple(primes))
    mask = bytearray(b"\x01" * count)
    for p in primes:
        if p <= 2:
            continue
        r = base % p
        j = ((p - r) * ((p + 1) // 2)) % p
        while j < count:
            if base + 2 * j != p:
                mask[j] = 0
            j += p
    return mask


def pack_limbs16(xs, num_limbs: int):
    """(num_limbs, len(xs)) uint32 limb array from Python ints, C-packed.

    The C fast path serializes each int directly into the limbs-major
    buffer (_PyLong_AsByteArray) — no intermediate Python bytes."""
    import numpy as np
    mod = _load()
    if mod and hasattr(mod, "pack_ints16"):
        if not isinstance(xs, (list, tuple)):
            xs = list(xs)
        raw = mod.pack_ints16(xs, num_limbs)
        return np.frombuffer(raw, dtype=np.uint32).reshape(num_limbs, len(xs))
    nbytes = num_limbs * 2
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    if mod:
        raw = mod.pack_limbs16(buf, len(xs), num_limbs)
        return np.frombuffer(raw, dtype=np.uint32).reshape(num_limbs, len(xs))
    out = np.frombuffer(buf, dtype="<u2").reshape(len(xs), num_limbs)
    return np.ascontiguousarray(out.T).astype(np.uint32)


def unpack_limbs16(arr) -> list:
    """List of Python ints from a (L, B) canonical uint32 limb array.
    C fast path (one pass); falls back to the numpy+from_bytes route."""
    import numpy as np
    mod = _load()
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    if mod and hasattr(mod, "unpack_ints16"):
        return mod.unpack_ints16(arr.tobytes(), arr.shape[1], arr.shape[0])
    rows = np.ascontiguousarray(arr.T).astype("<u2").tobytes()
    nb = arr.shape[0] * 2
    return [int.from_bytes(rows[i * nb:(i + 1) * nb], "little")
            for i in range(arr.shape[1])]


def decode_limbs16(arr, count: int, exps, n: int, max_int: int):
    """Fixed-point decode straight off the (L, B) canonical limb array
    (first `count` columns): one C pass doing sign classification,
    |mantissa| extraction and int/float conversion per element.
    Returns None when the C extension is unavailable (callers fall back
    to limb unpack + the scalar decode loop)."""
    import numpy as np
    if os.environ.get("PAILLIER_NO_C_DECODE") == "1":
        return None   # A/B switch for debugging host-decode issues
    mod = _load()
    if not mod or not hasattr(mod, "decode_limbs16"):
        return None
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    L, stride = arr.shape
    nb = L * 2
    e = np.ascontiguousarray(np.asarray(exps, dtype=np.int64))
    return mod.decode_limbs16(arr.tobytes(), count, stride, L, e.tobytes(),
                              n.to_bytes(nb, "little"),
                              max_int.to_bytes(nb, "little"),
                              (n - max_int).to_bytes(nb, "little"))


def extract_windows(buf: bytes, count: int, rbytes: int, window: int,
                    n_win: int):
    """(n_win, count) uint32 digit array: out[w, c] = bits
    [w*window, (w+1)*window) of row c in a (count, rbytes) byte buffer.
    Returns None when the C extension is unavailable (callers keep their
    vectorized numpy fallback)."""
    import numpy as np
    mod = _load()
    if mod and hasattr(mod, "extract_windows"):
        raw = mod.extract_windows(buf, count, rbytes, window, n_win)
        return np.frombuffer(raw, dtype=np.uint32).reshape(n_win, count)
    return None
