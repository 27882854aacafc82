"""Limb-array bignum core for the batched Paillier framework.

A big number is a little-endian array of 16-bit limbs stored in ``uint32``
words.  A *batch* of big numbers is a single ``uint32[L, B]`` array —
limbs-major, so consecutive batch columns are adjacent in memory.
This replaces the reference's opaque per-element C++ ``BigNumber``
containers (see /root/reference/bindings/ipcl_bindings_classes.cpp:380-491
and the byte contract of BNUtils, /root/reference/src/ipcl_python/
ipcl_python.py:933-977) with one dense array the XLA compiler can tile.

Why 16-bit limbs in uint32 words: a product of two 16-bit limbs is exact
in a 32-bit integer multiply, which every XLA backend has, and partial products
can be accumulated in carry-save (redundant) form for hundreds of steps
before any carry propagation is needed.  All carry propagation is deferred
and done with a data-parallel fixpoint loop, never a serial scan.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

LIMB_BITS = 16
LIMB_MASK = 0xFFFF
LIMB_BASE = 1 << LIMB_BITS
LIMB_DTYPE = jnp.uint32


# ---------------------------------------------------------------------------
# Host-side converters (Python int <-> limb arrays).
# ---------------------------------------------------------------------------

def limbs_for_bits(bits: int) -> int:
    """Number of 16-bit limbs needed to hold `bits` bits."""
    return -(-bits // LIMB_BITS)


def int_to_limbs(x: int, num_limbs: int) -> np.ndarray:
    """Convert a non-negative Python int to a (num_limbs,) uint32 limb array."""
    if x < 0:
        raise ValueError("int_to_limbs: negative value")
    b = int(x).to_bytes(num_limbs * 2, byteorder="little")
    return np.frombuffer(b, dtype="<u2").astype(np.uint32)


def limbs_to_int(a: np.ndarray) -> int:
    """Convert a (L,) limb array (canonical or redundant uint32) to int."""
    a = np.asarray(a, dtype=np.uint64)
    val = 0
    for k in range(a.shape[0] - 1, -1, -1):
        val = (val << LIMB_BITS) + int(a[k])
    return val


def ints_to_limbs(xs, num_limbs: int) -> np.ndarray:
    """Convert a sequence of B ints to a (num_limbs, B) uint32 array.

    Uses the native C packer when available (one pass, limbs-major)."""
    from .. import native
    return native.pack_limbs16(xs, num_limbs)


def limbs_to_ints(arr) -> list:
    """Convert a (L, B) limb array to a list of B Python ints."""
    from .. import native
    arr = np.asarray(arr)
    if arr.size and arr.max() <= LIMB_MASK:
        # canonical fast path: single C pass over the limbs-major buffer
        return native.unpack_limbs16(arr)
    a16 = arr.astype(np.uint64)
    return [limbs_to_int(a16[:, b]) for b in range(arr.shape[1])]


# ---------------------------------------------------------------------------
# Device-side primitives.  All operate on uint32[L, B] (or broadcastable
# (L, 1)) limb arrays.  "Canonical" means every limb < 2**16; "redundant"
# means limbs may hold up to 32-bit partial sums awaiting carry propagation.
# ---------------------------------------------------------------------------

@jax.jit
def normalize(t: jnp.ndarray) -> jnp.ndarray:
    """Carry-propagate a redundant limb array to canonical (<2^16) limbs.

    Deterministic two-phase propagation (no data-dependent loop, so it
    compiles to a fixed sequence of elementwise passes):

    1. one local pass: v_k = (t_k & 0xFFFF) + (t_{k-1} >> 16).  Since both
       terms are <= 0xFFFF, v_k < 2^17, so at most ONE carry bit remains
       per position;
    2. Kogge-Stone carry-lookahead over (generate, propagate) bits in
       log2(K) steps: g_k = v_k >> 16, p_k = (v_k & 0xFFFF == 0xFFFF);
       after the prefix scan G_k says a carry exits position k, so
       carry-in_k = G_{k-1} and out = (v + carry_in) & 0xFFFF.

    Any carry out of the top limb is discarded (arithmetic mod 2^(16L)) —
    callers size L so this never triggers for in-range values.
    """
    K = t.shape[0]

    def shift_down(x, d):
        return jnp.concatenate(
            [jnp.zeros((d,) + x.shape[1:], dtype=x.dtype), x[:-d]], axis=0)

    c = t >> LIMB_BITS
    v = (t & LIMB_MASK) + shift_down(c, 1)
    r = v & LIMB_MASK
    G = (v >> LIMB_BITS).astype(LIMB_DTYPE)          # in {0, 1}
    P = (r == LIMB_MASK).astype(LIMB_DTYPE)
    d = 1
    while d < K:
        G = G | (P & shift_down(G, d))
        P = P & shift_down(P, d)
        d <<= 1
    carry_in = shift_down(G, 1)
    return (r + carry_in) & LIMB_MASK


@jax.jit
def compare_ge(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Lexicographic a >= b for canonical limb arrays. Returns bool[B]."""
    a, b = jnp.broadcast_arrays(a, b)
    neq = a != b
    # Index of the most significant differing limb.
    rev = neq[::-1]
    idx = a.shape[0] - 1 - jnp.argmax(rev, axis=0)  # (B,)
    av = jnp.take_along_axis(a, idx[None, :], axis=0)[0]
    bv = jnp.take_along_axis(b, idx[None, :], axis=0)[0]
    return jnp.where(jnp.any(neq, axis=0), av >= bv, True)


@jax.jit
def sub_mod_base(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(a - b) mod 2^(16L) for canonical inputs; canonical output.

    Implemented borrow-free: a + (2^(16L) - 1 - b) + 1 in redundant form,
    then one carry pass; the final carry out of the top limb is discarded.
    """
    a, b = jnp.broadcast_arrays(a, b)
    nb = (LIMB_MASK - b).astype(LIMB_DTYPE)
    t = a + nb
    t = t.at[0].add(1)
    return normalize(t)


@jax.jit
def cond_sub(a: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Where a >= m (canonical limbs), return a - m, else a."""
    ge = compare_ge(a, m)
    d = sub_mod_base(a, jnp.broadcast_to(m, a.shape))
    return jnp.where(ge[None, :], d, a)


@jax.jit
def big_add(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Canonical a + b (same length; carry out of top limb dropped)."""
    return normalize(a + b)


@partial(jax.jit, static_argnames=("out_limbs",))
def big_mul(a: jnp.ndarray, b: jnp.ndarray, out_limbs: int | None = None):
    """Full product of canonical limb arrays.

    a: (La, B) or (La, 1); b: (Lb, B) or (Lb, 1).  Returns canonical
    (out_limbs, B) array, default out_limbs = La + Lb.  Schoolbook
    convolution: La data-parallel steps, each a (Lb, B) 32-bit multiply
    with carry-save accumulation into 32-bit accumulators (exact: each
    accumulator gains < 2^17 per step, so up to ~2^14 steps are safe).
    """
    La = a.shape[0]
    Lb = b.shape[0]
    B = max(a.shape[1], b.shape[1])
    if out_limbs is None:
        out_limbs = La + Lb
    a = jnp.broadcast_to(a, (La, B))
    b = jnp.broadcast_to(b, (Lb, B))
    kmax = min(La, out_limbs)
    # dynamic_update_slice clamps start indices; pad the accumulator so the
    # last iteration's (hi at offset i+1, length Lb) write never clamps.
    acc_len = max(out_limbs + 1, kmax + Lb + 1)
    acc = jnp.zeros((acc_len, B), dtype=LIMB_DTYPE)

    def body(i, acc):
        ai = lax.dynamic_slice_in_dim(a, i, 1, axis=0)  # (1, B)
        p = ai * b  # (Lb, B) exact 32-bit products
        lo = p & LIMB_MASK
        hi = p >> LIMB_BITS
        # add lo at offset i, hi at offset i+1; clip to out_limbs
        upd = jnp.zeros_like(acc)
        upd = lax.dynamic_update_slice_in_dim(upd, lo, i, axis=0)
        acc = acc + upd
        upd2 = jnp.zeros_like(acc)
        upd2 = lax.dynamic_update_slice_in_dim(upd2, hi, i + 1, axis=0)
        acc = acc + upd2
        return acc

    acc = lax.fori_loop(0, kmax, body, acc)
    acc = normalize(acc)
    return acc[:out_limbs]


def big_mul_low(a: jnp.ndarray, b: jnp.ndarray, out_limbs: int) -> jnp.ndarray:
    """Low `out_limbs` limbs of a*b, i.e. a*b mod 2^(16*out_limbs)."""
    return big_mul(a, b, out_limbs=out_limbs)
