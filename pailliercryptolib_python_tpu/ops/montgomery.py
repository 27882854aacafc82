"""Batched Montgomery arithmetic over 16-bit-limb arrays.

The batched counterpart of the reference's hot kernel, the AVX512IFMA
multi-buffer modular exponentiation ``mbx_exp_mb8`` that
intel/pailliercryptolib calls: where the Xeon path is 8-way SIMD over
52-bit lanes, this path is B-way data-parallel over (L, B) limb arrays,
limbs-major so that consecutive batch columns sit side by side in memory.

Algorithm: CIOS (coarsely integrated operand scanning) Montgomery
multiplication with carry-save accumulators.  Each of the L iterations
does two (L, B) 32-bit multiplies and a handful of adds/shifts; carries
are only resolved once at the end with a data-parallel fixpoint pass.
Using Walter's bound (R > 4n, inputs < 2n => output < 2n) we never need a
conditional subtraction inside chains of modmuls — only when leaving the
Montgomery domain.

On the GPU the product runs as a CUDA kernel (ops/cuda_mont.py) that
returns the same limbs as the jnp version here; everything above the
product (exponentiation loops, tables, inversion) is plain lax.

Per-element moduli are supported (modulus shape (L, B) instead of (L, 1)),
which lets CRT decryption batch the mod-p^2 and mod-q^2 exponentiations in
a single call.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .limb import (
    LIMB_BITS,
    LIMB_MASK,
    LIMB_DTYPE,
    normalize,
    cond_sub,
    int_to_limbs,
    limbs_for_bits,
)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class MontCtx:
    """Montgomery context for a (batch of) odd modulus(es).

    Arrays are limb-major: shape (L, 1) for a modulus shared across the
    batch, or (L, B) for per-element moduli.
    """

    n_limbs: jnp.ndarray   # (L, 1) or (L, B) canonical limbs of n
    n0inv: jnp.ndarray     # (1,) or (B,): -n^{-1} mod 2^16
    r2: jnp.ndarray        # R^2 mod n  (to enter the Montgomery domain)
    one: jnp.ndarray       # R mod n    (Montgomery representation of 1)

    def tree_flatten(self):
        return (self.n_limbs, self.n0inv, self.r2, self.one), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def num_limbs(self) -> int:
        return self.n_limbs.shape[0]

    @classmethod
    def for_modulus(cls, n: int, min_bits: int | None = None) -> "MontCtx":
        """Build a shared-modulus context on the host (one-time per key).

        L is sized so R = 2^(16L) > 4n (two spare bits) — Walter's bound.
        """
        bits = max(n.bit_length() + 2, min_bits or 0)
        L = limbs_for_bits(bits)
        R = 1 << (LIMB_BITS * L)
        n0inv = (-pow(n, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        r2 = (R * R) % n
        one = R % n
        return cls(
            n_limbs=jnp.asarray(int_to_limbs(n, L)[:, None]),
            n0inv=jnp.asarray(np.array([n0inv], dtype=np.uint32)),
            r2=jnp.asarray(int_to_limbs(r2, L)[:, None]),
            one=jnp.asarray(int_to_limbs(one, L)[:, None]),
        )

    @classmethod
    def for_moduli(cls, ns: list, L: int) -> "MontCtx":
        """Per-element moduli context: ns is a list of B odd moduli."""
        B = len(ns)
        R = 1 << (LIMB_BITS * L)
        nl = np.empty((B, L), dtype=np.uint32)
        r2 = np.empty((B, L), dtype=np.uint32)
        one = np.empty((B, L), dtype=np.uint32)
        n0 = np.empty((B,), dtype=np.uint32)
        for i, n in enumerate(ns):
            if 4 * n >= R:
                raise ValueError("MontCtx.for_moduli: modulus too large for L")
            nl[i] = int_to_limbs(n, L)
            r2[i] = int_to_limbs((R * R) % n, L)
            one[i] = int_to_limbs(R % n, L)
            n0[i] = (-pow(n, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        return cls(
            n_limbs=jnp.asarray(np.ascontiguousarray(nl.T)),
            n0inv=jnp.asarray(n0),
            r2=jnp.asarray(np.ascontiguousarray(r2.T)),
            one=jnp.asarray(np.ascontiguousarray(one.T)),
        )


def platform() -> str:
    """The platform of JAX's default device: "gpu" or "cpu".

    Every kernel and engine choice reads this one query.  Raises when JAX
    reports no device, or a platform this package has no path for."""
    devices = jax.devices()
    if not devices:
        raise RuntimeError("JAX reports no device")
    kind = devices[0].platform
    if kind not in ("gpu", "cpu"):
        raise RuntimeError(f"unsupported JAX platform {kind!r}")
    return kind


def mont_mul(a: jnp.ndarray, b: jnp.ndarray, ctx: MontCtx) -> jnp.ndarray:
    """Montgomery product a*b*R^{-1} mod n, batched.

    a, b: (L, B) or (L, 1) canonical limbs, values < 2n.
    Returns (L, B) canonical limbs, value < 2n (no conditional subtract —
    Walter's bound keeps chains closed).  The CUDA kernel on the GPU,
    the jnp CIOS loop on the CPU; both return the same limbs.
    """
    if platform() == "gpu":
        from . import cuda_mont
        return cuda_mont.mont_mul(a, b, ctx.n_limbs)
    return _mont_mul_jnp(a, b, ctx)


@jax.jit
def _mont_mul_jnp(a: jnp.ndarray, b: jnp.ndarray, ctx: MontCtx) -> jnp.ndarray:
    L = a.shape[0]
    B = max(a.shape[1], b.shape[1], ctx.n_limbs.shape[1])
    a = jnp.broadcast_to(a, (L, a.shape[1])).astype(LIMB_DTYPE)
    b = jnp.broadcast_to(b, (L, B)).astype(LIMB_DTYPE)
    n = jnp.broadcast_to(ctx.n_limbs, (L, ctx.n_limbs.shape[1]))
    n0 = ctx.n0inv  # (1,) or (B,)

    t0 = jnp.zeros((L + 2, B), dtype=LIMB_DTYPE)

    def body(i, t):
        ai = lax.dynamic_slice_in_dim(a, i, 1, axis=0)  # (1, Ba)
        p = ai * b  # (L, B) exact 32-bit products of 16-bit limbs
        t = t.at[:L].add(p & LIMB_MASK)
        t = t.at[1:L + 1].add(p >> LIMB_BITS)
        m = ((t[0] & LIMB_MASK) * n0) & LIMB_MASK  # (B,)
        q = m[None, :] * n  # (L, B)
        t = t.at[:L].add(q & LIMB_MASK)
        t = t.at[1:L + 1].add(q >> LIMB_BITS)
        carry0 = t[0] >> LIMB_BITS  # t[0] is ≡ 0 mod 2^16 now
        t = jnp.concatenate([t[1:], jnp.zeros((1, B), dtype=LIMB_DTYPE)], axis=0)
        t = t.at[0].add(carry0)
        return t

    t = lax.fori_loop(0, L, body, t0)
    return normalize(t)[:L]


def mont_sqr(a: jnp.ndarray, ctx: MontCtx) -> jnp.ndarray:
    return mont_mul(a, a, ctx)


@jax.jit
def mont_reduce_wide(T: jnp.ndarray, ctx: MontCtx,
                     iters: int | None = None) -> jnp.ndarray:
    """Montgomery reduction of a wide value: T -> T*R^{-1} mod n, < 2n.

    T: (K, B) canonical limbs with value < n*R (K can exceed the modulus
    width L — e.g. a mod-n^2 ciphertext being reduced mod p^2).  This is
    how the framework reduces by a *smaller* modulus exactly; Barrett with
    limb-rounded k has an unbounded quotient error, REDC does not.

    iters: number of REDC limb steps (default L, the full R^{-1}); a
    SHORT reduction (iters=j) maps T -> T*2^{-16j} mod n and is enough
    when T is only a few limbs past the modulus: the L-limb result is
    valid iff the input value is < 2n * 2^(16j) (the matmul residue
    fold uses j=2 on inputs < n * 2^25 and folds 2^32 into its
    downstream constant).
    """
    L = ctx.num_limbs
    K = T.shape[0]
    B = max(T.shape[1], ctx.n_limbs.shape[1])
    n = jnp.broadcast_to(ctx.n_limbs, (L, ctx.n_limbs.shape[1]))
    n0 = ctx.n0inv
    W = max(K, L + 2)
    t = jnp.zeros((W, B), dtype=LIMB_DTYPE)
    t = lax.dynamic_update_slice_in_dim(t, jnp.broadcast_to(T, (K, B)), 0, axis=0)

    def body(_, t):
        m = ((t[0] & LIMB_MASK) * n0) & LIMB_MASK  # (B,)
        q = m[None, :] * n
        t = t.at[:L].add(q & LIMB_MASK)
        t = t.at[1:L + 1].add(q >> LIMB_BITS)
        carry0 = t[0] >> LIMB_BITS
        t = jnp.concatenate([t[1:], jnp.zeros((1, B), dtype=LIMB_DTYPE)], axis=0)
        t = t.at[0].add(carry0)
        return t

    t = lax.fori_loop(0, L if iters is None else iters, body, t)
    return normalize(t)[:L]


def to_mont(a: jnp.ndarray, ctx: MontCtx) -> jnp.ndarray:
    """Enter the Montgomery domain: a -> a*R mod n.  a canonical, < n."""
    return mont_mul(a, ctx.r2, ctx)


@jax.jit
def from_mont(a: jnp.ndarray, ctx: MontCtx) -> jnp.ndarray:
    """Leave the Montgomery domain and fully reduce: aR -> a mod n, < n."""
    L = a.shape[0]
    one_plain = jnp.zeros((L, 1), dtype=LIMB_DTYPE).at[0, 0].set(1)
    r = mont_mul(a, one_plain, ctx)
    return cond_sub(r, ctx.n_limbs)


def _gather_table_per_element(table: jnp.ndarray, dig: jnp.ndarray) -> jnp.ndarray:
    """table: (T, L, B); dig: (B,) per-element row index -> (L, B)."""
    return jnp.take_along_axis(table, dig[None, None, :].astype(jnp.int32), axis=0)[0]


def _build_window_table(base: jnp.ndarray, ctx: MontCtx, tsize: int,
                        B: int) -> jnp.ndarray:
    """T[d] = base^d (Montgomery), d in [0, tsize). (tsize, L, B)."""
    L = base.shape[0]
    one = jnp.broadcast_to(ctx.one, (L, B))
    entries = [one, jnp.broadcast_to(base, (L, B))]
    for _ in range(tsize - 2):
        entries.append(mont_mul(entries[-1], base, ctx))
    return jnp.stack(entries, axis=0)


@partial(jax.jit, static_argnames=("window",))
def mont_exp(base: jnp.ndarray, digits: jnp.ndarray, ctx: MontCtx,
                  window: int = 4, win_start=0) -> jnp.ndarray:
    """Fixed-window modular exponentiation, per-element base and exponent.

    base: (L, B) Montgomery-domain values (< 2n).
    digits: (n_win, B) uint32, MSB-first base-2^window digits of the
        exponents (all elements share the same digit count; zero-pad at
        the MSB side); (n_win, 1) shares one exponent across the batch.
    win_start: first window index to process (traced ok).  Callers pad
        `digits` to a canonical shape and pass win_start so one compiled
        kernel serves every exponent bit-length — skipped leading windows
        cost nothing.
    Returns base^e in Montgomery domain, (L, B).

    The batched analog of the reference backend's multi-buffer modexp
    (mbx_exp_mb8): the whole batch advances through the same windows in
    lockstep, each step = `window` squarings + one table-gather + one
    modmul.
    """
    L, _ = base.shape
    B = max(base.shape[1], ctx.n_limbs.shape[1], digits.shape[1])
    digits = jnp.broadcast_to(digits, (digits.shape[0], B))
    n_win = digits.shape[0]
    table = _build_window_table(base, ctx, 1 << window, B)

    def body(j, acc):
        for _ in range(window):
            acc = mont_mul(acc, acc, ctx)
        dig = lax.dynamic_slice_in_dim(digits, j, 1, axis=0)[0]  # (B,)
        return mont_mul(acc, _gather_table_per_element(table, dig), ctx)

    # acc starts at 1; the first processed window squares 1 (no-op) then
    # multiplies in its digit, so no special-casing of window 0 is needed.
    acc0 = jnp.broadcast_to(ctx.one, (L, B))
    return lax.fori_loop(win_start, n_win, body, acc0)


def _shr1(w: jnp.ndarray) -> jnp.ndarray:
    """Whole-number right shift by one bit on canonical limbs."""
    hi = jnp.concatenate([w[1:] & 1, jnp.zeros((1, w.shape[1]),
                                               dtype=LIMB_DTYPE)], axis=0)
    return (w >> 1) | (hi << (LIMB_BITS - 1))


@jax.jit
def mont_inv(x_mont: jnp.ndarray, ctx: MontCtx) -> jnp.ndarray:
    """Batched modular inverse of Montgomery residues, fully on device.

    Binary extended GCD with data-parallel branch selection (jnp.where):
    a fixed 2*bits(m)+4 iterations suffice since bitlen(a)+bitlen(b)
    drops every round.  Invariants a ≡ u*X, b ≡ v*X (mod m) with
    X = x*R the canonical residue value; at the end b = gcd = 1 so
    v = X^{-1} = x^{-1}R^{-1}, and two Montgomery products by R^2 map it
    back to Montgomery form (x^{-1}R).

    Replaces the reference's host-side per-element gmpy2.invert
    (ipcl_python.py:272-276) in the negative-plaintext ct*pt rewrite.
    Requires gcd(x, m) == 1 (ciphertexts are units mod n^2).
    """
    from .limb import sub_mod_base, compare_ge

    L = ctx.num_limbs
    B = max(x_mont.shape[1], ctx.n_limbs.shape[1])
    m = jnp.broadcast_to(ctx.n_limbs, (L, B))
    a0 = cond_sub(jnp.broadcast_to(x_mont, (L, B)), m)     # < m
    b0 = m
    u0 = jnp.zeros((L, B), dtype=LIMB_DTYPE).at[0].set(1)
    v0 = jnp.zeros((L, B), dtype=LIMB_DTYPE)

    def half_mod(w):
        """w/2 mod m for w < m: even -> w>>1, odd -> (w+m)>>1 (carry out of
        the top limb cannot occur: w+m < 2m < 2^(16L) by Walter slack)."""
        odd = (w[0:1] & 1) == 1
        wm = normalize(w + m)
        return _shr1(jnp.where(odd, wm, w))

    def sub_mod_m(p, q):
        """(p - q) mod m for p, q < m, compare-free: p + (m-q), cond-sub."""
        t = normalize(p + sub_mod_base(m, q))
        return cond_sub(t, m)

    def body(_, carry):
        a, b, u, v = carry
        a_odd = (a[0:1] & 1) == 1                          # (1, B)
        lt = jnp.logical_not(compare_ge(a, b))[None, :]    # a < b
        # odd path operands (swap so the subtraction stays non-negative)
        na = jnp.where(lt, b, a)
        nb = jnp.where(lt, a, b)
        nu = jnp.where(lt, v, u)
        nv = jnp.where(lt, u, v)
        a_odd_next = _shr1(sub_mod_base(na, nb))
        u_odd_next = half_mod(sub_mod_m(nu, nv))
        # even path
        a_even_next = _shr1(a)
        u_even_next = half_mod(u)
        a_n = jnp.where(a_odd, a_odd_next, a_even_next)
        u_n = jnp.where(a_odd, u_odd_next, u_even_next)
        b_n = jnp.where(a_odd, nb, b)
        v_n = jnp.where(a_odd, nv, v)
        # freeze once a == 0 (b holds gcd, v the inverse)
        done = jnp.all(a == 0, axis=0)[None, :]
        a_n = jnp.where(done, a, a_n)
        b_n = jnp.where(done, b, b_n)
        u_n = jnp.where(done, u, u_n)
        v_n = jnp.where(done, v, v_n)
        return a_n, b_n, u_n, v_n

    iters = 2 * LIMB_BITS * L + 4
    _, _, _, v = lax.fori_loop(0, iters, body, (a0, b0, u0, v0))
    # v = x^{-1} R^{-1} mod m -> canonical x^{-1} -> Montgomery x^{-1} R.
    inv_plain = mont_mul(v, ctx.r2, ctx)
    return mont_mul(inv_plain, ctx.r2, ctx)


@jax.jit
def _inv_tree_up(x_mont: jnp.ndarray, ctx: MontCtx):
    """Pairwise Montgomery product tree (up-sweep); returns all levels."""
    L, B = x_mont.shape
    levels = [x_mont]
    cur = x_mont
    while cur.shape[1] > 1:
        cur = mont_mul(cur[:, 0::2], cur[:, 1::2], ctx)
        levels.append(cur)
    return tuple(levels)


@jax.jit
def _inv_tree_down(levels, inv_root: jnp.ndarray, ctx: MontCtx):
    """Down-sweep: inv(left) = inv(parent)*right and vice versa."""
    inv = inv_root
    for lvl in levels[-2::-1]:
        L = lvl.shape[0]
        left, right = lvl[:, 0::2], lvl[:, 1::2]
        inv_left = mont_mul(inv, right, ctx)
        inv_right = mont_mul(inv, left, ctx)
        inv = jnp.stack([inv_left, inv_right], axis=2).reshape(
            L, lvl.shape[1])
    return inv


def mont_inv_tree_hostroot(x_mont: jnp.ndarray, ctx: MontCtx,
                           m_int: int) -> jnp.ndarray:
    """Batched inverse via product tree with the ROOT inverted on host.

    The single root inversion is a 1-element bigint op — CPython's
    extended Euclid runs it in ~1 ms where the device's fixed-iteration
    xgcd loop takes ~100+ ms (same reasoning as the host-built comb
    ladder).  Everything batched stays on device.  Requires every column
    to be a unit mod m (callers pad with ctx.one).
    """
    from .limb import limbs_to_int

    L, B = x_mont.shape
    P2 = 1 << max(0, (B - 1).bit_length())
    x = x_mont
    if P2 != B:
        x = jnp.concatenate(
            [x, jnp.broadcast_to(ctx.one, (L, P2 - B))], axis=1)
    levels = _inv_tree_up(x, ctx)
    # root is the Montgomery rep of the product P: r = P*R (mod m), < 2m
    r = limbs_to_int(np.asarray(levels[-1][:, 0])) % m_int
    R = 1 << (LIMB_BITS * L)
    # rep(P^-1) = P^-1 * R = r^-1 * R^2 (mod m)
    inv_rep = pow(r, -1, m_int) * (R * R % m_int) % m_int
    inv0 = jnp.asarray(int_to_limbs(inv_rep, L)[:, None])
    return _inv_tree_down(levels, inv0, ctx)[:, :B]


@jax.jit
def mont_inv_tree(x_mont: jnp.ndarray, ctx: MontCtx) -> jnp.ndarray:
    """Batched modular inverse via Montgomery's product-tree trick.

    The fixed-iteration xgcd in :func:`mont_inv` costs ~2*bits(m)
    iterations over the FULL (L, B) batch — ~1.1 s warm at 2048-bit/B=1024
    (the round-1 negative-plaintext cliff).  Montgomery's classic batch
    inversion replaces it with ONE single-column inversion plus O(B)
    modmuls arranged as a log2(B)-level pairwise product tree:

        up-sweep:   P[l] = pairwise Montgomery products of P[l-1]
        root:       inv(root) by the xgcd — on a (L, 1) column, so the
                    8k-iteration loop runs over tiny arrays
        down-sweep: inv(left) = inv(parent) * right (and vice versa)

    Every input column must be a unit mod m (ciphertexts are; callers pad
    with ctx.one).  Matches the role of the reference's per-element host
    gmpy2.invert (/root/reference/src/ipcl_python/ipcl_python.py:272-276).
    """
    L, B = x_mont.shape
    P2 = 1 << max(0, (B - 1).bit_length())
    x = x_mont
    if P2 != B:
        x = jnp.concatenate(
            [x, jnp.broadcast_to(ctx.one, (L, P2 - B))], axis=1)
    levels = [x]
    cur = x
    while cur.shape[1] > 1:
        cur = mont_mul(cur[:, 0::2], cur[:, 1::2], ctx)
        levels.append(cur)
    inv = mont_inv(levels[-1], ctx)                  # (L, 1)
    for lvl in levels[-2::-1]:
        left, right = lvl[:, 0::2], lvl[:, 1::2]
        inv_left = mont_mul(inv, right, ctx)
        inv_right = mont_mul(inv, left, ctx)
        inv = jnp.stack([inv_left, inv_right], axis=2).reshape(
            L, lvl.shape[1])
    return inv[:, :B]


# ---------------------------------------------------------------------------
# Fixed-base comb exponentiation — the encrypt fast path.
#
# The DJN obfuscator hs^r (reference: external ipcl PublicKey::encrypt with
# make_secure=True; surfaced at /root/reference/src/ipcl_python/
# ipcl_python.py:108-147) exponentiates a base that is FIXED per key.  We
# precompute T[j][d] = hs^(d * 2^(w*j)) once per key; an encryption then
# costs only n_win modmuls and ZERO squarings.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("nbits",))
def build_pow2_ladder(base_mont: jnp.ndarray, ctx: MontCtx, nbits: int) -> jnp.ndarray:
    """P[t] = base^(2^t) (Montgomery), t in [0, nbits). Returns (nbits, L, 1)."""

    def body(t, carry):
        ladder, cur = carry
        ladder = lax.dynamic_update_slice_in_dim(ladder, cur[None], t, axis=0)
        return ladder, mont_mul(cur, cur, ctx)

    L = base_mont.shape[0]
    ladder0 = jnp.zeros((nbits, L, base_mont.shape[1]), dtype=LIMB_DTYPE)
    ladder, _ = lax.fori_loop(0, nbits, body, (ladder0, base_mont))
    return ladder


@partial(jax.jit, static_argnames=("window",))
def _comb_chunk(lad: jnp.ndarray, ctx: MontCtx, j_idx: jnp.ndarray,
                d_idx: jnp.ndarray, window: int) -> jnp.ndarray:
    """One fixed-width slice of the comb build: entries (j_idx, d_idx)
    as `window` batched modmuls over (L, C) lanes."""
    nbits, L = lad.shape
    acc = jnp.broadcast_to(ctx.one, (L, j_idx.shape[0]))
    for s in range(window):
        bit_set = (d_idx >> s) & 1                    # (C,)
        src = jnp.clip(window * j_idx + s, 0, nbits - 1)
        factor = lad[src].T                           # (L, C)
        prod = mont_mul(acc, factor, ctx)
        acc = jnp.where((bit_set == 1)[None, :], prod, acc)
    return acc


# Lane width of one comb-build program: the n_win * 2^w entries (352k at
# 2048-bit/w=12) stream through one fixed-shape program, compiled once,
# instead of one program as wide as the whole table.
COMB_CHUNK_LANES = 32768


def build_comb_table(ladder: jnp.ndarray, ctx: MontCtx,
                     window: int) -> jnp.ndarray:
    """Comb table T[j, d] = base^(d * 2^(window*j)) from the pow2 ladder.

    ladder: (nbits, L, 1).  Returns (n_win, L, 2^window) — entries in the
    lane axis so per-element selection is a lane gather.  Built with
    `window` batched modmuls per fixed-width lane chunk (one compiled
    program reused across chunks).
    """
    nbits, L, _ = ladder.shape
    n_win = -(-nbits // window)
    tsize = 1 << window
    NE = n_win * tsize

    # entry e = (j, d): value = prod over set bits s of d: ladder[w*j + s]
    j_np = np.repeat(np.arange(n_win, dtype=np.int32), tsize)   # (NE,)
    d_np = np.tile(np.arange(tsize, dtype=np.int32), n_win)     # (NE,)
    lad = ladder[:, :, 0]  # (nbits, L)

    CH = COMB_CHUNK_LANES
    if NE <= CH:
        acc = _comb_chunk(lad, ctx, jnp.asarray(j_np), jnp.asarray(d_np),
                          window)
    else:
        outs = []
        for c0 in range(0, NE, CH):
            c1 = min(NE, c0 + CH)
            jc = np.zeros(CH, dtype=np.int32)
            dc = np.zeros(CH, dtype=np.int32)
            jc[:c1 - c0] = j_np[c0:c1]
            dc[:c1 - c0] = d_np[c0:c1]
            outs.append(_comb_chunk(lad, ctx, jnp.asarray(jc),
                                    jnp.asarray(dc), window)[:, :c1 - c0])
        acc = jnp.concatenate(outs, axis=1)
    # (L, NE) -> (n_win, L, tsize)
    return acc.reshape(L, n_win, tsize).transpose(1, 0, 2)


@jax.jit
def mont_exp_fixed_base(comb_table: jnp.ndarray, digits: jnp.ndarray,
                        ctx: MontCtx, acc0: jnp.ndarray | None = None) -> jnp.ndarray:
    """prod_j T[j][digits[j]] — fixed-base exponentiation, no squarings.

    comb_table: (n_win, L, 2^w); digits: (n_win, B) LSB-window-first or any
    order matching the table's j indexing.  acc0: optional (L, B) Montgomery
    value to fold the product into (saves one modmul for encrypt).
    """
    n_win, L, tsize = comb_table.shape
    B = digits.shape[1]

    def gather(j, dig):
        slab = lax.dynamic_index_in_dim(comb_table, j, axis=0, keepdims=False)
        # slab: (L, tsize); dig: (B,) -> (L, B) lane gather
        return jnp.take(slab, dig.astype(jnp.int32), axis=1)

    start = 0
    if acc0 is None:
        acc0 = gather(0, digits[0])
        start = 1

    def body(j, acc):
        dig = lax.dynamic_slice_in_dim(digits, j, 1, axis=0)[0]
        return mont_mul(acc, gather(j, dig), ctx)

    return lax.fori_loop(start, n_win, body, acc0)


# ---------------------------------------------------------------------------
# Host helpers for exponent digit extraction.
# ---------------------------------------------------------------------------

def exponent_digits(exps, n_win: int, window: int,
                    msb_first: bool = True) -> np.ndarray:
    """Base-2^window digits of Python-int exponents -> (n_win, B) uint32.

    Vectorized through one bytes buffer: window 4/8 reinterpret the
    buffer directly; other windows <= 16 go through the C extension's
    bit-window extractor (native.extract_windows — the RNS chains use
    windows 3/5).  Per-digit Python loop only as a last resort."""
    # Mask to the digit span: the pure-Python fallback silently truncates
    # to n_win digits, so the bytes paths must agree (and to_bytes would
    # raise OverflowError on wider-than-span exponents).
    emask = (1 << (n_win * window)) - 1
    if window not in (4, 8):
        B = len(exps)
        if window <= 16:
            from .. import native
            rbytes = -(-n_win * window // 8) + 4
            buf = b"".join((int(e) & emask).to_bytes(rbytes, "little")
                           for e in exps)
            digs = native.extract_windows(buf, B, rbytes, window, n_win)
            if digs is not None:
                digs = np.ascontiguousarray(digs.astype(np.uint32))
                if msb_first:
                    digs = np.ascontiguousarray(digs[::-1])
                return digs
        out = np.zeros((n_win, B), dtype=np.uint32)
        mask = (1 << window) - 1
        for b, e in enumerate(exps):
            e = int(e)
            for j in range(n_win):
                out[j, b] = (e >> (window * j)) & mask
        if msb_first:
            out = out[::-1]
        return np.ascontiguousarray(out)

    nbytes = -(-n_win * window // 8)
    buf = b"".join((int(e) & emask).to_bytes(nbytes, "little")
                   for e in exps)
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(len(exps), nbytes)
    if window == 8:
        digs = arr[:, :n_win]
    else:
        nib = np.empty((len(exps), nbytes * 2), dtype=np.uint8)
        nib[:, 0::2] = arr & 0xF
        nib[:, 1::2] = arr >> 4
        digs = nib[:, :n_win]
    digs = np.ascontiguousarray(digs.T).astype(np.uint32)   # LSB-first
    if msb_first:
        digs = np.ascontiguousarray(digs[::-1])
    return digs
