"""Oracle ladder for the RNS-Montgomery engine (ops/rns.py).

Every level is validated against Python-int arithmetic: channel
primitives -> one RNS-Montgomery product (exact value reconstructed by
CRT over ALL channels, so base-extension offsets are visible) -> chained
products (bound closure) -> enter/exit -> full shared-exponent modexp
against pow().  docs/RNS_DESIGN.md is the design; a wrong SK offset or
extension constant shows up here as a wrong CRT value, not just a wrong
residue.
"""

import random

import numpy as np
import pytest
import jax.numpy as jnp

from pailliercryptolib_python_tpu.ops import rns
from pailliercryptolib_python_tpu.ops import montgomery as mg
from pailliercryptolib_python_tpu.ops.limb import (
    ints_to_limbs, LIMB_BITS)

rng = random.Random(4242)


def _all_mods(base):
    return list(base.mods_B_int) + list(base.mods_Bp_int) + [base.m_r]


def state_from_ints(xs, base):
    """Exact channel-Montgomery RNS states for a list of values."""
    mods = _all_mods(base)
    arr = np.zeros((base.CH, len(xs)), dtype=np.uint32)
    for c, m in enumerate(mods):
        for b, x in enumerate(xs):
            arr[c, b] = (x % m) * (1 << 16) % m
    return jnp.asarray(arr)


def ints_from_state(X, base):
    """Exact values via CRT over ALL channels (unique below M*M'*m_r)."""
    mods = _all_mods(base)
    P = 1
    for m in mods:
        P *= m
    X = np.asarray(X)
    out = []
    for b in range(X.shape[1]):
        acc = 0
        for c, m in enumerate(mods):
            res = int(X[c, b]) * pow(1 << 16, -1, m) % m
            Pi = P // m
            acc = (acc + res * Pi * pow(Pi % m, -1, m)) % P
        out.append(acc)
    return out


def test_channel_primitives():
    base = rns.RnsBase.for_bits(256)
    mods = _all_mods(base)
    CH = base.CH
    a = np.array([[rng.randrange(m) for _ in range(8)] for m in mods],
                 dtype=np.uint32)
    b = np.array([[rng.randrange(m) for _ in range(8)] for m in mods],
                 dtype=np.uint32)
    got = np.asarray(rns._cmul(jnp.asarray(a), jnp.asarray(b),
                               base.mods, base.n0))
    for c, m in enumerate(mods):
        inv16 = pow(1 << 16, -1, m)
        for j in range(8):
            assert got[c, j] == int(a[c, j]) * int(b[c, j]) * inv16 % m
    # _redc on arbitrary uint32 values
    t = np.array([[rng.randrange(1 << 32) for _ in range(8)]
                  for _ in range(CH)], dtype=np.uint32)
    got = np.asarray(rns._redc(jnp.asarray(t), base.mods, base.n0))
    for c, m in enumerate(mods):
        inv16 = pow(1 << 16, -1, m)
        for j in range(8):
            assert got[c, j] == int(t[c, j]) * inv16 % m
            assert got[c, j] < m


@pytest.mark.parametrize("mbits", [256, 512])
def test_mont_mul_value_and_bound(mbits):
    base = rns.RnsBase.for_bits(mbits)
    m = 0
    while m.bit_length() != mbits:
        m = rng.getrandbits(mbits) | 1 | (1 << (mbits - 1))
    key = rns.RnsModulus.build(base, m, (mbits + 2 + 15) // 16)
    k = base.k
    Minv = pow(base.M % m, -1, m)
    xs = [rng.randrange(m) for _ in range(6)] + [0, 1]
    ys = [rng.randrange(m) for _ in range(6)] + [m - 1, 1]
    X = state_from_ints(xs, base)
    Y = state_from_ints(ys, base)
    Z = rns.rns_mont_mul(X, Y, base, key)
    vals = ints_from_state(Z, base)
    for x, y, v in zip(xs, ys, vals):
        assert v % m == x * y * Minv % m, "congruence"
        assert v < (k + 2) * m, "bound closure"


def test_mont_mul_chain_stays_closed():
    """50 chained squarings: outputs feed back in; the value bound and
    the congruence must hold at every step (offset accumulation shows
    up here if the SK correction or the fast-extension slack is wrong)."""
    mbits = 256
    base = rns.RnsBase.for_bits(mbits)
    m = 0
    while m.bit_length() != mbits:
        m = rng.getrandbits(mbits) | 1 | (1 << (mbits - 1))
    key = rns.RnsModulus.build(base, m, (mbits + 2 + 15) // 16)
    k = base.k
    Minv = pow(base.M % m, -1, m)
    x = rng.randrange(m)
    X = state_from_ints([x], base)
    expect = x
    for i in range(50):
        X = rns.rns_mont_mul(X, X, base, key)
        expect = expect * expect * Minv % m
        v = ints_from_state(X, base)[0]
        assert v % m == expect, f"step {i}"
        assert v < (k + 2) * m, f"bound step {i}"


def test_enter_exit_roundtrip():
    mbits = 256
    base = rns.RnsBase.for_bits(mbits)
    from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints
    kd = fixed_key_ints(256)
    m = kd["p"] * kd["p"]
    L = (m.bit_length() + 2 + 15) // 16
    sq_ctx = mg.MontCtx.for_modulus(m, min_bits=LIMB_BITS * L)
    L = sq_ctx.num_limbs
    key = rns.RnsModulus.build(base, m, L)
    R = 1 << (LIMB_BITS * L)
    cs = [rng.randrange(m) for _ in range(7)] + [1]
    v = [c * R % m for c in cs]                 # Montgomery-limb form
    v_limbs = jnp.asarray(ints_to_limbs(v, L))
    X = rns.rns_enter(v_limbs, base, key)
    vals = ints_from_state(X, base)
    for c, val in zip(cs, vals):
        assert val % m == c * base.M % m, "enter congruence"
        assert val < (base.k + 2) * m, "enter bound"
    out = np.asarray(rns.rns_exit(X, base, key, sq_ctx, L))
    from pailliercryptolib_python_tpu.ops.limb import limbs_to_ints
    got = limbs_to_ints(out)
    for c, g in zip(cs, got):
        assert g == c, "exit exact value"


@pytest.mark.parametrize("ebits", [64, 200])
def test_exp_shared_oracle(ebits):
    mbits = 256
    base = rns.RnsBase.for_bits(mbits)
    from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints
    kd = fixed_key_ints(256)
    m = kd["q"] * kd["q"]
    L = (m.bit_length() + 2 + 15) // 16
    sq_ctx = mg.MontCtx.for_modulus(m, min_bits=LIMB_BITS * L)
    L = sq_ctx.num_limbs
    key = rns.RnsModulus.build(base, m, L)
    R = 1 << (LIMB_BITS * L)
    e = rng.getrandbits(ebits) | (1 << (ebits - 1))
    window = 4
    n_win = -(-ebits // window)
    digits = jnp.asarray(mg.exponent_digits([e], n_win, window)[:, 0])
    cs = [rng.randrange(m) for _ in range(8)]
    v_limbs = jnp.asarray(ints_to_limbs([c * R % m for c in cs], L))
    out = np.asarray(rns.rns_crt_exp_half(v_limbs, digits, base, key,
                                          sq_ctx, window, L))
    from pailliercryptolib_python_tpu.ops.limb import limbs_to_ints
    got = limbs_to_ints(out)
    for c, g in zip(cs, got):
        assert g == pow(c, e, m), "modexp oracle"


def test_rns_programs_key_independent_hlo():
    """Two different keys of the same size must lower to IDENTICAL HLO
    for the heavy jitted RNS programs: every m-derived constant travels
    as a pytree child (runtime argument), never a baked literal.  This
    is what lets a fresh key hit the persistent compilation cache
    instead of recompiling the multi-second programs (round-5 fix)."""
    import jax
    import jax.numpy as jnp
    from pailliercryptolib_python_tpu.models import paillier as sch
    from pailliercryptolib_python_tpu.ops import rns as _rns
    from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints

    kd = fixed_key_ints(256, enable_DJN=True)
    texts = []
    for seed in (2, 3):
        # same n (same shapes/base), different hs -> different ladder and
        # different RnsModulus constants for the SAME modulus size
        hs = pow(kd["hs"], seed, kd["n"] * kd["n"])
        pub = sch.PublicContext(kd["n"], kd["bits"], True, hs,
                                kd["randbits"])
        base, key = _rns.RnsBase.for_bits(
            -(-(2 * pub.bits + 2) // 16) * 16), None
        from pailliercryptolib_python_tpu.ops.rns import RnsModulus
        key = RnsModulus.build(base, pub.nsquare, pub.L)
        lad_pos = jnp.asarray(pub._host_pow2_ladder())[:, :, 0].T
        w = pub.comb_window
        n_win = -(-pub.randbits // w)
        low = sch._build_comb_rns.lower(
            lad_pos, base, key, w=w, n_win=n_win, randbits=pub.randbits)
        texts.append(low.as_text())
    assert texts[0] == texts[1], (
        "baked key-dependent constant in _build_comb_rns HLO")

    # the decrypt half chain: p-half vs q-half of one key must match too
    pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                            kd["randbits"])
    priv = sch.PrivateContext(pub, kd["p"], kd["q"])
    if priv.use_rns:
        ct = pub.encrypt([1, 2, 3, 4], apply_obfuscator=False)
        base_m = priv._stage_reduce(ct)
        B = ct.shape[1]
        lp = _rns.rns_crt_exp_half.lower(
            base_m[:, :B], priv.rdig_p, priv.rns_base, priv.rns_p,
            priv._sq_p, priv.rns_window, priv.Lh).as_text()
        lq = _rns.rns_crt_exp_half.lower(
            base_m[:, B:], priv.rdig_q, priv.rns_base, priv.rns_q,
            priv._sq_q, priv.rns_window, priv.Lh).as_text()
        assert lp == lq, "baked key-dependent constant in rns_crt_exp_half"


def test_residue_fold_limbs_oracle():
    """The MXU residue fold (CRT stage-1 primitive) must agree with
    Python bigint arithmetic: value(out) === value(in) (mod m) and
    out < m * 2^25, for wide inputs up to the mod-n^2 width."""
    import random
    import numpy as np
    import jax.numpy as jnp
    from pailliercryptolib_python_tpu.ops import rns as _rns
    from pailliercryptolib_python_tpu.ops.limb import (
        ints_to_limbs, limbs_to_ints, limbs_for_bits)

    r = random.Random(9)
    m = (r.getrandbits(509) | (1 << 508) | 1)
    Lh = limbs_for_bits(m.bit_length() + 2)
    K = 2 * Lh + 4                        # "mod-n^2 sized" input
    vals = [r.getrandbits(16 * K - 8) for _ in range(6)]
    T = jnp.asarray(ints_to_limbs(vals, K))
    C_lo, C_hi = _rns._residue_planes_np(m, Lh, K)
    out = _rns.residue_fold_limbs(T, jnp.asarray(C_lo), jnp.asarray(C_hi),
                                  Lh)
    got = limbs_to_ints(np.asarray(out))
    for v, g in zip(vals, got):
        assert g % m == v % m, "residue fold value mismatch"
        assert g < (m << 25), "residue fold bound"


def test_mont_reduce_wide_short_iters():
    """mont_reduce_wide(iters=j) maps T -> T * 2^-16j mod n, with the
    result < 2n whenever the input value is < 2n * 2^16j (the short-
    reduction precondition; stage 1 uses j=2 on inputs < n * 2^25)."""
    import random
    import numpy as np
    import jax.numpy as jnp
    from pailliercryptolib_python_tpu.ops import montgomery as mg
    from pailliercryptolib_python_tpu.ops.limb import (
        ints_to_limbs, limbs_to_ints, limbs_for_bits)

    r = random.Random(10)
    n = (r.getrandbits(250) | (1 << 249) | 1)
    L = limbs_for_bits(n.bit_length() + 2)
    ctx = mg.MontCtx.for_modulus(n, min_bits=16 * L)
    K = L + 2
    for j in (1, 2, 3):
        bits = min(16 * K - 8, n.bit_length() + 16 * j - 1)
        vals = [r.getrandbits(bits) for _ in range(5)]
        T = jnp.asarray(ints_to_limbs(vals, K))
        out = limbs_to_ints(np.asarray(mg.mont_reduce_wide(T, ctx,
                                                           iters=j)))
        inv = pow(1 << (16 * j), -1, n)
        for v, g in zip(vals, out):
            assert g % n == v * inv % n, f"short REDC iters={j}"
            assert g < 2 * n, f"short REDC bound iters={j}"


@pytest.mark.parametrize("ebits", [64, 200])
def test_exp_sched_oracle(ebits):
    """Sliding-window schedule chain (the production decrypt path) vs
    pow(): includes even exponents (trailing-zero squarings) and the
    front no-op padding that keeps schedule length key-independent."""
    mbits = 256
    base = rns.RnsBase.for_bits(mbits)
    from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints
    kd = fixed_key_ints(256)
    m = kd["q"] * kd["q"]
    L = (m.bit_length() + 2 + 15) // 16
    sq_ctx = mg.MontCtx.for_modulus(m, min_bits=LIMB_BITS * L)
    L = sq_ctx.num_limbs
    key = rns.RnsModulus.build(base, m, L)
    R = 1 << (LIMB_BITS * L)
    window = 5
    cs = [rng.randrange(m) for _ in range(8)]
    v_limbs = jnp.asarray(ints_to_limbs([c * R % m for c in cs], L))
    from pailliercryptolib_python_tpu.ops.limb import limbs_to_ints
    # a short exponent exercises heavy padding; an even one, tail squares
    for e in (rng.getrandbits(ebits) | (1 << (ebits - 1)),
              (rng.getrandbits(ebits - 8) | (1 << (ebits - 9))) << 4):
        sched = jnp.asarray(rns.sliding_schedule(e, window, ebits))
        assert sched.shape[0] == rns.sched_len(ebits, window)
        out = np.asarray(rns.rns_crt_exp_sched(v_limbs, sched, base, key,
                                               sq_ctx, window, L))
        got = limbs_to_ints(out)
        for c, g in zip(cs, got):
            assert g == pow(c, e, m), "sched modexp oracle"


def test_sched_key_independent_hlo():
    """rns_crt_exp_sched (the production stage-2 path) must lower to
    identical HLO for the p- and q-halves of a key."""
    from pailliercryptolib_python_tpu.models import paillier as sch
    from pailliercryptolib_python_tpu.ops import rns as _rns
    from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints

    kd = fixed_key_ints(256, enable_DJN=True)
    pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                            kd["randbits"])
    priv = sch.PrivateContext(pub, kd["p"], kd["q"])
    if not priv.use_rns:
        pytest.skip("rns engine disabled")
    ct = pub.encrypt([1, 2, 3, 4], apply_obfuscator=False)
    base_m = priv._stage_reduce(ct)
    B = ct.shape[1]
    lp = _rns.rns_crt_exp_sched.lower(
        base_m[:, :B], priv.rsched_p, priv.rns_base, priv.rns_p,
        priv._sq_p, priv.rns_sched_window, priv.Lh).as_text()
    lq = _rns.rns_crt_exp_sched.lower(
        base_m[:, B:], priv.rsched_q, priv.rns_base, priv.rns_q,
        priv._sq_q, priv.rns_sched_window, priv.Lh).as_text()
    assert lp == lq, "baked key-dependent constant in rns_crt_exp_sched"
