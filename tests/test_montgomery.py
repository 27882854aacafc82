"""Oracle tests for batched Montgomery arithmetic vs Python pow()."""

import random
from math import gcd as math_gcd

import numpy as np
import jax.numpy as jnp
import pytest

from pailliercryptolib_python_tpu.ops import limb, montgomery as mg


rng = random.Random(99)


def odd_modulus(bits):
    while True:
        n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        return n


def enter(xs, ctx):
    a = jnp.asarray(limb.ints_to_limbs(xs, ctx.num_limbs))
    return mg.to_mont(a, ctx)


def leave(a, ctx):
    return limb.limbs_to_ints(np.asarray(mg.from_mont(a, ctx)))


@pytest.mark.parametrize("bits", [64, 256, 1024])
def test_mont_roundtrip(bits):
    n = odd_modulus(bits)
    ctx = mg.MontCtx.for_modulus(n)
    xs = [rng.randrange(n) for _ in range(6)]
    assert leave(enter(xs, ctx), ctx) == xs


@pytest.mark.parametrize("bits", [64, 256, 1024])
def test_mont_mul(bits):
    n = odd_modulus(bits)
    ctx = mg.MontCtx.for_modulus(n)
    xs = [rng.randrange(n) for _ in range(6)]
    ys = [rng.randrange(n) for _ in range(6)]
    am, bm = enter(xs, ctx), enter(ys, ctx)
    got = leave(mg.mont_mul(am, bm, ctx), ctx)
    assert got == [(x * y) % n for x, y in zip(xs, ys)]


def test_mont_mul_chain_stays_bounded():
    # Walter's bound: long chains without conditional subtraction stay < 2n.
    n = odd_modulus(256)
    ctx = mg.MontCtx.for_modulus(n)
    xs = [rng.randrange(n) for _ in range(4)]
    a = enter(xs, ctx)
    acc = a
    expect = xs[:]
    for _ in range(25):
        acc = mg.mont_mul(acc, a, ctx)
        expect = [(e * x) % n for e, x in zip(expect, xs)]
    assert leave(acc, ctx) == expect


@pytest.mark.parametrize("window", [4, 8])
def test_mont_exp(window):
    n = odd_modulus(256)
    ctx = mg.MontCtx.for_modulus(n)
    xs = [rng.randrange(n) for _ in range(5)]
    es = [rng.getrandbits(96) for _ in range(5)]
    n_win = -(-96 // window)
    digits = jnp.asarray(mg.exponent_digits(es, n_win, window, msb_first=True))
    got = leave(mg.mont_exp(enter(xs, ctx), digits, ctx, window=window), ctx)
    assert got == [pow(x, e, n) for x, e in zip(xs, es)]


def test_mont_exp_zero_and_one_exponents():
    n = odd_modulus(128)
    ctx = mg.MontCtx.for_modulus(n)
    xs = [rng.randrange(n) for _ in range(3)]
    es = [0, 1, 2]
    digits = jnp.asarray(mg.exponent_digits(es, 4, 4, msb_first=True))
    got = leave(mg.mont_exp(enter(xs, ctx), digits, ctx, window=4), ctx)
    assert got == [pow(x, e, n) for x, e in zip(xs, es)]


def test_mont_exp_shared():
    n = odd_modulus(256)
    ctx = mg.MontCtx.for_modulus(n)
    xs = [rng.randrange(n) for _ in range(5)]
    e = rng.getrandbits(120)
    n_win = -(-120 // 4)
    digits = jnp.asarray(mg.exponent_digits([e], n_win, 4, msb_first=True))
    got = leave(mg.mont_exp(enter(xs, ctx), digits, ctx, window=4), ctx)
    assert got == [pow(x, e, n) for x in xs]


def test_per_element_moduli():
    ns = [odd_modulus(192) for _ in range(4)]
    L = limb.limbs_for_bits(192 + 2)
    ctx = mg.MontCtx.for_moduli(ns, L)
    xs = [rng.randrange(n) for n in ns]
    ys = [rng.randrange(n) for n in ns]
    am = mg.to_mont(jnp.asarray(limb.ints_to_limbs(xs, L)), ctx)
    bm = mg.to_mont(jnp.asarray(limb.ints_to_limbs(ys, L)), ctx)
    got = leave(mg.mont_mul(am, bm, ctx), ctx)
    assert got == [(x * y) % n for x, y, n in zip(xs, ys, ns)]
    # shared exponent across distinct moduli (the CRT decrypt pattern)
    e = rng.getrandbits(64)
    digits = jnp.asarray(mg.exponent_digits([e], 16, 4, msb_first=True))
    got = leave(mg.mont_exp(am, digits, ctx, window=4), ctx)
    assert got == [pow(x, e, n) for x, n in zip(xs, ns)]


def test_fixed_base_comb():
    n = odd_modulus(256)
    ctx = mg.MontCtx.for_modulus(n)
    g = rng.randrange(n)
    nbits = 80
    gm = enter([g], ctx)
    ladder = mg.build_pow2_ladder(gm, ctx, nbits)
    # spot-check the ladder
    lad_ints = [leave(ladder[t], ctx)[0] for t in (0, 1, 7, nbits - 1)]
    assert lad_ints == [pow(g, 1 << t, n) for t in (0, 1, 7, nbits - 1)]

    window = 8
    comb = mg.build_comb_table(ladder, ctx, window)
    es = [rng.getrandbits(nbits) for _ in range(5)] + [0, 1]
    n_win = -(-nbits // window)
    digits = jnp.asarray(mg.exponent_digits(es, n_win, window, msb_first=False))
    got = leave(mg.mont_exp_fixed_base(comb, digits, ctx), ctx)
    assert got == [pow(g, e, n) for e in es]


def test_fixed_base_comb_with_acc0():
    n = odd_modulus(128)
    ctx = mg.MontCtx.for_modulus(n)
    g = rng.randrange(n)
    gm = enter([g], ctx)
    ladder = mg.build_pow2_ladder(gm, ctx, 32)
    comb = mg.build_comb_table(ladder, ctx, 8)
    es = [rng.getrandbits(32) for _ in range(3)]
    cs = [rng.randrange(n) for _ in range(3)]
    digits = jnp.asarray(mg.exponent_digits(es, 4, 8, msb_first=False))
    acc0 = enter(cs, ctx)
    got = leave(mg.mont_exp_fixed_base(comb, digits, ctx, acc0=acc0), ctx)
    assert got == [(c * pow(g, e, n)) % n for c, e in zip(cs, es)]


def test_mont_inv():
    n = odd_modulus(192)
    ctx = mg.MontCtx.for_modulus(n)
    xs = [rng.randrange(1, n) for _ in range(6)]
    xs = [x if math_gcd(x, n) == 1 else x + 1 for x in xs]
    am = enter(xs, ctx)
    got = leave(mg.mont_inv(am, ctx), ctx)
    assert got == [pow(x, -1, n) for x in xs]


def test_mont_inv_edge_values():
    n = odd_modulus(128)
    ctx = mg.MontCtx.for_modulus(n)
    xs = [1, 2, n - 1, n - 2]
    got = leave(mg.mont_inv(enter(xs, ctx), ctx), ctx)
    assert got == [pow(x, -1, n) for x in xs]


def test_mont_inv_tree():
    n = odd_modulus(192)
    ctx = mg.MontCtx.for_modulus(n)
    for count in (1, 2, 5, 8, 13):
        xs = [rng.randrange(1, n) for _ in range(count)]
        xs = [x if math_gcd(x, n) == 1 else x + 1 for x in xs]
        got = leave(mg.mont_inv_tree(enter(xs, ctx), ctx), ctx)
        assert got == [pow(x, -1, n) for x in xs], f"count={count}"


def test_mont_inv_tree_edge_values():
    n = odd_modulus(128)
    ctx = mg.MontCtx.for_modulus(n)
    xs = [1, 2, n - 1, n - 2, 1, 1, n - 1]
    got = leave(mg.mont_inv_tree(enter(xs, ctx), ctx), ctx)
    assert got == [pow(x, -1, n) for x in xs]
