"""Oracle tests: limb-array ops against Python big-int arithmetic.

The reference has no such tests (SURVEY.md §4 notes the gap); these are
the foundation-layer unit tests this build adds.
"""

import random

import numpy as np
import pytest

from pailliercryptolib_python_tpu.ops import limb


rng = random.Random(1234)


def rand_int(bits):
    return rng.getrandbits(bits)


def test_int_limb_roundtrip():
    for bits in [1, 15, 16, 17, 100, 512, 2048]:
        for _ in range(5):
            x = rand_int(bits)
            L = limb.limbs_for_bits(bits) + 2
            assert limb.limbs_to_int(limb.int_to_limbs(x, L)) == x


def test_batch_roundtrip():
    xs = [rand_int(200) for _ in range(7)]
    arr = limb.ints_to_limbs(xs, 16)
    assert arr.shape == (16, 7)
    assert limb.limbs_to_ints(arr) == xs


def test_normalize():
    import jax.numpy as jnp
    # redundant limbs with values >= 2^16
    t = jnp.array([[0xFFFFFF], [0x1FFFF], [0x2]], dtype=jnp.uint32)
    val = 0xFFFFFF + (0x1FFFF << 16) + (0x2 << 32)
    out = np.asarray(limb.normalize(t))
    assert (out < (1 << 16)).all()
    assert limb.limbs_to_int(out[:, 0]) == val


def test_big_mul():
    for la_bits, lb_bits in [(64, 64), (256, 256), (1024, 1024), (1024, 64)]:
        La, Lb = limb.limbs_for_bits(la_bits), limb.limbs_for_bits(lb_bits)
        xs = [rand_int(la_bits) for _ in range(5)]
        ys = [rand_int(lb_bits) for _ in range(5)]
        a = limb.ints_to_limbs(xs, La)
        b = limb.ints_to_limbs(ys, Lb)
        out = np.asarray(limb.big_mul(a, b))
        got = limb.limbs_to_ints(out)
        assert got == [x * y for x, y in zip(xs, ys)]


def test_big_mul_broadcast_shared_operand():
    xs = [rand_int(256) for _ in range(4)]
    y = rand_int(256)
    a = limb.ints_to_limbs(xs, 16)
    b = limb.ints_to_limbs([y], 16)
    got = limb.limbs_to_ints(np.asarray(limb.big_mul(a, b)))
    assert got == [x * y for x in xs]


def test_big_mul_low():
    xs = [rand_int(256) for _ in range(3)]
    ys = [rand_int(256) for _ in range(3)]
    a = limb.ints_to_limbs(xs, 16)
    b = limb.ints_to_limbs(ys, 16)
    got = limb.limbs_to_ints(np.asarray(limb.big_mul_low(a, b, 16)))
    assert got == [(x * y) % (1 << 256) for x, y in zip(xs, ys)]


def test_compare_and_cond_sub():
    import jax.numpy as jnp
    pairs = [(5, 3), (3, 5), (7, 7), (1 << 200, (1 << 200) - 1),
             ((1 << 200) - 1, 1 << 200), (0, 0)]
    a = limb.ints_to_limbs([p[0] for p in pairs], 14)
    b = limb.ints_to_limbs([p[1] for p in pairs], 14)
    ge = np.asarray(limb.compare_ge(jnp.asarray(a), jnp.asarray(b)))
    assert list(ge) == [x >= y for x, y in pairs]
    sub = limb.limbs_to_ints(np.asarray(limb.cond_sub(jnp.asarray(a), jnp.asarray(b))))
    assert sub == [x - y if x >= y else x for x, y in pairs]


def test_sub_mod_base():
    xs = [rand_int(128) for _ in range(5)]
    ys = [rand_int(128) for _ in range(5)]
    L = 10
    a = limb.ints_to_limbs(xs, L)
    b = limb.ints_to_limbs(ys, L)
    import jax.numpy as jnp
    got = limb.limbs_to_ints(
        np.asarray(limb.sub_mod_base(jnp.asarray(a), jnp.asarray(b))))
    assert got == [(x - y) % (1 << (16 * L)) for x, y in zip(xs, ys)]
