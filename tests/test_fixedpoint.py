"""Fixed-point codec: bit-exact parity with the reference codec.

The oracle (tests/_fixedpoint_oracle.py) transcribes the reference's
formulas without importing this package; every encode/decode here must
match it bit-for-bit, error types and messages included.
"""

import os
import random
import sys

import numpy as np
import pytest

from pailliercryptolib_python_tpu.fixedpoint import (
    FixedPointNumber, FixedPointEndec, encode_vector, decode_vector)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _fixedpoint_oracle as ref  # noqa: E402

rng = random.Random(11)

N = (1 << 255) - 19  # any modulus-like value works for codec parity
MAX_INT = N // 3 - 1

SAMPLES = ([0, 1, -1, 2, -2, 5000, -5000, 10 ** 12, -(10 ** 12)]
           + [0.5, -0.5, 0.2, -0.2, 1234.5678, -1234.5678, 1e-10, -1e-10,
              1e-250, 3.141592653589793, 2 ** 52 + 0.5, 1e100, -1e100]
           + [rng.uniform(-1e6, 1e6) for _ in range(50)]
           + [rng.randint(-10 ** 15, 10 ** 15) for _ in range(50)]
           + [np.float64(7.25), np.int64(42), np.int32(-9), np.float32(1.5)])


@pytest.mark.parametrize("value", SAMPLES, ids=lambda v: repr(v)[:24])
def test_encode_bit_exact(value):
    ours = FixedPointNumber.encode(value, N, MAX_INT)
    theirs = ref.FixedPointNumber.encode(value, N, MAX_INT)
    assert ours.encoding == theirs.encoding
    assert ours.exponent == theirs.exponent
    assert ours.decode() == theirs.decode()


def test_encode_bounds_error_parity():
    with pytest.raises(ValueError):
        FixedPointNumber.encode(N, N, MAX_INT)
    with pytest.raises(ValueError):
        ref.FixedPointNumber.encode(N, N, MAX_INT)


def test_decode_overflow_parity():
    bad = MAX_INT + 5  # in the dead zone between +max and n-max
    with pytest.raises(OverflowError):
        FixedPointNumber(bad, 0, N, MAX_INT).decode()
    with pytest.raises(OverflowError):
        ref.FixedPointNumber(bad, 0, N, MAX_INT).decode()


def test_increase_exponent_to_parity():
    a = FixedPointNumber.encode(12.75, N, MAX_INT)
    b = ref.FixedPointNumber.encode(12.75, N, MAX_INT)
    a2, b2 = a.increase_exponent_to(80), b.increase_exponent_to(80)
    assert a2.encoding == b2.encoding and a2.exponent == b2.exponent
    with pytest.raises(ValueError):
        a.increase_exponent_to(a.exponent - 1)


def test_scalar_arithmetic_parity():
    pairs = [(1.5, 2.25), (-3.0, 7.5), (100, 0.01), (-5, -7)]
    for x, y in pairs:
        a = FixedPointNumber.encode(x, N, MAX_INT)
        b = ref.FixedPointNumber.encode(x, N, MAX_INT)
        for op in ("__add__", "__sub__", "__mul__", "__truediv__"):
            r1 = getattr(a, op)(y)
            r2 = getattr(b, op)(y)
            assert r1.encoding == r2.encoding, (op, x, y)
            assert r1.exponent == r2.exponent, (op, x, y)
        assert (a < y) == (b < y) and (a >= y) == (b >= y)
        assert (a == x) == (b == x)


def test_encode_vector_matches_scalar():
    floats = np.array([0.5, -0.25, 1234.5678, 1e-300, 0.0, -1e9])
    encs, exps = encode_vector(floats, N, MAX_INT)
    for v, e, x in zip(floats, encs, exps):
        s = ref.FixedPointNumber.encode(float(v), N, MAX_INT)
        assert e == s.encoding and x == s.exponent
    ints = np.array([0, 1, -1, 10 ** 14, -(10 ** 14)], dtype=np.int64)
    encs, exps = encode_vector(ints, N, MAX_INT)
    for v, e, x in zip(ints, encs, exps):
        s = ref.FixedPointNumber.encode(int(v), N, MAX_INT)
        assert e == s.encoding and x == s.exponent
    mixed = [1, 2.5, -3, -0.125]
    encs, exps = encode_vector(mixed, N, MAX_INT)
    for v, e, x in zip(mixed, encs, exps):
        s = ref.FixedPointNumber.encode(v, N, MAX_INT)
        assert e == s.encoding and x == s.exponent


def test_decode_vector_matches_scalar():
    vals = [0.5, -0.25, 1234.5678, 42, -42]
    encs, exps = encode_vector(vals, N, MAX_INT)
    decs = decode_vector(encs, exps, N, MAX_INT)
    for v, d in zip(vals, decs):
        assert d == ref.FixedPointNumber.encode(v, N, MAX_INT).decode()


def test_endec_tensor():
    endec = FixedPointEndec(N, MAX_INT)
    x = np.array([[1.5, -2.5], [3.25, 0.0]])
    enc = endec.encode(x)
    dec = endec.decode(enc)
    assert (dec == x).all()
    tr = endec.truncate(enc)
    assert (endec.decode(tr) == x).all()
    # scalar path
    assert endec.decode(endec.encode(7.125)) == 7.125


def _to_limbs(vals, n, L):
    out = np.zeros((L, len(vals)), dtype=np.uint32)
    for c, v in enumerate(vals):
        for l in range(L):
            out[l, c] = (v >> (16 * l)) & 0xFFFF
    return out


def test_decode_limbs_vector_matches_decode_vector():
    """The C decode path must be bit-identical to the scalar loop over
    every sign/exponent regime, including exact ints (exponent <= 0),
    huge positive exponents past the float-underflow cliff, and the
    deep-negative-exponent exact-int branch."""
    from pailliercryptolib_python_tpu.fixedpoint import decode_limbs_vector

    L = (N.bit_length() + 15) // 16
    cases = [
        (123456789, 0), (N - 123456789, 0),             # exact ints
        (12345, 53), (N - 12345, 53),                   # ordinary floats
        ((1 << 300) % N if (1 << 300) < MAX_INT else 7, 10),
        (MAX_INT, 0), (N - MAX_INT, 0),                 # bound values
        (999, -64), (N - 999, -64),                     # int result, e<0
        (88, 1100), (N - 88, 1100),                     # past underflow
        (0, 0), (0, 42),
    ]
    encs = [c[0] for c in cases]
    exps = np.array([c[1] for c in cases], dtype=np.int64)
    arr = _to_limbs(encs, N, L)
    got = decode_limbs_vector(arr, len(cases), exps, N, MAX_INT)
    want = decode_vector(encs, exps, N, MAX_INT)
    assert len(got) == len(want)
    for g, w, c in zip(got, want, cases):
        assert type(g) is type(w) and g == w, f"case {c}: {g!r} != {w!r}"
        rw = ref.FixedPointNumber(c[0], int(c[1]), N, MAX_INT).decode()
        assert g == rw, f"case {c}: {g!r} != reference {rw!r}"


def test_decode_limbs_vector_errors():
    from pailliercryptolib_python_tpu.fixedpoint import decode_limbs_vector
    from pailliercryptolib_python_tpu import native

    if native.decode_limbs16([[0]], 1, [0], 3, 1) is None:
        pytest.skip("C extension unavailable")

    L = (N.bit_length() + 15) // 16
    # overflow region: max_int < enc < n - max_int
    bad = MAX_INT + 12345
    arr = _to_limbs([bad], N, L)
    with pytest.raises(OverflowError) as ei:
        decode_limbs_vector(arr, 1, np.array([7], dtype=np.int64),
                            N, MAX_INT)
    with pytest.raises(OverflowError) as er:
        ref.FixedPointNumber(bad, 7, N, MAX_INT).decode()
    assert str(ei.value) == str(er.value)
