"""Independent oracle for the fixed-point codec tests.

A plain transcription of the reference codec (ipcl_python's
bindings/fixedpoint.py, itself derived from FATE's FixedPointNumber):
a value x is stored as round(x * BASE^e) mod n with BASE = 2 and
e = floor((53 - frexp(x)[1]) / log2(BASE)) for floats (the float's
53-bit mantissa lands on integers), e = 0 for ints, and decodes as
mantissa * BASE^-e with the top third of [0, n) read as negative.
Error types and messages follow the reference, because the package
promises parity with them.  Nothing here imports the package under
test.
"""

import math
import sys

import numpy as np


class FixedPointNumber:
    BASE = 2
    LOG2_BASE = math.log(BASE, 2)
    FLOAT_MANTISSA_BITS = sys.float_info.mant_dig
    Q = 293973345475167247070445277780365744413 ** 2

    def __init__(self, encoding, exponent, n=None, max_int=None):
        if n is None:
            n = self.Q
            max_int = n // 2
        self.n = n
        self.max_int = n // 2 if max_int is None else max_int
        self.encoding = encoding
        self.exponent = exponent

    @classmethod
    def encode(cls, scalar, n=None, max_int=None):
        if np.abs(scalar) < 1e-200:
            scalar = 0
        if n is None:
            n = cls.Q
            max_int = n // 2
        if isinstance(scalar, (int, np.int16, np.int32, np.int64)):
            exponent = 0
        elif isinstance(scalar, (float, np.float16, np.float32, np.float64)):
            lsb_exponent = cls.FLOAT_MANTISSA_BITS - math.frexp(scalar)[1]
            exponent = math.floor(lsb_exponent / cls.LOG2_BASE)
        else:
            raise TypeError(f"Don't know the precision of type {type(scalar)}.")
        int_fixpoint = int(round(scalar * pow(cls.BASE, exponent)))
        if abs(int_fixpoint) > max_int:
            raise ValueError(
                f"Integer needs to be within +/- {max_int},"
                f"but got {int_fixpoint}, basic info: scalar={scalar}, "
                f"base={cls.BASE}, exponent={exponent}")
        return cls(int_fixpoint % n, exponent, n, max_int)

    def decode(self):
        if self.encoding >= self.n:
            raise ValueError("Attempted to decode corrupted number")
        if self.encoding <= self.max_int:
            mantissa = self.encoding
        elif self.encoding >= self.n - self.max_int:
            mantissa = self.encoding - self.n
        else:
            raise OverflowError(
                f"Overflow detected in decode number, encoding: "
                f"{self.encoding}, {self.exponent} {self.n}")
        return mantissa * pow(self.BASE, -self.exponent)

    def increase_exponent_to(self, new_exponent):
        if new_exponent < self.exponent:
            raise ValueError(f"New exponent {new_exponent} should be greater "
                             f"than old exponent {self.exponent}")
        factor = pow(self.BASE, new_exponent - self.exponent)
        return FixedPointNumber(self.encoding * factor % self.n, new_exponent,
                                self.n, self.max_int)

    def _aligned(self, other):
        if not isinstance(other, FixedPointNumber):
            other = self.encode(other, self.n, self.max_int)
        x, y = self, other
        if x.exponent < y.exponent:
            x = x.increase_exponent_to(y.exponent)
        elif y.exponent < x.exponent:
            y = y.increase_exponent_to(x.exponent)
        return x, y

    def __add__(self, other):
        x, y = self._aligned(other)
        return FixedPointNumber((x.encoding + y.encoding) % self.n,
                                x.exponent, self.n, self.max_int)

    def __sub__(self, other):
        if not isinstance(other, FixedPointNumber):
            return self + (-1 * other)
        x, y = self._aligned(other)
        return FixedPointNumber((x.encoding - y.encoding) % self.n,
                                x.exponent, self.n, self.max_int)

    def __mul__(self, other):
        scalar = other.decode() if isinstance(other, FixedPointNumber) \
            else other
        return self.encode(self.decode() * scalar, self.n, self.max_int)

    def __truediv__(self, other):
        scalar = other.decode() if isinstance(other, FixedPointNumber) \
            else other
        return self * (1 / scalar)

    def _value(self, other):
        return other.decode() if isinstance(other, FixedPointNumber) \
            else other

    def __lt__(self, other):
        return self.decode() < self._value(other)

    def __ge__(self, other):
        return self.decode() >= self._value(other)

    def __eq__(self, other):
        return self.decode() == self._value(other)
