#! /usr/bin/env python3
"""google_benchmark-shaped micro-bench, drop-in compatible with the
reference harness (/root/reference/bench/bench_ipcl_python.py): same
BM_* registrations, arg sweep (16, 64), preset 2048-bit P/Q and QAT
context lifecycle — but running against this framework through the
ipcl_python alias package.

Uses the real google_benchmark package when installed; otherwise a
built-in shim reproduces its registration API and console table (this
image ships no google_benchmark and installs are not allowed).
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

from ipcl_python import PaillierKeypair  # noqa: E402
import ipcl_python as ipcl  # noqa: E402
from ipcl_python import context  # noqa: E402

try:
    import google_benchmark as benchmark
except ImportError:
    class _Shim:
        """Minimal google_benchmark-compatible registration surface."""

        kMicrosecond = "us"
        _registry = []

        class _Option:
            def __init__(self, shim):
                self._shim = shim

            def unit(self, u):
                def deco(fn):
                    return fn
                return deco

            def arg(self, value):
                def deco(fn):
                    entry = next((e for e in self._shim._registry
                                  if e[0] is fn), None)
                    if entry is None:
                        self._shim._registry.append((fn, [value]))
                    else:
                        entry[1].insert(0, value)
                    return fn
                return deco

        class _State:
            def __init__(self, arg, min_time=0.25, max_iters=20):
                self._arg = arg
                self._iters = 0
                self._budget = min_time
                self._max_iters = max_iters
                self._t0 = None
                self.elapsed = 0.0

            def range(self, _idx=0):
                return self._arg

            def __iter__(self):
                return self

            def __next__(self):
                now = time.perf_counter()
                if self._t0 is not None:
                    self.elapsed = now - self._t0
                if self._iters >= 1 and (self.elapsed >= self._budget
                                         or self._iters >= self._max_iters):
                    raise StopIteration
                if self._t0 is None:
                    self._t0 = now
                self._iters += 1
                return True

        def __init__(self):
            self.option = self._Option(self)

        def register(self, fn):
            self._registry.append((fn, []))
            return fn

        def main(self):
            print(f"{'Benchmark':<30}{'Time':>15}{'Iterations':>15}")
            print("-" * 60)
            for fn, args in self._registry:
                for arg in (args or [None]):
                    state = self._State(arg)
                    fn(state)
                    per = state.elapsed / max(1, state._iters - 1)
                    name = fn.__name__ + (f"/{arg}" if arg is not None
                                          else "")
                    print(f"{name:<30}{per * 1e6:>12.0f} us"
                          f"{state._iters - 1:>15}")

    benchmark = _Shim()


@benchmark.register
@benchmark.option.unit(benchmark.kMicrosecond)
@benchmark.option.arg(1024)
@benchmark.option.arg(2048)
def BM_KeyGen(state):
    while state:
        _ = PaillierKeypair.generate_keypair(state.range(0))


@benchmark.register
@benchmark.option.unit(benchmark.kMicrosecond)
@benchmark.option.arg(16)
@benchmark.option.arg(64)
def BM_Encrypt(state):
    x = (np.arange(state.range(0)) + 11) * 1234.5678
    while state:
        _ = pk.encrypt(x)


@benchmark.register
@benchmark.option.unit(benchmark.kMicrosecond)
@benchmark.option.arg(16)
@benchmark.option.arg(64)
def BM_Decrypt(state):
    x = (np.arange(state.range(0)) + 1) * 1234.5678
    ct_x = pk.encrypt(x)
    while state:
        _ = sk.decrypt(ct_x)


@benchmark.register
@benchmark.option.unit(benchmark.kMicrosecond)
@benchmark.option.arg(16)
@benchmark.option.arg(64)
def BM_Add_CTCT(state):
    x = (np.arange(state.range(0)) + 11) * 5111.2834
    y = (32768 - np.arange(state.range(0))) * 1.3872
    ct_x = pk.encrypt(x)
    ct_y = pk.encrypt(y)
    while state:
        _ = ct_x + ct_y


@benchmark.register
@benchmark.option.unit(benchmark.kMicrosecond)
@benchmark.option.arg(16)
@benchmark.option.arg(64)
def BM_Add_CTPT(state):
    x = (np.arange(state.range(0)) + 11) * 5111.2834
    y = (32768 - np.arange(state.range(0))) * 1.3872
    ct_x = pk.encrypt(x)
    ct_x = ct_x * x
    while state:
        _ = ct_x + y


@benchmark.register
@benchmark.option.unit(benchmark.kMicrosecond)
@benchmark.option.arg(16)
@benchmark.option.arg(64)
def BM_Mul_CTPT(state):
    x = (np.arange(state.range(0)) + 11) * 5111.2834
    y = (32768 - np.arange(state.range(0))) * 1.3872
    ct_x = pk.encrypt(x)
    while state:
        _ = ct_x * y


if __name__ == "__main__":
    # preset values: the framework's fixed 2048-bit bench primes
    # (utils/fixtures.py — the reference pins its own P, Q the same way)
    from pailliercryptolib_python_tpu.utils.fixtures import P_1024, Q_1024

    P, Q = P_1024, Q_1024
    N = P * Q

    context.initializeContext("QAT")

    pk = ipcl.PaillierPublicKey(N, N.bit_length(), True)
    sk = ipcl.PaillierPrivateKey(pk, P, Q)

    benchmark.main()
    context.terminateContext()
