#!/usr/bin/env python3
"""End-to-end example — the integration smoke for the framework.

Counterpart of the reference's example/ipclpy_example.py:
encrypt/decrypt round trips, every HE op (CT+CT, CT+PT, CT*PT, matmul,
reductions), broadcasting, pickle round trips of keys and ciphertexts,
and a runtime-mode timing sweep (the reference sweeps QAT hybrid modes;
here the sweep compares the accelerator path against the CPU fallback).

Run: python examples/paillier_example.py [--bits 1024] [--batch 256]
"""

import argparse
import pickle
import time

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pailliercryptolib_python_tpu import (
    PaillierKeypair, context, hybridControl, hybridMode,
)


def check(name, ok):
    print(f"  {name:<42s} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"example failed at: {name}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()

    context.initializeContext("GPU")
    print(f"accelerator active: {context.isQATActive()}")

    t0 = time.perf_counter()
    pk, sk = PaillierKeypair.generate_keypair(args.bits)
    print(f"keygen({args.bits}): {time.perf_counter() - t0:.2f}s")

    rng = np.random.default_rng(0)
    B = args.batch
    x = rng.random(B) * 100
    y = rng.random(B) * 10

    print("HE operation round trips:")
    ct_x, ct_y = pk.encrypt(x), pk.encrypt(y)
    check("encrypt/decrypt", np.allclose(sk.decrypt(ct_x), x))
    check("ct + ct", np.allclose(sk.decrypt(ct_x + ct_y), x + y))
    check("ct + pt", np.allclose(sk.decrypt(ct_x + y), x + y))
    check("ct + scalar (broadcast)", np.allclose(sk.decrypt(ct_x + 3.5), x + 3.5))
    check("ct * pt", np.allclose(sk.decrypt(ct_x * y), x * y))
    check("ct * negative pt", np.allclose(sk.decrypt(ct_x * -y), -x * y))
    check("ct / scalar", np.allclose(sk.decrypt(ct_x / 4.0), x / 4.0))
    check("sum", np.isclose(sk.decrypt(ct_x.sum()), x.sum()))
    check("mean", np.isclose(sk.decrypt(ct_x.mean()), x.mean()))
    check("dot", np.isclose(sk.decrypt(ct_x.dot(y)), x.dot(y)))

    a = rng.random((4, 5))
    b = rng.random((5, 3))
    ct_a = pk.encrypt(a.flatten())
    check("ct @ pt", np.allclose(
        np.array(sk.decrypt(ct_a @ b)).reshape(4, 3), a @ b))
    ct_b = pk.encrypt(b.flatten())
    check("pt @ ct", np.allclose(
        np.array(sk.decrypt(a @ ct_b)).reshape(4, 3), a @ b))

    print("serialization round trips:")
    pk2 = pickle.loads(pickle.dumps(pk))
    sk2 = pickle.loads(pickle.dumps(sk))
    ct2 = pickle.loads(pickle.dumps(ct_x))
    check("pickled pk encrypts", np.allclose(sk.decrypt(pk2.encrypt(x)), x))
    check("pickled sk decrypts", np.allclose(sk2.decrypt(ct_x), x))
    check("pickled ct decrypts", np.allclose(sk.decrypt(ct2), x))

    print("re-randomization:")
    before = ct_x.ciphertextBN(0).value()
    ct_x.apply_obfuscator()
    check("ciphertext changed", ct_x.ciphertextBN(0).value() != before)
    check("value preserved", np.allclose(sk.decrypt(ct_x), x))

    # runtime-mode sweep over ALL 13 hybrid modes (reference:
    # /root/reference/example/ipclpy_example.py:159-211 times encrypt/
    # decrypt/multiply per QAT:CPU split).  Since round 5 the split is
    # REAL: with the context initialized, host-leaning modes route
    # their CPU share of each encrypt batch to a concurrent host bigint
    # thread (IPP = 100% host), so the timing surface varies by mode
    # exactly as on a QAT box.
    print("hybrid-mode sweep (encrypt / decrypt / multiply ms):")
    for mode in hybridMode:
        hybridControl.setHybridMode(mode)
        t0 = time.perf_counter()
        ct_m = pk.encrypt(x)
        t_enc = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        sk.decrypt(ct_m)
        t_dec = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ct_m * y
        t_mul = (time.perf_counter() - t0) * 1e3
        print(f"  {mode.name:<12s} {t_enc:8.1f} {t_dec:8.1f} {t_mul:8.1f}")
    hybridControl.setHybridOff()

    context.terminateContext()
    print("all checks passed")


if __name__ == "__main__":
    main()
