#!/usr/bin/env python3
"""On-card A/B of the choices this package makes by measurement.

    python tools/gpu_ab.py [--batch 16384] [--reps 5]

1. The Montgomery product alone, at L=257 (mod n^2 of a 2048-bit key)
   and L=129 (mod p^2): the CUDA kernel (ops/cuda_mont.py) against what
   XLA compiles from the jnp loop (montgomery._mont_mul_jnp).
2. End to end through the public API at a 2048-bit key — ct+ct add,
   encrypt on each engine, decrypt — with either product, in turns
   (kernel, XLA, XLA, kernel).  Every jitted program is dropped between
   turns so the next turn traces with its own product.
3. The DJN encrypt engines' device programs with the kernel: the RNS
   comb product against the limb comb.

Each time is the median of --reps warm calls, on the host clock around
work that ends in block_until_ready.  Prints the card's name and power
limit first and last; exits non-zero when JAX's device is not a GPU.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import card_line  # noqa: E402


def median_time(fn, reps):
    out = fn()
    if hasattr(out, "block_until_ready"):
        out.block_until_ready()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        if hasattr(out, "block_until_ready"):
            out.block_until_ready()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    B, reps = args.batch, args.reps

    from pailliercryptolib_python_tpu.utils import compile_cache
    compile_cache.configure()
    import jax
    import jax.numpy as jnp
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("gpu_ab: JAX's device is not a GPU")
    card = card_line()
    print(f"card: {card}; {jax.devices()[0].device_kind}", flush=True)

    from pailliercryptolib_python_tpu.api import (
        PaillierPrivateKey, PaillierPublicKey)
    from pailliercryptolib_python_tpu.bindings.containers import (
        ipclPublicKey)
    from pailliercryptolib_python_tpu.models import paillier as sch
    from pailliercryptolib_python_tpu.ops import cuda_mont, rns
    from pailliercryptolib_python_tpu.ops import montgomery as mg
    from pailliercryptolib_python_tpu.ops.limb import ints_to_limbs
    from pailliercryptolib_python_tpu.utils import config as cfg
    from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints

    kd = fixed_key_ints(2048)
    rnd = np.random.default_rng(5)

    # 1. the product alone
    xla_mul = jax.jit(mg._mont_mul_jnp)
    kern_mul = jax.jit(lambda a, b, ctx: cuda_mont.mont_mul(a, b,
                                                            ctx.n_limbs))
    for name, m in (("mod n^2", kd["n"] ** 2), ("mod p^2", kd["p"] ** 2)):
        ctx = mg.MontCtx.for_modulus(m)
        L = ctx.num_limbs
        vals = [int.from_bytes(rnd.bytes(2 * L), "little") % (2 * m)
                for _ in range(2 * B)]
        a = jnp.asarray(ints_to_limbs(vals[:B], L))
        b = jnp.asarray(ints_to_limbs(vals[B:], L))
        tk = median_time(lambda: kern_mul(a, b, ctx), reps)
        tx = median_time(lambda: xla_mul(a, b, ctx), reps)
        same = np.array_equal(np.asarray(kern_mul(a, b, ctx)),
                              np.asarray(xla_mul(a, b, ctx)))
        print(f"product alone, L={L} ({name}), B={B}: kernel "
              f"{tk * 1e3:.3f} ms, XLA {tx * 1e3:.3f} ms "
              f"(x{tx / tk:.1f}); bit-equal {same}", flush=True)

    # 2. end to end, with either product
    kernel_product = mg.mont_mul

    def xla_product(a, b, ctx):
        return mg._mont_mul_jnp(a, b, ctx)

    x = rnd.uniform(-1e3, 1e3, B)
    y = rnd.uniform(-1e3, 1e3, B)
    results = {}
    for turn, (label, product) in enumerate(
            [("kernel", kernel_product), ("XLA", xla_product),
             ("XLA", xla_product), ("kernel", kernel_product)]):
        mg.mont_mul = product
        jax.clear_caches()
        for engine in ("rns", "limb"):
            cfg.set_config(encrypt_engine=engine)
            pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                                    kd["randbits"])
            ipk = ipclPublicKey(None, _context=pub)
            pk = PaillierPublicKey(ipk)
            sk = PaillierPrivateKey(ipk, kd["p"], kd["q"])
            t0 = time.perf_counter()
            ct_x = pk.encrypt(x)
            ct_x.ciphertext().device_array().block_until_ready()
            first = time.perf_counter() - t0

            def enc():
                return pk.encrypt(x).ciphertext().device_array()
            t = median_time(enc, reps)
            results.setdefault((label, f"encrypt[{engine}]"), []).append(t)
            print(f"turn {turn} {label:>6} encrypt[{engine}]: "
                  f"{t * 1e3:.1f} ms (first call {first:.1f} s)",
                  flush=True)
        ct_y = pk.encrypt(y)

        def add():
            return (ct_x + ct_y).ciphertext().device_array()

        def dec():
            return sk.decrypt(ct_x)
        for op, fn in (("ct+ct", add), ("decrypt", dec)):
            t = median_time(fn, reps)
            results.setdefault((label, op), []).append(t)
            print(f"turn {turn} {label:>6} {op}: {t * 1e3:.1f} ms",
                  flush=True)
        assert np.array_equal(np.asarray(sk.decrypt(ct_x)), x)
    mg.mont_mul = kernel_product
    cfg.set_config(encrypt_engine="auto")
    for (label, op), ts in sorted(results.items()):
        print(f"end to end, B={B}, {op:<14} {label:>6}: "
              + ", ".join(f"{t * 1e3:.1f}" for t in ts) + " ms",
              flush=True)

    # 3. the encrypt engines' device programs, kernel product
    jax.clear_caches()
    for engine in ("rns", "limb"):
        cfg.set_config(encrypt_engine=engine)
        pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                                kd["randbits"])
        vals = [int(v) for v in rnd.integers(0, 2 ** 60, B)]
        m_dev = pub.encodings_to_device(vals)
        digits = pub.sample_obfuscator_digits(B)
        if engine == "rns":
            base, key = pub._rns_enc_plan()
            table = pub.comb_rns

            def run():
                raw = sch._encrypt_raw_canonical(m_dev, pub.n_limbs, pub.L)
                return rns.rns_comb_product(raw, table, digits, base, key,
                                            pub.ctx, pub.L)
        else:
            table = pub.comb_table

            def run():
                return sch._encrypt_djn(m_dev, digits, table, pub.n_limbs,
                                        pub.ctx, pub.L)
        t = median_time(run, reps)
        print(f"encrypt device program, B={B}, engine {engine} "
              f"(comb window {pub.comb_window}): {t * 1e3:.2f} ms",
              flush=True)
    cfg.set_config(encrypt_engine="auto")
    print(f"card: {card_line()}", flush=True)


if __name__ == "__main__":
    main()
