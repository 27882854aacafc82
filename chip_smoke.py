#!/usr/bin/env python3
"""Smoke run of the Paillier op suite on one NVIDIA GPU.

    python chip_smoke.py               # phases 1-3 on one card
    python chip_smoke.py --four-cards  # the sharded path on a 1x4 mesh

Phase 1 prints the card.  Phase 2 runs the op suite through the public
API at a 2048-bit key and a batch of 16,384 values, checks every result
against numpy and the decrypted integers of 256 columns against Python's
pow, and prints each operation's first-call (compile) and warm times.
Phase 3 compares the CUDA Montgomery product with the jnp reference at
L=257 (mod n^2) and L=129 (mod p^2), for shared and per-element moduli,
bit for bit, checks the RNS extension dots exactly at several batch
widths, and reports which GEMMs they compiled to.  --four-cards runs
only the sharded path (federated aggregate, encrypted sum, ct*pt, CRT
decrypt) on four cards at 4 x 16,384 values and compares it with the
same work on one card.

Any failure raises and exits non-zero.  The last line of stdout is one
JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import pickle
import random
import subprocess
import time

import numpy as np

BITS = 2048
BATCH = 16384
EXACT_COLS = 256


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def sync(x):
    """Wait for a ciphertext (or device array) to be computed."""
    from pailliercryptolib_python_tpu.api import PaillierEncryptedNumber
    arr = x.ciphertext().device_array() \
        if isinstance(x, PaillierEncryptedNumber) else x
    if hasattr(arr, "block_until_ready"):
        arr.block_until_ready()
    return x


def timed(name: str, fn, runs: int = 2):
    """First call (compile + run) and one warm call; returns the result."""
    t0 = time.perf_counter()
    out = sync(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(runs - 1):
        t0 = time.perf_counter()
        out = sync(fn())
        warm.append(time.perf_counter() - t0)
    log(f"  {name:<22} first {first:9.3f} s   warm "
        + " ".join(f"{w:.4f}" for w in warm) + " s")
    return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_card():
    import jax
    from pailliercryptolib_python_tpu import native

    log("phase 1: card")
    log(f"  nvidia-smi: {card_line()}")
    devs = jax.devices()
    log(f"  jax.devices(): {devs}")
    log(f"  device_kind: {devs[0].device_kind}")
    log(f"  native C extension loaded: {bool(native._load())}")
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX's device is {devs[0].platform!r},"
                         f" not a GPU")


def python_decrypt(c: int, n: int, lam: int, mu: int) -> int:
    nsq = n * n
    return (pow(c, lam, nsq) - 1) // n * mu % n


def phase_ops():
    from math import lcm

    from pailliercryptolib_python_tpu import PaillierKeypair

    log(f"phase 2: op suite, {BITS}-bit key, B={BATCH}")
    rng = np.random.default_rng(2048)
    t0 = time.perf_counter()
    pk, sk = PaillierKeypair.generate_keypair(BITS)
    log(f"  {'keygen':<22} {time.perf_counter() - t0:9.3f} s")
    n = pk.n
    priv = sk.prikey.context
    lam = lcm(priv.p - 1, priv.q - 1)
    mu = pow(lam, -1, n)

    x = rng.uniform(-1e3, 1e3, BATCH)
    y = rng.uniform(-1e3, 1e3, BATCH)
    ct_x = timed("encrypt", lambda: pk.encrypt(x))
    ct_y = pk.encrypt(y)
    got = timed("decrypt", lambda: sk.decrypt(ct_x))
    check(np.array_equal(np.asarray(got), x), "decrypt(encrypt(x)) != x")
    got = timed("decrypt, 16 columns", lambda: sk.decrypt(ct_x[0:16]))
    check(np.array_equal(np.asarray(got), x[:16]), "decrypt at width 16")

    s = timed("ct+ct", lambda: ct_x + ct_y)
    check(np.allclose(sk.decrypt(s), x + y, rtol=1e-12, atol=1e-9),
          "ct+ct")
    sp = timed("ct+pt", lambda: ct_x + y)
    check(np.allclose(sk.decrypt(sp), x + y, rtol=1e-12, atol=1e-9),
          "ct+pt")
    prod = timed("ct*pt (neg pt)", lambda: ct_x * y)
    check(np.allclose(sk.decrypt(prod), x * y, rtol=1e-9, atol=1e-6),
          "ct*pt")
    tot = timed("sum", lambda: ct_x.sum())
    check(np.isclose(sk.decrypt(tot), x.sum(), rtol=1e-9, atol=1e-6), "sum")
    dot = timed("dot", lambda: ct_x.dot(y))
    check(np.isclose(sk.decrypt(dot), x @ y, rtol=1e-9, atol=1e-3), "dot")
    m, k, j = 8, 16, 4
    A = rng.uniform(-1, 1, (m, k))
    Bm = rng.uniform(-1, 1, (k, j))
    ct_a = pk.encrypt(A.flatten())
    mm = timed("matmul 8x16 @ 16x4", lambda: ct_a @ Bm)
    check(np.allclose(np.asarray(sk.decrypt(mm)).reshape(m, j), A @ Bm,
                      rtol=1e-9, atol=1e-9), "matmul")

    before = ct_x.ciphertext().host_ints()[:EXACT_COLS]
    t0 = time.perf_counter()
    ct_x.apply_obfuscator()
    sync(ct_x)
    log(f"  {'apply_obfuscator':<22} {time.perf_counter() - t0:9.3f} s")
    after = ct_x.ciphertext().host_ints()[:EXACT_COLS]
    check(all(a != b for a, b in zip(before, after)),
          "apply_obfuscator left a ciphertext unchanged")
    check(np.array_equal(np.asarray(sk.decrypt(ct_x)), x),
          "decrypt after apply_obfuscator")
    t0 = time.perf_counter()
    ct_rt = pickle.loads(pickle.dumps(ct_x))
    pk_rt = pickle.loads(pickle.dumps(pk))
    sk_rt = pickle.loads(pickle.dumps(sk))
    check(np.array_equal(np.asarray(sk_rt.decrypt(ct_rt)), x),
          "pickle round trip of ciphertexts and keys")
    check(np.array_equal(np.asarray(sk.decrypt(pk_rt.encrypt(y[:64]))),
                         y[:64]), "encrypt under an unpickled public key")
    log(f"  {'pickle round trip':<22} {time.perf_counter() - t0:9.3f} s")

    # Decrypted integers against the textbook formula in Python ints.
    t0 = time.perf_counter()
    for name, enc in (("x", ct_x), ("x+y", s), ("x*y", prod)):
        cts = enc.ciphertext().host_ints()[:EXACT_COLS]
        dev = sk.raw_decrypt(enc)[:EXACT_COLS]
        ref = [python_decrypt(c, n, lam, mu) for c in cts]
        check(dev == ref, f"decrypted integers of {name} != Python pow")
    log(f"  exact: {EXACT_COLS} columns each of x, x+y, x*y equal "
        f"Python pow ({time.perf_counter() - t0:.1f} s)")
    return pk, sk


def _extension_dots_report(priv) -> str:
    """Check the RNS extension dots (ops/rns._byte_dot) exactly against
    numpy at several batch widths, then compile one RNS product at the
    decrypt base and report how its GEMMs were lowered: the compiled
    dots, custom calls and GEMM fusions, by operand type."""
    import re

    import jax
    import jax.numpy as jnp
    from pailliercryptolib_python_tpu.ops import rns

    rnd = np.random.default_rng(16)
    k = priv.rns_base.k
    w = rnd.integers(-128, 128, (k + 1, k))
    for width in (1, 8, 16, 32, 64, 128, BATCH):
        x = rnd.integers(-128, 128, (k, width))
        got = np.asarray(jax.jit(rns._byte_dot)(jnp.asarray(w, jnp.int32),
                                                jnp.asarray(x, jnp.int32)))
        check(np.array_equal(got.astype(np.int64), w @ x),
              f"extension dot ({k + 1}x{k}) @ ({k}x{width}) is not exact")
    spec = jax.ShapeDtypeStruct((priv.rns_base.CH, BATCH), jnp.uint32)
    text = jax.jit(rns.rns_mont_mul).lower(
        spec, spec, priv.rns_base, priv.rns_p).compile().as_text()
    types = dict(re.findall(r"(%[\w.\-]+) = \(?(\w+)\[", text))
    kinds = {}
    for ln in text.splitlines():
        m = re.search(r"= \(?\w+\[[^=]*? (dot|custom-call|fusion)\((.*?)\)",
                      ln)
        if not m or (m.group(1) == "fusion" and "gemm" not in ln.lower()):
            continue
        ops = {types.get(op) for op in re.findall(r"%[\w.\-]+", m.group(2))}
        ops &= {"s8", "bf16", "f16", "f32", "s32"}
        if not ops:
            continue
        target = re.search(r'custom_call_target="([^"]+)"', ln)
        key = (f"{target.group(1) if target else m.group(1)} on "
               f"{'/'.join(sorted(ops))}")
        kinds[key] = kinds.get(key, 0) + 1
    return (f"exact vs numpy at widths 1..{BATCH}; one RNS product "
            f"compiles to {kinds}")


def phase_kernel(pk, sk):
    import jax.numpy as jnp
    from pailliercryptolib_python_tpu.ops import cuda_mont
    from pailliercryptolib_python_tpu.ops import montgomery as mg
    from pailliercryptolib_python_tpu.ops.limb import ints_to_limbs

    log("phase 3: CUDA Montgomery product vs the jnp reference")
    pub = pk.pubkey.context
    priv = sk.prikey.context
    rnd = random.Random(3)
    for name, m, L in (("mod n^2", pub.nsquare, pub.L),
                       ("mod p^2", priv.p ** 2, priv.Lh)):
        shared = mg.MontCtx.for_modulus(m, min_bits=16 * L)
        check(shared.num_limbs == L, f"{name}: L={shared.num_limbs}")
        mods = [m] * (BATCH // 2) + [
            rnd.getrandbits(16 * L - 2) | 1 for _ in range(BATCH // 2)]
        per_elem = mg.MontCtx.for_moduli(mods, L)
        for kind, ctx, ms in (("shared", shared, [m] * BATCH),
                              ("per-element", per_elem, mods)):
            a = jnp.asarray(ints_to_limbs([rnd.randrange(2 * v) for v in ms],
                                          L))
            b = jnp.asarray(ints_to_limbs([rnd.randrange(2 * v) for v in ms],
                                          L))
            got = np.asarray(cuda_mont.mont_mul(a, b, ctx.n_limbs))
            want = np.asarray(mg._mont_mul_jnp(a, b, ctx))
            check(np.array_equal(got, want),
                  f"CUDA product != jnp product ({name}, L={L}, {kind})")
            log(f"  L={L} ({name}), B={BATCH}, {kind} moduli: bit-equal")
        odd = BATCH - 1
        got = np.asarray(cuda_mont.mont_mul(a[:, :odd], shared.r2,
                                            shared.n_limbs))
        want = np.asarray(mg._mont_mul_jnp(a[:, :odd], shared.r2, shared))
        check(np.array_equal(got, want), f"CUDA product, B={odd}, (L,1) b")
        log(f"  L={L} ({name}), B={odd}, broadcast (L,1) operand: "
            f"bit-equal")
    log(f"  RNS extension dots: {_extension_dots_report(priv)}")


def phase_four_cards():
    import jax
    import jax.numpy as jnp
    from pailliercryptolib_python_tpu.models import paillier as sch
    from pailliercryptolib_python_tpu.ops import montgomery as mg
    from pailliercryptolib_python_tpu.ops.limb import limbs_to_ints
    from pailliercryptolib_python_tpu.parallel import mesh as pmesh
    from pailliercryptolib_python_tpu.parallel import sharded_ops as so
    from pailliercryptolib_python_tpu.parallel.collective import (
        federated_aggregate, sharded_he_sum)

    devs = jax.devices()
    check(len(devs) >= 4, f"--four-cards needs 4 cards, found {len(devs)}")
    Q, B = BATCH, 4 * BATCH
    log(f"phase 4: sharded path, 1x4 mesh, {BITS}-bit key, B={B}")
    mesh = pmesh.make_mesh(1, 4, devices=devs[:4])
    kd = sch.generate_key_ints(BITS)
    pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                            kd["randbits"])
    priv = sch.PrivateContext(pub, kd["p"], kd["q"])
    n = kd["n"]
    rng = np.random.default_rng(4)
    va = [int(v) for v in rng.integers(0, 2 ** 40, B)]
    vb = [int(v) for v in rng.integers(0, 2 ** 40, B)]
    es = [int(v) for v in rng.integers(1, 2 ** 62, B)]
    parts = range(4)
    # Parties encrypt in slices of BATCH on the first card.
    ct_a = jnp.concatenate([pub.encrypt(va[i * Q:(i + 1) * Q])
                            for i in parts], axis=1)
    ct_b = jnp.concatenate([pub.encrypt(vb[i * Q:(i + 1) * Q])
                            for i in parts], axis=1)

    def cols(x, i):
        return x[:, i * Q:(i + 1) * Q]

    # The same work on one card: the four slices one after another.
    def agg_1():
        return jnp.concatenate([mg.mont_mul(cols(ct_a, i), cols(ct_b, i),
                                            pub.ctx) for i in parts], axis=1)

    def sum_1():
        tot = pub.tree_reduce(cols(agg1, 0), Q)[:, :1]
        for i in parts[1:]:
            tot = mg.mont_mul(tot, pub.tree_reduce(cols(agg1, i), Q)[:, :1],
                              pub.ctx)
        return tot

    def mul_1():
        return jnp.concatenate([pub.mul_pt(cols(agg1, i),
                                           es[i * Q:(i + 1) * Q])
                                for i in parts], axis=1)

    def dec_1():
        return jnp.concatenate([priv.decrypt_device(cols(mul1, i))
                                for i in parts], axis=1)

    log("  one card (four slices in turn):")
    agg1 = timed("aggregate", agg_1)
    tot1 = timed("encrypted sum", sum_1)
    mul1 = timed("ct*pt", mul_1)
    dec1 = timed("decrypt", dec_1)

    log("  four cards:")
    sa, sb = pmesh.shard_batch(ct_a, mesh), pmesh.shard_batch(ct_b, mesh)
    ctx4 = pmesh.replicate(pub.ctx, mesh)
    agg4 = timed("aggregate", lambda: federated_aggregate([sa, sb], ctx4,
                                                           mesh))
    tot4 = timed("encrypted sum", lambda: sharded_he_sum(agg4, ctx4, mesh))
    mul4 = timed("ct*pt", lambda: so.sharded_mul_pt(pub, agg4, es, mesh))
    dec4 = timed("decrypt", lambda: so.sharded_decrypt(priv, mul4, mesh))
    check(agg4.sharding == pmesh.batch_sharding(mesh),
          "aggregate is not batch-sharded")

    def canon(ct, b):
        return pub.export_cts(jax.device_put(ct, devs[0]), b)

    check(canon(agg4, B) == canon(agg1, B), "aggregate: 4 cards != 1 card")
    check(canon(tot4, 1) == canon(tot1, 1),
          "encrypted sum: 4 cards != 1 card")
    check(canon(mul4, B) == canon(mul1, B), "ct*pt: 4 cards != 1 card")
    want = [(a + b) * e % n for a, b, e in zip(va, vb, es)]
    got1 = limbs_to_ints(np.asarray(dec1))[:B]
    got4 = limbs_to_ints(np.asarray(dec4))[:B]
    check(got1 == want, "decrypt on one card != Python ints")
    check(got4 == want, "decrypt on four cards != Python ints")
    total = priv.decrypt_to_ints(jax.device_put(tot4, devs[0]), 1)[0]
    check(total == (sum(va) + sum(vb)) % n, "encrypted sum != Python sum")
    log("  canonical ciphertexts (aggregate, sum, ct*pt) and decrypted "
        "integers equal on 4 cards and 1 card, and the Python ints")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on a 1x4 mesh")
    args = ap.parse_args()

    from pailliercryptolib_python_tpu.utils import compile_cache
    cache = compile_cache.configure()
    import jax

    t_start = time.perf_counter()
    phase_card()
    log(f"  compile cache: {cache}")
    if args.four_cards:
        phase_four_cards()
    else:
        pk, sk = phase_ops()
        phase_kernel(pk, sk)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card_line()}")
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
