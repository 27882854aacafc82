#!/usr/bin/env python3
"""Benchmark harness in the shape of the reference bench suite, on one GPU.

Mirrors the metric surface of the reference's bench/bench_ipcl_python.py
(BM_KeyGen / BM_Encrypt / BM_Decrypt / BM_Add_CTCT / BM_Add_CTPT /
BM_Mul_CTPT at a fixed 2048-bit key) and adds production-batch
throughput, the 3072/4096-bit ladder, the 1M-value federated aggregation,
and an asserted device-side 2048-bit full-op parity suite.

Every time is wall time on the host clock around work that ends in
block_until_ready, transfers and host encode/decode included where the
operation has them.  Every logged line carries the card's name and power
limit.  Exits non-zero when JAX's default device is not a GPU.

Prints exactly ONE JSON line to stdout:
    {"metric": ..., "value": N, "unit": ..., "card": ...}
Detailed per-op results go to stderr.

Run: python bench.py   (PAILLIER_BENCH_LADDER=0 skips 3072/4096)
"""

import json
import os
import pickle
import sys
import time

import numpy as np

CARD = ""   # "name, power limit" from nvidia-smi, set in main()


def log(*a):
    print(f"[{CARD}]", *a, file=sys.stderr, flush=True)




def limbs_to_ints_mod(m_dev, b):
    """Decrypt host tail: D2H + C-ext limb unpack."""
    from pailliercryptolib_python_tpu.ops.limb import limbs_to_ints
    return limbs_to_ints(np.asarray(m_dev))[:b]


def _sync(x):
    """Wait until the device has computed x (host values pass through)."""
    if hasattr(x, "block_until_ready"):
        x.block_until_ready()
    return x


def timeit(fn, warmup=1, iters=3):
    """Wall time per fn() call: `iters` back-to-back calls, waiting for
    the last result."""
    _sync(fn())
    for _ in range(max(0, warmup - 1)):
        fn()
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn()
    _sync(out)
    return (time.perf_counter() - t0) / iters


def timeit_med(fn, warmup=1, iters=2, blocks=7):
    """Median-of-`blocks` block-means (each block: `iters` back-to-back
    calls + one sync) for the modexp-bound BM lines.  Returns
    (median, min, max) of the block means."""
    _sync(fn())
    for _ in range(max(0, warmup - 1)):
        fn()
    means = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn()
        _sync(out)
        means.append((time.perf_counter() - t0) / iters)
    means.sort()
    return means[len(means) // 2], means[0], means[-1]


def op_suite_parity(pk, sk):
    """Asserted device-side 2048-bit full-op parity suite.

    Covers the reference test contract (tests/ipcl_python_test.py) on
    the device: add chains, ct-ct subtraction, multiply with negative arrays,
    matmul, sum/mean/dot, exponent alignment drift, slicing, obfuscation,
    and pickle round trips.
    """
    rng = np.random.default_rng(11)

    # add chain (test_add shape)
    x = np.ones(100) * rng.integers(1, 100)
    y = np.ones(100) * rng.integers(1, 1000)
    z = np.ones(100) * rng.random()
    t = np.arange(100, dtype=float)
    got = sk.decrypt(pk.encrypt(x) + pk.encrypt(y) + pk.encrypt(z)
                     + pk.encrypt(t))
    assert np.allclose(got, x + y + z + t, atol=1e-7), "add chain"

    # multiply incl. negatives + ct-ct subtract (test_mul shape)
    neg = rng.random(100) * -7.5
    ct = pk.encrypt(x)
    assert np.allclose(sk.decrypt((ct * neg + z) * t), (x * neg + z) * t,
                       rtol=1e-9, atol=1e-7), "neg mul chain"
    assert np.allclose(sk.decrypt(ct - pk.encrypt(y)), x - y,
                       atol=1e-7), "ct-ct sub"

    # exponent-alignment drift (reference's 100-iter loop, shortened)
    drift = pk.encrypt(np.ones(4) * 10.0)
    for _ in range(10):
        drift = drift + 5000 - 0.2
    assert np.allclose(sk.decrypt(drift), 10.0 + 10 * (5000 - 0.2),
                       atol=1e-4), "alignment drift"

    # matmul / rmatmul (test_matmul shape)
    m, n, k = 4, 5, 3
    A = rng.random((m, n))
    Bm = rng.random((n, k))
    en = pk.encrypt(A.flatten())
    got = np.array(sk.decrypt(en @ Bm)).reshape(m, k)
    assert np.allclose(got, A @ Bm, atol=1e-7), "matmul"
    C = rng.random((k, m))
    got = np.array(sk.decrypt(C @ en)).reshape(k, n)
    assert np.allclose(got, C @ A, atol=1e-7), "rmatmul"

    # reductions
    v = rng.random(64)
    w = rng.random(64)
    ev = pk.encrypt(v)
    assert np.isclose(sk.decrypt(ev.sum()), v.sum(), atol=1e-7), "sum"
    assert np.isclose(sk.decrypt(ev.mean()), v.mean(), atol=1e-7), "mean"
    assert np.isclose(sk.decrypt(ev.dot(w)), v @ w, atol=1e-7), "dot"

    # slicing / iteration / obfuscation / pickle
    sl = ev[3:9]
    assert np.allclose(sk.decrypt(sl), v[3:9], atol=1e-9), "slice"
    ev.apply_obfuscator()
    assert np.allclose(sk.decrypt(ev), v, atol=1e-9), "re-obfuscate"
    assert np.allclose(sk.decrypt(pickle.loads(pickle.dumps(ev))), v,
                       atol=1e-9), "ct pickle"
    pk2 = pickle.loads(pickle.dumps(pk))
    sk2 = pickle.loads(pickle.dumps(sk))
    assert np.allclose(sk2.decrypt(pk2.encrypt(v)), v, atol=1e-9), \
        "key pickle"


def bench_key(bits, batches, results, rng, headline_B=None,
              mul_neg=False):
    """Run the BM_* suite for one key size; returns (pub, priv) contexts."""
    import jax.numpy as jnp  # noqa: F401
    from pailliercryptolib_python_tpu.models import paillier as sch
    from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints

    t0 = time.perf_counter()
    kd = fixed_key_ints(bits, enable_DJN=True)
    log(f"BM_KeyMaterial/{bits}: {(time.perf_counter() - t0) * 1e3:.0f} ms")
    pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                            kd["randbits"])
    priv = sch.PrivateContext(pub, kd["p"], kd["q"])

    enc_plan = pub._rns_enc_plan()
    if enc_plan is None:
        # limb engine: the positional comb is the production table.  On
        # the RNS path it is never touched (the RNS comb builds natively
        # from the host ladder), so don't spend its HBM/build here.
        t0 = time.perf_counter()
        _ = pub.comb_table
        _sync(pub.comb_table)
        log(f"CombTableBuild/{bits} (w={pub.comb_window}): "
            f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    if enc_plan is not None:
        from pailliercryptolib_python_tpu.ops import rns as _rns
        base_r, key_r = enc_plan
        t0 = time.perf_counter()
        comb_rns = pub.comb_rns        # native in-RNS bit-doubling build
        _sync(comb_rns[0])
        log(f"CombRnsBuild/{bits}: "
            f"{(time.perf_counter() - t0) * 1e3:.0f} ms "
            f"({comb_rns.size * 4 / 1e6:.0f} MB)")

        def encrypt_device(m_limbs, digits):
            """Production device program: RNS streamed comb product."""
            raw = sch._encrypt_raw_canonical(m_limbs, pub.n_limbs, pub.L)
            out = _rns.rns_comb_product(raw, comb_rns, digits, base_r,
                                        key_r, pub.ctx, pub.L)
            out.block_until_ready()
            return out
    else:
        def encrypt_device(m_limbs, digits):
            """Production device program (limb comb path)."""
            out = sch._encrypt_djn(m_limbs, digits, pub.comb_table,
                                   pub.n_limbs, pub.ctx, pub.L)
            out.block_until_ready()
            return out

    all_bs = list(batches) + ([headline_B] if headline_B else [])
    for B in all_bs:
        tag = f"{bits}/{B}" if bits != 2048 else f"{B}"
        vals = [int(v) for v in rng.integers(0, 2**60, size=B)]

        t0 = time.perf_counter()
        enc_limbs = pub.encodings_to_device(vals)
        digits = _sync(pub.sample_obfuscator_digits(B))
        _sync(enc_limbs)
        t_host = time.perf_counter() - t0  # host prep + H2D

        # small batches: more back-to-back calls per block
        it = 2 if B >= 1024 else 6
        t_enc, e_lo, e_hi = timeit_med(lambda: encrypt_device(enc_limbs,
                                                              digits),
                                       iters=it)
        results[f"BM_Encrypt/{tag}"] = t_enc
        log(f"BM_Encrypt/{tag}: {t_enc * 1e6:.0f} us med-of-7 "
            f"[{e_lo * 1e6:.0f}..{e_hi * 1e6:.0f}] "
            f"({B / t_enc:.1f} enc/s device-path; host prep+H2D "
            f"{t_host * 1e3:.0f} ms)")

        ct_dev = encrypt_device(enc_limbs, digits)

        def decrypt_device():
            out = priv.decrypt_device(ct_dev)
            out.block_until_ready()
            return out

        t_dec, d_lo, d_hi = timeit_med(decrypt_device, iters=it)
        results[f"BM_Decrypt_device/{tag}"] = t_dec
        # Host tail, itemized: D2H and the C-path fixed-point decode are
        # both charged.  BM_Decrypt = device + D2H + decode.
        from pailliercryptolib_python_tpu.fixedpoint import (
            decode_limbs_vector)
        m_dev = decrypt_device()
        zexp = np.zeros(B, dtype=np.int64)
        t0 = time.perf_counter()
        m_np = np.asarray(m_dev)
        t_d2h = time.perf_counter() - t0
        t0 = time.perf_counter()
        vals_out = decode_limbs_vector(m_np, B, zexp,
                                       pub.n, pub.n // 3 - 1)
        t_decode = time.perf_counter() - t0
        assert vals_out[:4] == [v % kd["n"] for v in vals[:4]]
        t_e2e_dec = t_dec + t_d2h + t_decode
        results[f"BM_Decrypt/{tag}"] = t_e2e_dec
        log(f"BM_Decrypt/{tag}: {t_e2e_dec * 1e6:.0f} us e2e "
            f"({t_dec * 1e6:.0f} us med-of-7 [{d_lo * 1e6:.0f}.."
            f"{d_hi * 1e6:.0f}] device-path = {B / t_dec:.1f} dec/s; "
            f"D2H {t_d2h * 1e3:.1f} ms + decode {t_decode * 1e3:.0f} ms)")

        if headline_B and B == headline_B:
            # host-side pipeline cost (fixed-point encode, limb pack,
            # OS-entropy digit sampling), then the H2D transfer; both
            # are charged to the headline.
            from pailliercryptolib_python_tpu.fixedpoint import (
                encode_vector)
            from pailliercryptolib_python_tpu.ops.limb import ints_to_limbs
            fvals = rng.random(B) * 1000
            t0 = time.perf_counter()
            encs, _ = encode_vector(fvals, pub.n, pub.n // 3 - 1)
            BPd = sch.pad_batch(B)
            arr = ints_to_limbs(list(encs) + [0] * (BPd - B), pub.Ln)
            digs_np = pub.sample_obfuscator_digits(B, as_numpy=True)
            t_hostpipe = time.perf_counter() - t0
            t0 = time.perf_counter()
            import jax.numpy as jnp
            _sync(jnp.asarray(arr))
            _sync(jnp.asarray(digs_np))
            t_h2d = time.perf_counter() - t0
            results["headline_host_s"] = t_hostpipe + t_h2d
            results["headline_dev_s"] = t_enc
            log(f"Headline host pipeline (encode+pack+entropy): "
                f"{t_hostpipe * 1e3:.0f} ms for B={B}; H2D "
                f"{t_h2d * 1e3:.1f} ms")
            # measured PIPELINED e2e encrypt (the hybridMode work-split):
            # chunked host encode/pack/entropy overlapping async device
            # dispatch — wall time from values to synced ciphertexts
            from pailliercryptolib_python_tpu.utils import (
                config as _pcfg)
            from pailliercryptolib_python_tpu.bindings.containers import (
                ipclPublicKey as _ipk)
            from pailliercryptolib_python_tpu.api import (
                PaillierPublicKey as _PPK)
            pk_pipe = _PPK(_ipk(None, _context=pub))
            fv = list(fvals)
            _pcfg.set_config(encrypt_pipeline_chunks=4)
            try:
                t_pipe = timeit(
                    lambda: _sync(pk_pipe.encrypt(fv).ciphertext()
                                  .device_array()), warmup=1, iters=2)
            finally:
                _pcfg.set_config(encrypt_pipeline_chunks=1)
            results["Encrypt_pipelined_e2e"] = t_pipe
            log(f"Encrypt_pipelined_e2e/{tag}: {t_pipe * 1e6:.0f} us "
                f"({B / t_pipe:.1f} enc/s wall, 4-chunk host/device "
                f"overlap)")

            # per-stage decrypt breakdown
            stages = priv.profile_stages(ct_dev, B)
            parts = {}
            for name, thunk in sorted(stages.items()):
                ts = timeit(lambda t=thunk: _sync(t()), iters=2)
                parts[name] = round(ts * 1e3, 1)
            results["decrypt_stages_ms"] = parts
            log(f"DecryptStages/{tag} (ms): " + ", ".join(
                f"{k}={v}" for k, v in parts.items()))
            continue  # headline batch: skip the small-op suite below

        ct2 = encrypt_device(enc_limbs, digits)

        def add_ctct():
            out = pub.add_ct(ct_dev, ct2)
            out.block_until_ready()
            return out

        t_add = timeit(add_ctct)
        results[f"BM_Add_CTCT/{tag}"] = t_add
        log(f"BM_Add_CTCT/{tag}: {t_add * 1e6:.0f} us "
            f"({B / t_add:.0f} ops/s)")

        def add_ctpt():
            enc = pub.encrypt_raw(enc_limbs)
            out = pub.add_ct(ct_dev, enc)
            out.block_until_ready()
            return out

        t_addp = timeit(add_ctpt)
        results[f"BM_Add_CTPT/{tag}"] = t_addp
        log(f"BM_Add_CTPT/{tag}: {t_addp * 1e6:.0f} us "
            f"({B / t_addp:.0f} ops/s)")

        mul_exps = [int(v) for v in rng.integers(1, 2**53, size=B)]

        def mul_ctpt():
            out = pub.mul_pt(ct_dev, mul_exps)
            out.block_until_ready()
            return out

        # the comb tables are resident and the mul program warm before
        # timing, so the med-of-7 spread reflects the chain
        if enc_plan is not None:
            _sync(comb_rns[0])
        t_mul, m_lo, m_hi = timeit_med(mul_ctpt, iters=it)
        results[f"BM_Mul_CTPT/{tag}"] = t_mul
        log(f"BM_Mul_CTPT/{tag}: {t_mul * 1e6:.0f} us med-of-7 "
            f"[{m_lo * 1e6:.0f}..{m_hi * 1e6:.0f}] "
            f"({B / t_mul:.0f} ops/s)")
        if bits == 4096:
            # stability evidence: a second consecutive med-of-7 must
            # land within the first run's spread
            t_mul2, m2_lo, m2_hi = timeit_med(mul_ctpt, iters=it)
            results[f"BM_Mul_CTPT_rerun/{tag}"] = t_mul2
            log(f"BM_Mul_CTPT_rerun/{tag}: {t_mul2 * 1e6:.0f} us "
                f"med-of-7 [{m2_lo * 1e6:.0f}..{m2_hi * 1e6:.0f}] "
                f"(delta {abs(t_mul2 - t_mul) / t_mul * 100:.1f}% vs "
                f"first run)")

        if mul_neg:
            # 50% negative plaintexts: the api path exponentiates by
            # |pt| then inverts flagged columns via the product tree
            from pailliercryptolib_python_tpu.ops import montgomery as mg
            flags = np.zeros(B, dtype=bool)
            flags[::2] = True
            idx = np.nonzero(flags)[0].astype(np.int32)

            def mul_ctpt_neg():
                out = pub.mul_pt(ct_dev, mul_exps)
                sub = pub.gather_batch(out, idx)
                inv = mg.mont_inv_tree_hostroot(sub, pub.ctx, pub.nsquare)
                out = out.at[:, idx].set(inv[:, :len(idx)])
                out.block_until_ready()
                return out

            t_muln = timeit(mul_ctpt_neg)
            results[f"BM_Mul_CTPT_neg50/{tag}"] = t_muln
            log(f"BM_Mul_CTPT_neg50/{tag}: {t_muln * 1e6:.0f} us "
                f"({B / t_muln:.0f} ops/s, "
                f"{t_muln / t_mul:.2f}x positive mul)")

        def encrypt_e2e():
            out = pub.encrypt(vals, apply_obfuscator=True)
            out.block_until_ready()
            return out

        t_e2e = timeit(encrypt_e2e)
        results[f"Encrypt_e2e/{tag}"] = t_e2e
        log(f"Encrypt_e2e/{tag}: {t_e2e * 1e6:.0f} us "
            f"({B / t_e2e:.1f} enc/s incl. host encode and H2D)")

    return pub, priv, kd


def federated_1m(pub, priv, kd, results, rng):
    """1M-value federated aggregation, single card.

    Two parties' 2^20-value encrypted updates are aggregated elementwise
    (HE add = modmul) and reduced to one encrypted total; the total is
    decrypted and verified against the plaintext oracle."""
    import jax.numpy as jnp

    B0, B = 16384, 1 << 20
    vals_a = [int(v) for v in rng.integers(0, 2**40, size=B0)]
    vals_b = [int(v) for v in rng.integers(0, 2**40, size=B0)]
    ct_a0 = pub.encrypt(vals_a, apply_obfuscator=False)
    ct_b0 = pub.encrypt(vals_b, apply_obfuscator=False)
    # tile to 1M columns (the aggregation workload is what's measured;
    # repeating ciphertexts keeps the plaintext oracle computable)
    reps = B // B0
    idx = jnp.asarray(np.arange(B, dtype=np.int32) % B0)
    ct_a = jnp.take(ct_a0, idx, axis=1)
    ct_b = jnp.take(ct_b0, idx, axis=1)
    _sync(ct_a)
    _sync(ct_b)

    from pailliercryptolib_python_tpu.ops import montgomery as mg

    def agg_and_reduce():
        agg = mg.mont_mul(ct_a, ct_b, pub.ctx)
        total = pub.tree_reduce(agg, B)
        total.block_until_ready()
        return total

    t = timeit(agg_and_reduce, warmup=1, iters=2)
    results["BM_FederatedAgg_1M"] = t
    log(f"BM_FederatedAgg_1M: {t * 1e3:.0f} ms "
        f"({B / t / 1e6:.2f} M values/s aggregate+reduce)")

    total = agg_and_reduce()
    got = priv.decrypt_to_ints(total, 1)[0]
    expect = (sum(vals_a) + sum(vals_b)) * reps % kd["n"]
    assert got == expect, "1M federated aggregation total mismatch"
    log("1M federated aggregation: total verified")


def federated_e2e_1m(pub, priv, kd, results, rng):
    """FederatedE2E_1M: one MILLION distinct obfuscated encryptions fed
    through the full pipeline.

    64 parties × 16384 values: encode+pack+entropy on host, DJN comb
    encrypt on device, elementwise HE aggregation across parties as the
    batches arrive, final rotate-fold tree reduce, CRT decrypt of the
    total, verified against the plaintext oracle."""
    from pailliercryptolib_python_tpu.models import paillier as sch
    from pailliercryptolib_python_tpu.ops import montgomery as mg

    parties, B = 64, 16384
    t0 = time.perf_counter()
    total_plain = 0
    agg = None
    for _ in range(parties):
        vals = rng.integers(0, 2**40, size=B)
        total_plain += int(vals.sum())
        # engine-dispatched production encrypt
        ct = pub.encrypt([int(v) for v in vals], apply_obfuscator=True)
        agg = ct if agg is None else mg.mont_mul(agg, ct, pub.ctx)
    total = pub.tree_reduce(agg, B)
    got = priv.decrypt_to_ints(total, 1)[0]
    t = time.perf_counter() - t0
    assert got == total_plain % kd["n"], "FederatedE2E_1M total mismatch"
    n_vals = parties * B
    results["FederatedE2E_1M"] = t
    # attribution: per-party host-prep+H2D vs full encrypt
    vals = [int(v) for v in rng.integers(0, 2**40, size=B)]
    t0 = time.perf_counter()
    m_dev = pub.encodings_to_device(vals)
    digs = pub.sample_obfuscator_digits(B)
    _sync(m_dev)
    t_h2d = time.perf_counter() - t0
    t0 = time.perf_counter()
    ct = pub.encrypt(vals, apply_obfuscator=True)
    ct.block_until_ready()
    _sync(ct)
    t_full = time.perf_counter() - t0
    log(f"FederatedE2E_1M: {t * 1e3:.0f} ms wall for {n_vals} distinct "
        f"obfuscated encrypts + aggregate + reduce + decrypt "
        f"({n_vals / t:.0f} values/s end-to-end, total verified; "
        f"per-party split: host-prep+H2D {t_h2d * 1e3:.0f} ms, "
        f"full encrypt "
        f"{t_full * 1e3:.0f} ms)")


def op_suite_parity_mini(pk, sk, tag):
    """Asserted on-device round trip at a ladder rung (3072/4096):
    encrypt/decrypt, ct+ct, ct*pt with negatives."""
    rng = np.random.default_rng(13)
    x = rng.random(64) * 100
    y = rng.random(64) * 10 - 5
    ct_x, ct_y = pk.encrypt(x), pk.encrypt(y)
    assert np.allclose(sk.decrypt(ct_x), x, atol=1e-7), f"{tag} enc/dec"
    assert np.allclose(sk.decrypt(ct_x + ct_y), x + y, atol=1e-7), \
        f"{tag} add"
    assert np.allclose(sk.decrypt(ct_x * y), x * y, atol=1e-6), \
        f"{tag} mul(neg)"
    log(f"op-suite parity ({tag}): ok")


def main():
    global CARD
    from pailliercryptolib_python_tpu.utils import compile_cache
    cache = compile_cache.configure()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: JAX's device is {dev.platform!r}, "
                         f"not a GPU")
    from chip_smoke import card_line
    CARD = card_line().replace("\n", "; ")
    log(f"devices: {jax.devices()} ({dev.device_kind}); compile cache "
        f"{cache}")

    from pailliercryptolib_python_tpu.models import paillier as sch
    from pailliercryptolib_python_tpu.api import (
        PaillierPublicKey, PaillierPrivateKey)
    from pailliercryptolib_python_tpu.bindings.containers import (
        ipclPublicKey)
    from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints

    results = {}
    rng = np.random.default_rng(7)

    # ---- keygen (host-side prime search; reference BM_KeyGen) -----------
    # warm the persistent prime-search worker pool OUTSIDE the timed
    # region (one-time service startup: 2 spawned workers + imports)
    t0 = time.perf_counter()
    try:
        pool = sch._prime_pool()
        for f in [pool.submit(int, 1), pool.submit(int, 2)]:
            f.result(timeout=60)
        log(f"KeygenPool warmup: {(time.perf_counter() - t0) * 1e3:.0f} "
            f"ms (one-time; pool reused by every keygen)")
    except (OSError, RuntimeError, TimeoutError) as e:
        log(f"KeygenPool warmup failed ({type(e).__name__}: {e}); "
            f"keygen runs serial")
    for kb in (1024, 2048):
        t0 = time.perf_counter()
        sch.generate_key_ints(kb, True)
        log(f"BM_KeyGen/{kb}: {(time.perf_counter() - t0) * 1e6:.0f} us")

    # ---- 2048-bit suite + headline --------------------------------------
    pub, priv, kd = bench_key(2048, (16, 64, 1024, 4096), results, rng,
                              headline_B=16384, mul_neg=True)

    # ---- asserted device-side full-op parity gate ------------------------
    pub_ipcl = ipclPublicKey(None, _context=pub)
    pk = PaillierPublicKey(pub_ipcl)
    sk = PaillierPrivateKey(pub_ipcl, kd["p"], kd["q"])
    t0 = time.perf_counter()
    op_suite_parity(pk, sk)
    log(f"op-suite parity: ok (2048-bit full-op suite on device, "
        f"{time.perf_counter() - t0:.1f} s)")

    # ---- 1M-value federated aggregation ----------------------------------
    federated_1m(pub, priv, kd, results, rng)
    federated_e2e_1m(pub, priv, kd, results, rng)

    # ---- config ladder: 3072 @ 10k, 4096 smoke ---------------------------
    if os.environ.get("PAILLIER_BENCH_LADDER", "1") != "0":
        t0 = time.perf_counter()
        sch.generate_key_ints(3072, True)
        log(f"BM_KeyGen/3072: {(time.perf_counter() - t0) * 1e6:.0f} us")
        pub3, priv3, kd3 = bench_key(3072, (10240,), results, rng)
        pub3_ipcl = ipclPublicKey(None, _context=pub3)
        op_suite_parity_mini(PaillierPublicKey(pub3_ipcl),
                             PaillierPrivateKey(pub3_ipcl, kd3["p"],
                                                kd3["q"]), "3072")

        t0 = time.perf_counter()
        sch.generate_key_ints(4096, True)
        log(f"BM_KeyGen/4096: {(time.perf_counter() - t0) * 1e6:.0f} us")
        pub4, priv4, kd4 = bench_key(4096, (256,), results, rng)
        pub4_ipcl = ipclPublicKey(None, _context=pub4)
        op_suite_parity_mini(PaillierPublicKey(pub4_ipcl),
                             PaillierPrivateKey(pub4_ipcl, kd4["p"],
                                                kd4["q"]), "4096")

    # ---- headline metric --------------------------------------------------
    B = 16384
    t_pipeline = results["headline_host_s"] + results["headline_dev_s"]
    enc_per_s = B / t_pipeline
    log(f"Headline: {enc_per_s:.1f} enc/s (host pipeline "
        f"{results['headline_host_s'] * 1e3:.0f} ms + device "
        f"{results['headline_dev_s'] * 1e3:.0f} ms for B={B}); "
        f"device-path-only: {B / results['headline_dev_s']:.1f} enc/s")
    line = {
        "metric": "paillier_2048_encrypt_throughput",
        "value": round(enc_per_s, 1),
        "unit": "enc/s",
        "card": CARD,
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
