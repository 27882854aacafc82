"""Paillier / DJN scheme layer — keygen, encrypt, decrypt on device.

Batched re-design of the capabilities the reference consumes from the
external IPCL C++ core (intel/pailliercryptolib):

* keygen        — ipcl::generateKeypair: host-side prime search
                  (Miller-Rabin over Python ints; OS entropy), DJN setup.
* encrypt       — ipcl::PublicKey::encrypt: c = (1 + m*n) * obf mod n^2
                  with the g = n+1 shortcut; obfuscator hs^r (DJN, short
                  exponent) or r^n (plain Paillier).  Batched on device;
                  the DJN obfuscator uses a per-key fixed-base comb table
                  so an encryption costs zero squarings.
* decrypt       — ipcl::PrivateKey::decrypt: CRT-accelerated (mod p^2 and
                  mod q^2 exponentiations run fused in ONE batched kernel
                  of width 2B using per-element moduli).
* CT ops        — ciphertext add = modmul, ciphertext*plaintext = modexp,
                  re-randomization (applyObfuscator).

Ciphertexts live on device as uint32[L, B] limb arrays in the Montgomery
domain mod n^2 and only leave it at serialization/decryption boundaries.
"""

from __future__ import annotations

import secrets
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..ops.limb import (
    LIMB_BITS, LIMB_DTYPE, int_to_limbs, ints_to_limbs, limbs_to_ints,
    limbs_for_bits, big_mul, normalize, cond_sub,
)
from ..ops import montgomery as mg
from ..ops.reduction import exact_div
from ..utils import config as _config

# Window sizes: 4-bit windows for per-element-base exponentiation on the
# limb engine (table is (16, L, B)); wide windows for the fixed-base comb
# (table is per-key, shared across the batch, so the only per-encrypt cost
# is ceil(randbits/window) modmuls — window 12 cuts the 2048-bit DJN
# encrypt chain from 128 to 86 modmuls for a ~360MB/key device table).
# CPU (tests) defaults to window 8: the one-time table build is 11x
# smaller.  Both maxima plus the HBM budget that shrinks the per-key
# window live in utils.config (runtime knobs, SURVEY.md §5 config row).
WINDOW = 4

# Batch padding granularity: 128 columns; small batches pad to 8.
def pad_batch(b: int) -> int:
    if b <= 8:
        return 8
    step = 8 if b < 128 else 128
    return -(-b // step) * step


# ---------------------------------------------------------------------------
# Host-side keygen (SURVEY.md §3.1).  Prime search uses OS entropy +
# Miller-Rabin on Python ints (CPython pow is C-speed); this mirrors the
# role of IPP-Crypto's primality search in ipcl::generateKeypair.
# ---------------------------------------------------------------------------

def window_for(ebits: int, sliding: bool = False) -> int:
    """Exponent window with the fewest products for one exponentiation
    by an ebits-bit exponent: the table build plus the chain's
    multiplies (the ebits squarings do not depend on the window).

    Fixed window: 2^w - 2 table products + ceil(ebits / w) multiplies.
    Sliding window (odd powers only): 2^(w-1) table products + about
    ebits / (w + 1) multiplies.  Ties go to the smaller table."""
    def products(w):
        if sliding:
            return (1 << (w - 1)) + ebits / (w + 1)
        return (1 << w) - 2 + -(-ebits // w)
    return min(range(2, 9), key=products)


def _small_primes(limit: int = 8192):
    sieve = np.ones(limit, dtype=bool)
    sieve[:2] = False
    for i in range(2, int(limit ** 0.5) + 1):
        if sieve[i]:
            sieve[i * i::i] = False
    return [int(p) for p in np.nonzero(sieve)[0]]


_SMALL_PRIMES = _small_primes()


def _mr_round(n: int, d: int, r: int, a: int) -> bool:
    x = pow(a, d, n)
    if x == 1 or x == n - 1:
        return True
    for _ in range(r - 1):
        x = x * x % n
        if x == n - 1:
            return True
    return False


def is_probable_prime(n: int, rounds: int = 8) -> bool:
    """Miller-Rabin: one deterministic base-2 round + `rounds` random
    bases.  For uniformly random candidates (keygen) the composite
    escape probability is far below 4^-rounds."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES[:64]:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    if not _mr_round(n, d, r, 2):
        return False
    for _ in range(rounds):
        if not _mr_round(n, d, r, secrets.randbelow(n - 3) + 2):
            return False
    return True


def device_mr_base2(cands: list) -> np.ndarray:
    """One deterministic base-2 Miller-Rabin round for a batch of odd
    candidates, on device (SURVEY.md §7 "device-side bulk testing").

    Each candidate is its own modulus: the per-element-moduli Montgomery
    context batches all 2^d exponentiations (per-element exponents
    d = (n-1)/2^r) into one kernel chain, then runs the max-r squaring
    ladder with per-element masks.  Returns bool[len(cands)]: True iff
    the candidate passes (2^d == +/-1 or some square reaches n-1).
    Composites that pass base-2 are vanishingly rare for random
    candidates; callers confirm survivors with host random-base rounds.
    """
    B = len(cands)
    bits = max(int(c).bit_length() for c in cands)
    Bp = pad_batch(B)
    cands_p = list(cands) + [cands[-1]] * (Bp - B)
    L = limbs_for_bits(bits + 2)
    ctx = mg.MontCtx.for_moduli(cands_p, L)
    tz = np.array([((c - 1) & -(c - 1)).bit_length() - 1
                   for c in cands_p], dtype=np.int32)
    ds = [(c - 1) >> int(t) for c, t in zip(cands_p, tz)]
    n_win = max(1, -(-bits // WINDOW))
    digits = mg.exponent_digits(ds, n_win, WINDOW)
    two = jnp.asarray(ints_to_limbs([2] * Bp, L))
    x = mg.mont_exp(mg.to_mont(two, ctx), jnp.asarray(digits), ctx,
                    window=WINDOW)
    one = jnp.asarray(ints_to_limbs([1] * Bp, L))
    nm1 = jnp.asarray(ints_to_limbs([c - 1 for c in cands_p], L))
    smax = int(tz.max())

    def eq(a, b):
        return jnp.all(a == b, axis=0)

    xc = mg.from_mont(x, ctx)
    ok = eq(xc, one) | eq(xc, nm1)
    for i in range(1, smax):
        x = mg.mont_mul(x, x, ctx)
        xc = mg.from_mont(x, ctx)
        ok = ok | (eq(xc, nm1) & jnp.asarray(i < tz))
    return np.asarray(ok)[:B]


def _primes_from_window(base: int, mask, bits: int, bulk: bool) -> int | None:
    """First prime among the sieve survivors of one window, or None."""
    cands = []
    for j in range(len(mask)):
        if not mask[j]:
            continue
        cand = base + 2 * j
        if cand.bit_length() != bits:
            break
        cands.append(cand)
    if not cands:
        return None
    if bulk:
        passed = device_mr_base2(cands)
        for c, okflag in zip(cands, passed):
            if okflag and is_probable_prime(c):
                return c
        return None
    for c in cands:
        if is_probable_prime(c):
            return c
    return None


def generate_prime(bits: int) -> int:
    """Random prime: windowed native trial-division sieve (C extension,
    mirroring the role of IPP-Crypto's sieve inside ipcl::generateKeypair)
    + Miller-Rabin on the survivors.

    With config.keygen_device enabled ("1", or "auto" on the GPU for
    >= 1024-bit primes) the deterministic base-2 round runs
    device-batched over ALL sieve survivors of a window at once
    (device_mr_base2) — one batched modexp in place of the ~100+
    sequential host pow() calls it takes to hit a prime; host
    Miller-Rabin confirms the (rare) survivors.  The default is the host.
    """
    from .. import native

    cfg = _config.get_config().keygen_device
    bulk = (cfg == "1") or (cfg == "auto" and mg.platform() == "gpu"
                            and bits >= 1024)
    window = 2048
    while True:
        base = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        mask = native.sieve_window(base, window, _SMALL_PRIMES)
        got = _primes_from_window(base, mask, bits, bulk)
        if got is not None:
            return got


_PRIME_POOL = None
_POOL_BROKEN = False


def _pool_usable() -> bool:
    """Spawn re-imports the parent's __main__ in each worker: with a
    file-less __main__ (REPL/stdin) that fails, so skip the pool there
    (and permanently after any pool failure)."""
    if _POOL_BROKEN:
        return False
    import sys
    main = sys.modules.get("__main__")
    return main is None or hasattr(main, "__file__")


def _prime_pool():
    """Persistent 2-worker spawn pool for concurrent p/q prime searches.

    The two searches are embarrassingly parallel but CPython's bigint
    pow holds the GIL, so genuine overlap needs processes.  Spawned
    workers pay a one-time package import (~2 s) and then serve every
    subsequent keygen; they force the CPU jax platform and never touch
    a device (keygen is host-only), so the parent keeps the card to
    itself.
    """
    global _PRIME_POOL
    if _PRIME_POOL is None:
        import os
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        pool = ProcessPoolExecutor(
            2, mp_context=mp.get_context("spawn"),
            initializer=_prime_worker_init)
        # Spawn BOTH workers now, with only the package root on the
        # path and the CPU platform pinned: a worker must never reserve
        # the card's memory or wait on it.
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        saved = {k: os.environ.get(k)
                 for k in ("PYTHONPATH", "JAX_PLATFORMS")}
        try:
            os.environ["PYTHONPATH"] = pkg_root
            os.environ["JAX_PLATFORMS"] = "cpu"
            for f in [pool.submit(int, 0), pool.submit(int, 1)]:
                f.result(timeout=120)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        _PRIME_POOL = pool
    return _PRIME_POOL


def _prime_worker_init():
    import jax
    jax.config.update("jax_platforms", "cpu")


def generate_key_ints(n_length: int = 1024, enable_DJN: bool = True) -> dict:
    """Generate raw key material as Python ints.

    Matches ipcl::generateKeypair semantics: p, q of n_length/2 bits each,
    retried until n = p*q has exactly n_length bits; DJN setup draws x,
    h = -x^2 mod n, hs = h^n mod n^2, with obfuscator exponents of
    randbits = n_length//2 bits.

    For >= 2048-bit keys the p and q searches run CONCURRENTLY in the
    persistent worker pool (config.keygen_parallel; serial fallback on
    any pool failure).
    """
    global _POOL_BROKEN
    half = n_length // 2
    # auto-gate at 3072-bit keys: below that, one prime search (~0.2 s)
    # is cheaper than a cold pool spawn; the pool amortizes across
    # keygens either way once warm ("1" forces it for services)
    cfgp = _config.get_config().keygen_parallel
    use_pool = ((cfgp == "1") or (cfgp == "auto" and half >= 1536)) \
        and _pool_usable()
    while True:
        if use_pool:
            try:
                pool = _prime_pool()
                fp = pool.submit(generate_prime, half)
                fq = pool.submit(generate_prime, half)
                p, q = fp.result(), fq.result()
            except Exception:     # pool unavailable: degrade to serial
                use_pool = False
                _POOL_BROKEN = True
                continue
        else:
            p = generate_prime(half)
            q = generate_prime(half)
        if p == q:
            continue
        n = p * q
        if n.bit_length() == n_length:
            break
    out = {"n": n, "p": p, "q": q, "enable_DJN": enable_DJN, "bits": n_length}
    if enable_DJN:
        nsq = n * n
        x = secrets.randbelow(n - 1) + 1
        h = (-(x * x)) % n
        # hs = h^n mod n^2 via CRT: exponents reduce modulo the group
        # orders p(p-1) / q(q-1), so two half-width pows (~4x cheaper
        # than the direct 2n-bit pow) — and they overlap in the pool.
        psq, qsq = p * p, q * q
        args_p = (h % psq, n % (p * (p - 1)), psq)
        args_q = (h % qsq, n % (q * (q - 1)), qsq)
        if use_pool:
            try:
                pool = _prime_pool()
                fp = pool.submit(pow, *args_p)
                fq = pool.submit(pow, *args_q)
                hp, hq = fp.result(), fq.result()
            except Exception:
                hp, hq = pow(*args_p), pow(*args_q)
        else:
            hp, hq = pow(*args_p), pow(*args_q)
        qinv = pow(qsq, -1, psq)
        out["hs"] = (hq + qsq * ((qinv * (hp - hq)) % psq)) % nsq
        out["randbits"] = half
    return out


# ---------------------------------------------------------------------------
# Public (encryption) context.
# ---------------------------------------------------------------------------

def _rns_encrypt_engine(engine: str) -> bool:
    """Whether DJN encryption runs on the RNS comb ("rns"), the limb comb
    ("limb"), or by platform ("auto": RNS on the GPU, limb on the CPU)."""
    return engine == "rns" or (engine == "auto" and mg.platform() == "gpu")


class PublicContext:
    """Device-side state for one public key: Montgomery ctx mod n^2 and the
    lazily-built fixed-base comb table for the DJN obfuscator."""

    def __init__(self, n: int, bits: int | None = None,
                 enable_DJN: bool = True, hs: int | None = None,
                 randbits: int | None = None):
        self.n = n
        self.bits = bits or n.bit_length()
        self.nsquare = n * n
        self.enable_DJN = enable_DJN and hs is not None
        self.hs = hs
        self.randbits = randbits if randbits else (self.bits // 2)
        self.ctx = mg.MontCtx.for_modulus(self.nsquare)   # mod n^2
        self.L = self.ctx.num_limbs
        cfg = _config.get_config()
        max_w = (cfg.comb_window_accel if mg.platform() == "gpu"
                 else cfg.comb_window_cpu)
        # shrink the window until the per-key table fits the device budget
        self.comb_window = _config.choose_comb_window(
            randbits if randbits else (self.bits // 2), self.L, max_w)
        # When the RNS encrypt engine will carry this key, the binding
        # table is the RNS comb ((n_win, CH, 2^w) states, ~2x the limb
        # comb at 2048 and CH/L-ish wider at 4096): shrink the window
        # until IT fits, instead of locking large keys out of the fast
        # path (one step down — w=11 at 4096 — fits the same budget).
        if self.enable_DJN and _rns_encrypt_engine(cfg.encrypt_engine):
            mbits_r = -(-(2 * self.bits + 2) // 16) * 16
            if mbits_r <= 14000:
                from ..ops import rns as _rns
                CH = _rns.RnsBase.for_bits(mbits_r).CH
                cap = cfg.comb_hbm_budget_bytes // 2
                w = self.comb_window
                while w > 2 and \
                        -(-self.randbits // w) * CH * (1 << w) * 4 > cap:
                    w -= 1
                self.comb_window = w
        self.Ln = limbs_for_bits(self.bits)
        self.n_limbs = jnp.asarray(int_to_limbs(n, self.Ln)[:, None])
        # windows for exponents < n (ct*pt path)
        self.n_win_ct = -(-self.bits // WINDOW)
        # windows for the plain-Paillier obfuscator exponent (= n)
        self._n_digits = None
        self._comb = None
        self._rns_mul = None      # lazy (base, key, window) for ct*pt
        self._comb_rns = None     # lazy RNS-state comb table (encrypt)

    # -- lazily built per-key device tables --------------------------------

    @property
    def comb_table(self):
        """Comb table for hs: T[j][d] = hs^(d*2^(w*j)) mod n^2 (Montgomery),
        w = self.comb_window.  Built lazily; registered with the LRU comb
        registry so the total HBM across keys stays under
        config.comb_hbm_budget_bytes (least-recently-used keys drop their
        tables and rebuild on next use)."""
        if self._comb is None:
            if not self.enable_DJN:
                raise ValueError("comb_table: DJN disabled for this key")
            # The pow2 ladder is a strictly sequential squaring chain and
            # 1 element wide — on device it wastes 127/128 lanes of every
            # tile (~1 min at 2048-bit).  Host bigints run the same chain
            # in ~50 ms; only the WIDE combine stage runs on device.
            ladder = jnp.asarray(self._host_pow2_ladder())
            self._comb = mg.build_comb_table(ladder, self.ctx,
                                             self.comb_window)
            self._register_tables()
        else:
            _config.comb_registry.touch(self)
        return self._comb

    def _drop_comb(self) -> None:
        """Evict the cached comb tables (called by the LRU registry)."""
        self._comb = None
        self._comb_rns = None

    def _rns_enc_plan(self):
        """(base, key) for the RNS encrypt engine, or None.

        Gated on the RNS comb table's HBM footprint (2x-ish the limb
        comb): past half the comb budget (4096-bit keys at window 12)
        encryption stays on the limb path."""
        if not _rns_encrypt_engine(_config.get_config().encrypt_engine):
            return None
        plan = self._rns_mul_plan()     # same mod-n^2 base/key
        if plan is None:
            return None
        n_win = -(-self.randbits // self.comb_window)
        rns_bytes = n_win * plan[0].CH * (1 << self.comb_window) * 4
        if rns_bytes > _config.get_config().comb_hbm_budget_bytes // 2:
            return None
        return (plan[0], plan[1])

    @property
    def comb_rns(self):
        """The comb table's entries as RNS states of f*M: (n_win, CH,
        2^w) uint32, with f = hs^(d * 2^(w*j)) for entry [j][d].

        Built NATIVELY in RNS: the host pow2 ladder enters RNS once
        ((CH, randbits) — one plane matmul), then the table grows by
        bit-doubling: entries [2^b, 2^(b+1)) of every window are one
        batched RNS product of the existing entries with ladder column
        w*j+b, using the closure rns_mul(state(a*M), state(b*M)) =
        state(a*b*M).  w batched products of width n_win*2^b; this
        neither touches the positional comb nor materializes anything
        beyond the table itself."""
        if self._comb_rns is None:
            base, key = self._rns_enc_plan()
            w = self.comb_window
            n_win = -(-self.randbits // w)
            # 1. enter the host ladder: states of hs^(2^t) * M
            lad_pos = jnp.asarray(self._host_pow2_ladder())[:, :, 0].T
            # 2. bit-doubling build as ONE jitted program (every step is
            # table-wide and parallel)
            self._comb_rns = _build_comb_rns(
                lad_pos, base, key, w=w, n_win=n_win,
                randbits=self.randbits)
            self._register_tables()
        return self._comb_rns

    def _register_tables(self) -> None:
        """(Re-)register the live per-key device tables with the LRU HBM
        registry — the total of whichever of the limb comb and the RNS
        comb currently exist."""
        total = 0
        if self._comb is not None:
            total += _config.comb_table_bytes(self.randbits, self.L,
                                              self.comb_window)
        if self._comb_rns is not None:
            total += int(self._comb_rns.size) * 4
        if total:
            _config.comb_registry.register(self, total)

    def _host_pow2_ladder(self) -> np.ndarray:
        """P[t] = hs^(2^t) * R mod n^2 (Montgomery form) for t < randbits,
        computed with host bigints: (randbits, L, 1) uint32."""
        nsq = self.nsquare
        R = 1 << (LIMB_BITS * self.L)
        vals = []
        cur = self.hs % nsq
        for _ in range(self.randbits):
            vals.append(cur * R % nsq)
            cur = cur * cur % nsq
        return ints_to_limbs(vals, self.L).T[:, :, None]

    @property
    def n_exp_digits(self):
        """MSB-first WINDOW-bit digits of n (plain-Paillier obfuscator r^n)."""
        if self._n_digits is None:
            self._n_digits = jnp.asarray(
                mg.exponent_digits([self.n], self.n_win_ct, WINDOW)[:, 0])
        return self._n_digits

    # -- encodings host<->device -------------------------------------------

    def encodings_to_device(self, encodings: list,
                            pad_to: int | None = None) -> jnp.ndarray:
        """List of B ints (mod n) -> (Ln, B_pad) canonical device limbs.

        Small values (federated int payloads) pack and transfer only the
        limbs they need — power-of-two bucketed — and zero-extend on
        device, cutting host->device bytes by up to Ln/Lmin.

        Under config.fixed_shape_ops the fast path is disabled: every
        batch packs and transfers the full Ln limbs, so H2D size and the
        downstream program shape are independent of plaintext magnitude
        (the timing side channel the knob closes for the other ops)."""
        B = pad_to or pad_batch(len(encodings))
        Lb = self.transfer_limbs(
            max((int(e).bit_length() for e in encodings), default=1))
        if Lb < self.Ln:
            arr = ints_to_limbs(
                list(encodings) + [0] * (B - len(encodings)), Lb)
            return _zero_extend_rows(jnp.asarray(arr), self.Ln)
        arr = ints_to_limbs(list(encodings) + [0] * (B - len(encodings)), self.Ln)
        return jnp.asarray(arr)

    def transfer_limbs(self, maxbits: int) -> int:
        """Limb rows actually packed/transferred for a batch whose widest
        encoding has `maxbits` bits (power-of-two bucketed; always the
        full Ln under config.fixed_shape_ops)."""
        if _config.get_config().fixed_shape_ops:
            return self.Ln
        Lmin = max(1, limbs_for_bits(maxbits))
        if Lmin <= self.Ln // 2:
            return min(self.Ln, 1 << (Lmin - 1).bit_length())
        return self.Ln

    # -- core ops ------------------------------------------------------------

    def encrypt_raw(self, m_limbs: jnp.ndarray) -> jnp.ndarray:
        """(1 + m*n) mod n^2 in Montgomery form.  m_limbs: (Ln, B) < n."""
        return _encrypt_raw(m_limbs, self.n_limbs, self.ctx, self.L)

    def sample_obfuscator_digits(self, b: int, as_numpy: bool = False):
        """Random DJN exponents r (uniform over [0, 2^randbits)) as
        LSB-first base-2^comb_window digits, straight from OS entropy.

        With an 8-bit window the digits of a uniform r ARE uniform bytes;
        for other windows the bytes are bit-unpacked and regrouped — all
        numpy-vectorized, no bigint round trip.  Digits ship as uint16
        (windows <= 16) — half the H2D bytes; consumers cast at use."""

        def out(digs):
            d16 = digs.astype(np.uint16)
            return d16 if as_numpy else jnp.asarray(d16)
        B = pad_batch(b)
        w = self.comb_window
        n_win = -(-self.randbits // w)
        rbytes = -(-self.randbits // 8)
        raw = np.frombuffer(secrets.token_bytes(B * rbytes),
                            dtype=np.uint8).reshape(B, rbytes).copy()
        # zero excess top bits so r < 2^randbits (little-endian: top byte
        # is the last one)
        extra = 8 * rbytes - self.randbits
        if extra:
            raw[:, -1] &= (1 << (8 - extra)) - 1
        if w <= 16:
            from .. import native
            digs = native.extract_windows(raw.tobytes(), B, rbytes, w,
                                          n_win)
            if digs is not None:   # C ext available: one-pass extraction
                return out(digs)
        if w == 8:
            digs = np.zeros((n_win, B), dtype=np.uint32)
            take = min(n_win, rbytes)
            digs[:take] = raw[:, :take].T
            return out(digs)
        if w % 4 == 0 and w <= 16:
            # nibble-aligned windows: split bytes into nibbles (two
            # strided views) and weight-sum groups of w/4 — ~50x faster
            # than the unpackbits path at production batches
            g = w // 4
            need_nib = n_win * g
            nib = np.empty((B, 2 * rbytes), dtype=np.uint32)
            nib[:, 0::2] = raw & 0xF
            nib[:, 1::2] = raw >> 4
            if nib.shape[1] < need_nib:
                nib = np.pad(nib, ((0, 0), (0, need_nib - nib.shape[1])))
            grp = nib[:, :need_nib].reshape(B, n_win, g)
            wts = (np.uint32(1) << (4 * np.arange(g, dtype=np.uint32)))
            digs = (grp * wts).sum(axis=2, dtype=np.uint32)
            digs = np.ascontiguousarray(digs.T)
            return out(digs)
        bits = np.unpackbits(raw, axis=1, bitorder="little")  # (B, 8*rbytes)
        need = n_win * w
        if bits.shape[1] < need:
            bits = np.pad(bits, ((0, 0), (0, need - bits.shape[1])))
        bits = bits[:, :need].reshape(B, n_win, w)
        weights = (1 << np.arange(w, dtype=np.uint32))
        digs = (bits.astype(np.uint32) * weights).sum(axis=2, dtype=np.uint32)
        digs = np.ascontiguousarray(digs.T)
        return out(digs)

    def obfuscate(self, ct_mont: jnp.ndarray) -> jnp.ndarray:
        """Multiply in a fresh obfuscator (re-randomization / applyObfuscator,
        reference ipcl_python.py:97-101,342-346)."""
        B = ct_mont.shape[1]
        if self.enable_DJN:
            digits = self.sample_obfuscator_digits(B)
            plan = self._rns_enc_plan()
            if plan is not None:
                from ..ops import rns as _rns
                base, key = plan
                return _rns.rns_comb_product(
                    ct_mont, self.comb_rns, jnp.asarray(digits), base,
                    key, self.ctx, self.L, mont_input=True)
            return _obfuscate_djn(ct_mont, digits, self.comb_table, self.ctx)
        # plain Paillier: obf = r^n, r random in [1, n)
        rs = [secrets.randbelow(self.n - 1) + 1 for _ in range(B)]
        r = jnp.asarray(ints_to_limbs(rs, self.L))
        r_m = mg.to_mont(r, self.ctx)
        obf = mg.mont_exp(r_m, jnp.broadcast_to(self.n_exp_digits[:, None],
                                                (self.n_win_ct, B)),
                          self.ctx, window=WINDOW)
        return mg.mont_mul(ct_mont, obf, self.ctx)

    def encrypt(self, encodings: list, apply_obfuscator: bool = True,
                pad_to: int | None = None) -> jnp.ndarray:
        """Full encrypt: encodings (list of ints mod n) -> Montgomery cts.

        One H2D transfer of the encodings (+ obfuscator digits) and ONE
        fused device program — the whole pipeline (1+mn, Montgomery entry,
        comb gather, product chain) dispatches as a single call.  Device
        dispatch is asynchronous, so callers that chunk a batch (the
        hybridMode pipelining knob, utils/context.py) overlap the next
        chunk's host stage with this chunk's device stage."""
        m = self.encodings_to_device(encodings, pad_to)
        if apply_obfuscator and self.enable_DJN:
            digits = self.sample_obfuscator_digits(m.shape[1])
            plan = self._rns_enc_plan()
            if plan is not None:
                from ..ops import rns as _rns
                base, key = plan
                raw = _encrypt_raw_canonical(m, self.n_limbs, self.L)
                return _rns.rns_comb_product(
                    raw, self.comb_rns, jnp.asarray(digits), base, key,
                    self.ctx, self.L)
            return _encrypt_djn(m, digits, self.comb_table, self.n_limbs,
                                self.ctx, self.L)
        ct = self.encrypt_raw(m)
        if apply_obfuscator:
            ct = self.obfuscate(ct)
        return ct

    def host_encrypt(self, encodings: list,
                     apply_obfuscator: bool = True) -> list:
        """Pure-HOST bigint encrypt: canonical ciphertext ints.

        The CPU leg of the heterogeneous work split (the reference's
        IPP path behind hybridMode — ipcl_bindings.cpp:37-56): runs in
        a worker thread concurrently with the device program on the
        rest of the batch (api._hybrid_split_encrypt).  Bit-compatible
        with the device path (same scheme, fresh obfuscators)."""
        nsq = self.nsquare
        out = []
        for m in encodings:
            c = (1 + int(m) * self.n) % nsq
            if apply_obfuscator:
                if self.enable_DJN:
                    r = secrets.randbits(self.randbits)
                    c = c * pow(self.hs, r, nsq) % nsq
                else:
                    r = secrets.randbelow(self.n - 1) + 1
                    c = c * pow(r, self.n, nsq) % nsq
            out.append(c)
        return out

    def add_ct(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """HE addition: ciphertext modmul mod n^2 (both Montgomery)."""
        return mg.mont_mul(a, b, self.ctx)

    def _rns_mul_plan(self):
        """(base, key) for the RNS ct*pt engine, or None when disabled /
        the mod-n^2 channel count exceeds the engine's bound.  Built
        lazily once per key; the window is chosen per call
        (window_for)."""
        if self._rns_mul is None:
            # The RNS number system serves three ops (CRT decrypt, ct*pt,
            # encrypt comb); the mul/encrypt plan is enabled when EITHER
            # engine knob allows RNS, so encrypt_engine="rns" works even
            # with decrypt_engine="limb" (they were coupled before r5).
            cfg = _config.get_config()
            ok = (cfg.decrypt_engine in ("auto", "rns")
                  or cfg.encrypt_engine in ("auto", "rns"))
            plan = False
            if ok:
                from ..ops import rns as _rns
                mbits_r = -(-(2 * self.bits + 2) // 16) * 16
                if mbits_r <= 14000:
                    base = _rns.RnsBase.for_bits(mbits_r)
                    key = _rns.RnsModulus.build(base, self.nsquare, self.L)
                    plan = (base, key)
            self._rns_mul = plan
        return self._rns_mul or None

    def mul_pt(self, ct: jnp.ndarray, exponents: list) -> jnp.ndarray:
        """HE ct*pt: ct^e per element.  exponents: list of B ints >= 0.

        Engine: RNS per-element chain (ops/rns.rns_pow_elem) when the
        mod-n^2 channel count fits the engine's bound, else the
        positional-limb chain.  The exponent width is bucketed to a
        power of two (at most the bits of n) and the window chosen for
        it (window_for), so small exponents (the common case after the
        negative-plaintext rewrite) cost proportionally.
        With config.fixed_shape_ops the skip is disabled: every call
        runs the full mod-n window count, so device time is independent
        of plaintext magnitude (timing side-channel hygiene).
        """
        from ..ops import rns as _rns

        B0 = ct.shape[1]
        B = B0 if B0 >= 128 else max(8, 1 << (B0 - 1).bit_length())
        if B != B0:
            ones = jnp.broadcast_to(self.ctx.one, (ct.shape[0], B - B0))
            ct = jnp.concatenate([ct, ones], axis=1)
        exps = list(exponents) + [0] * (B - len(exponents))
        fixed = _config.get_config().fixed_shape_ops
        maxbits = max((int(e).bit_length() for e in exps), default=1)

        # Engine choice: the RNS chain pays a fixed 2^w-2-mul table build
        # + enter/exit, so tiny exponents (exponent-alignment factors,
        # ~2^diff) stay on the limb path; >= 8 windows amortizes it.
        rplan = self._rns_mul_plan()
        if rplan is not None and not fixed \
                and -(-maxbits // WINDOW) < 8:
            rplan = None
        if rplan is not None:
            base, key = rplan
            ebits = self.bits if fixed else min(
                self.bits, max(16, 1 << (maxbits - 1).bit_length()))
            w = window_for(ebits)
            digits = mg.exponent_digits(exps, -(-ebits // w), w)
            out = _rns.rns_pow_elem(ct, jnp.asarray(digits), base, key,
                                    self.ctx, w, self.L)
            return out if B == B0 else out[:, :B0]

        if fixed:
            n_win_needed = self.n_win_ct
        else:
            n_win_needed = max(1, -(-maxbits // WINDOW))
        n_win_total = max(self.n_win_ct, n_win_needed)
        digits = mg.exponent_digits(exps, n_win_total, WINDOW)
        win_start = n_win_total - n_win_needed
        out = mg.mont_exp(ct, digits, self.ctx, window=WINDOW,
                          win_start=win_start)
        return out if B == B0 else out[:, :B0]

    def gather_batch(self, ct: jnp.ndarray, idx: np.ndarray) -> jnp.ndarray:
        """Select/duplicate ciphertext columns: out[:, j] = ct[:, idx[j]].

        idx is padded to the batch granularity; the matmul path uses this
        to materialize the (m*n*k)-wide operand layout in one gather
        instead of the reference's per-element Python loop
        (ipcl_python.py:829-880)."""
        B = pad_batch(len(idx))
        full = np.zeros(B, dtype=np.int32)
        full[:len(idx)] = np.asarray(idx, dtype=np.int32)
        return jnp.take(ct, jnp.asarray(full), axis=1)

    def tree_reduce(self, ct: jnp.ndarray, b: int) -> jnp.ndarray:
        """HE sum of the first b ciphertexts: log2 rotate-modmul tree.

        Batched version of the reference's pad-to-power-of-two
        rotate-add loop (__padded_ct, ipcl_python.py:810-827); padding is
        the Montgomery one (= raw encryption of zero).  Returns (L, pad)
        with the total in column 0."""
        return self.segment_tree_reduce(ct, 1, b)

    def segment_tree_reduce(self, ct: jnp.ndarray, groups: int,
                            seg: int) -> jnp.ndarray:
        """Independent HE sums over `groups` contiguous segments of length
        `seg` (matmul reduction).  Input columns [g*seg, (g+1)*seg) hold
        group g; returns (L, pad(groups)) with group sums in order."""
        return _segment_tree_reduce(ct, self.ctx, groups, seg, self.L)

    def export_cts(self, ct_mont: jnp.ndarray, b: int) -> list:
        """Montgomery cts -> canonical Python ints (for pickle/getTexts)."""
        plain = mg.from_mont(ct_mont, self.ctx)
        return limbs_to_ints(np.asarray(plain))[:b]

    def import_cts(self, cts: list) -> jnp.ndarray:
        """Canonical ciphertext ints -> Montgomery device array."""
        B = pad_batch(len(cts))
        # pad with 1s (valid ciphertext of 0) to keep values in range
        arr = ints_to_limbs(list(cts) + [1] * (B - len(cts)), self.L)
        return mg.to_mont(jnp.asarray(arr), self.ctx)


@partial(jax.jit, static_argnames=("w", "n_win", "randbits"))
def _build_comb_rns(lad_pos, base, key, *, w, n_win, randbits):
    """Native in-RNS comb build: positional pow2 ladder (L, randbits) of
    hs^(2^t)*R -> (n_win, CH, 2^w) states of hs^(d*2^(w*j)) * M.

    Uses the closure rns_mul(state(a*M), state(b*M)) = state(a*b*M): the
    entries [2^b, 2^(b+1)) of every window are one batched RNS product
    of the already-built entries with ladder column w*j+b."""
    from ..ops import rns as _rns

    CH = base.CH
    lad = _rns.rns_enter(lad_pos, base, key)         # (CH, randbits)
    one = _rns.rns_one_state(base, key, 1)[:, 0]     # (CH,)
    pad_cols = n_win * w - randbits                  # identity bits past
    if pad_cols:                                     # the top of r
        lad = jnp.concatenate(
            [lad, jnp.broadcast_to(one[:, None], (CH, pad_cols))], axis=1)
    lad = lad.reshape(CH, n_win, w)
    T = jnp.stack([jnp.broadcast_to(one[:, None], (CH, n_win)),
                   lad[:, :, 0]], axis=2)            # (CH, n_win, 2)
    for b in range(1, w):
        half = 1 << b
        lad_b = jnp.broadcast_to(lad[:, :, b:b + 1], (CH, n_win, half))
        blk = _rns.rns_mont_mul(T.reshape(CH, n_win * half),
                                lad_b.reshape(CH, n_win * half),
                                base, key)
        T = jnp.concatenate([T, blk.reshape(CH, n_win, half)], axis=2)
    return T.transpose(1, 0, 2)                      # (n_win, CH, 2^w)


@partial(jax.jit, static_argnames=("Lh",))
def _crt_stage_reduce(ct_mont, Cp_lo, Cp_hi, Cq_lo, Cq_hi, sq_p, sq_q,
                      f2_p, f2_q, Lh):
    """CRT stage 1: reduce the MONTGOMERY-form mod-n^2 ciphertext into
    the p^2/q^2 domains — matmul residue fold.

    For input value X = c*R_n2: one byte-plane int8 matmul fold gives
    V === X (mod m), V < m*2^25; a 2-step short REDC gives X*2^-32,
    < 1.02m; one modmul by F2 = R_h^2 * 2^32 * R_n2^{-1} lands on the
    Montgomery form c*R_h — in place of an L-iteration positional REDC
    loop over the whole batch."""
    from ..ops.rns import residue_fold_limbs

    B = ct_mont.shape[1]

    def half(C_lo, C_hi, sq, f2):
        v = residue_fold_limbs(ct_mont, C_lo, C_hi, Lh)
        w = mg.mont_reduce_wide(v, sq, iters=2)    # X * 2^-32, < 1.02m
        return mg.mont_mul(w, jnp.broadcast_to(f2, (Lh, B)), sq)

    return jnp.concatenate([half(Cp_lo, Cp_hi, sq_p, f2_p),
                            half(Cq_lo, Cq_hi, sq_q, f2_q)], axis=1)


@partial(jax.jit, static_argnames=("n_win_dec",))
def _crt_stage_exp(base_m, sq_ctx, exp_digits_pq, n_win_dec):
    """CRT stage 2: the fused 2B-wide modexp (exponents p-1 | q-1)."""
    B = base_m.shape[1] // 2
    digits = jnp.concatenate([
        jnp.broadcast_to(exp_digits_pq[:, 0:1], (n_win_dec, B)),
        jnp.broadcast_to(exp_digits_pq[:, 1:2], (n_win_dec, B)),
    ], axis=1)
    u = mg.mont_exp(base_m, digits, sq_ctx, window=WINDOW)
    return mg.from_mont(u, sq_ctx)                 # c^{p-1} mod p^2 | q^2


@partial(jax.jit, static_argnames=("Lh", "Lq", "Ln"))
def _crt_stage_recombine(u, p_ctx, q_ctx, pinv_R, qinv_R, hpR, hqR,
                         p_limbs, q_limbs, pinvqR, Lh, Lq, Ln):
    """CRT stage 3: L-function (exact Hensel division), h-multiplies, and
    Garner recombination m = m_p + p*((m_q - m_p) * p^{-1} mod q).

    The t*h modmuls run as SHARED-modulus halves (one mod-p and one
    mod-q product) rather than one product over per-element moduli."""
    from ..ops.limb import sub_mod_base

    B = u.shape[1] // 2
    one_arr = jnp.zeros((Lh, 1), dtype=LIMB_DTYPE).at[0, 0].set(1)
    um1 = sub_mod_base(u, one_arr)
    dinv = jnp.concatenate([jnp.broadcast_to(pinv_R, (Lq, B)),
                            jnp.broadcast_to(qinv_R, (Lq, B))], axis=1)
    t = exact_div(um1, dinv, Lq)                   # (Lq, 2B) L-values

    mp = cond_sub(mg.mont_mul(t[:, :B],
                              jnp.broadcast_to(hpR, (Lq, B)), p_ctx),
                  p_limbs)
    mq = cond_sub(mg.mont_mul(t[:, B:],
                              jnp.broadcast_to(hqR, (Lq, B)), q_ctx),
                  q_limbs)

    mp_mod_q = cond_sub(mp, q_limbs)               # m_p < p < 2q
    q_minus = sub_mod_base(jnp.broadcast_to(q_limbs, (Lq, B)), mp_mod_q)
    diff = cond_sub(normalize(mq + q_minus), q_limbs)
    u2 = mg.mont_mul(diff, pinvqR, q_ctx)
    u2 = cond_sub(u2, q_limbs)                     # (Lq, B) < q
    pu = big_mul(u2, p_limbs, out_limbs=Ln)
    mp_pad = jnp.concatenate(
        [mp, jnp.zeros((Ln - Lq, B), dtype=LIMB_DTYPE)], axis=0)
    return normalize(pu + mp_pad)                  # < n


@partial(jax.jit, static_argnames=("groups", "seg", "L"))
def _segment_tree_reduce(ct, ctx, groups, seg, L):
    """One fused device program: scatter into power-of-two segments padded
    with the Montgomery one, then log2 FOLDING rounds — each round
    modmuls the upper half of every segment into the lower half, so the
    total work is ~2x one elementwise pass (the reference's __padded_ct
    rotate loop, ipcl_python.py:810-827, keeps full width every round)."""
    P = 1 << max(0, (seg - 1).bit_length())
    if seg == P and groups * P == ct.shape[1]:
        arr = ct
    else:
        arr = jnp.broadcast_to(ctx.one, (L, groups * P))
        src = np.arange(groups * seg, dtype=np.int32)
        dst = np.concatenate([np.arange(g * P, g * P + seg)
                              for g in range(groups)]).astype(np.int32)
        arr = arr.at[:, dst].set(jnp.take(ct, jnp.asarray(src), axis=1))
    width = P
    while width > 1:
        half = width // 2
        a3 = arr.reshape(L, groups, width)
        lo = a3[:, :, :half].reshape(L, groups * half)
        hi = a3[:, :, half:].reshape(L, groups * half)
        arr = mg.mont_mul(lo, hi, ctx)
        width = half
    out = jnp.zeros((L, pad_batch(groups)), dtype=LIMB_DTYPE)
    out = lax.dynamic_update_slice_in_dim(out, arr[:, :groups], 0, axis=1)
    # pad columns with the Montgomery one (a valid encryption of zero)
    if pad_batch(groups) > groups:
        pad_cols = jnp.broadcast_to(ctx.one,
                                    (L, pad_batch(groups) - groups))
        out = lax.dynamic_update_slice_in_dim(out, pad_cols, groups, axis=1)
    return out


@partial(jax.jit, static_argnames=("L",))
def _encrypt_raw(m_limbs, n_limbs, ctx, L):
    mn = big_mul(m_limbs, n_limbs, out_limbs=L)
    ct = normalize(mn.at[0].add(1))
    return mg.to_mont(ct, ctx)


@partial(jax.jit, static_argnames=("L",))
def _zero_extend_rows(x, L):
    """(Lb, B) -> (L, B) with zero rows appended (device-side)."""
    return jnp.pad(x, ((0, L - x.shape[0]), (0, 0)))


@partial(jax.jit, static_argnames=("L",))
def _encrypt_raw_canonical(m_limbs, n_limbs, L):
    """(1 + m*n) mod n^2 as CANONICAL limbs (the RNS encrypt entry)."""
    mn = big_mul(m_limbs, n_limbs, out_limbs=L)
    return normalize(mn.at[0].add(1))


@jax.jit
def _obfuscate_djn(ct_mont, digits, comb, ctx):
    """ct * hs^r via the per-key comb: per-window column gather + modmul
    (zero squarings), one window at a time — never materializing the
    (n_win, L, B) factor array."""
    return mg.mont_exp_fixed_base(comb, digits, ctx, acc0=ct_mont)


@partial(jax.jit, static_argnames=("L",))
def _encrypt_djn(m_limbs, digits, comb, n_limbs, ctx, L):
    """Fused DJN encrypt: (1 + m*n) -> Montgomery -> comb obfuscator."""
    mn = big_mul(m_limbs, n_limbs, out_limbs=L)
    ct = normalize(mn.at[0].add(1))
    ct = mg.mont_mul(ct, ctx.r2, ctx)
    return _obfuscate_djn(ct, digits, comb, ctx)


# ---------------------------------------------------------------------------
# Private (decryption) context — fused-CRT batched decryption.
# ---------------------------------------------------------------------------

class PrivateContext:
    def __init__(self, pub: PublicContext, p: int, q: int):
        if p * q != pub.n:
            raise ValueError("PrivateContext: p*q != n")
        self.pub = pub
        self.p, self.q = p, q
        n = pub.n
        # Half-width limb counts for mod p^2/q^2 and mod p/q work.
        self.Lh = limbs_for_bits(max((p * p).bit_length(),
                                     (q * q).bit_length()) + 2)
        self.Lq = limbs_for_bits(max(p.bit_length(), q.bit_length()) + 2)
        Lh, Lq = self.Lh, self.Lq
        psq, qsq = p * p, q * q
        Rh = 1 << (LIMB_BITS * Lh)     # Montgomery R for the p^2/q^2 domain
        Rq = 1 << (LIMB_BITS * Lq)     # Montgomery R for the p/q domain

        # h_p = L_p(g^{p-1} mod p^2)^{-1} mod p with g = n+1.
        g = n + 1
        self.hp = pow((pow(g, p - 1, psq) - 1) // p, -1, p)
        self.hq = pow((pow(g, q - 1, qsq) - 1) // q, -1, q)
        self.pinv_mod_q = pow(p, -1, q)

        # Per-element Montgomery contexts ([p^2]*B ++ [q^2]*B and
        # [p]*B ++ [q]*B) are built lazily per batch width — the whole CRT
        # runs as ONE fused batch of width 2B.
        self._sq_ctx_cache = {}
        self._p_ctx = mg.MontCtx.for_modulus(p, min_bits=LIMB_BITS * Lq)
        self._q_ctx = mg.MontCtx.for_modulus(q, min_bits=LIMB_BITS * Lq)
        # Shared-modulus mod-p^2 / mod-q^2 contexts (stage 1 and the RNS
        # exits).
        self._sq_p = mg.MontCtx.for_modulus(psq, min_bits=LIMB_BITS * Lh)
        self._sq_q = mg.MontCtx.for_modulus(qsq, min_bits=LIMB_BITS * Lh)

        # exponents p-1, q-1 as MSB-first digits (padded to same length)
        ebits = max((p - 1).bit_length(), (q - 1).bit_length())
        self.n_win_dec = -(-ebits // WINDOW)
        dig = mg.exponent_digits([p - 1, q - 1], self.n_win_dec, WINDOW)
        self.exp_digits_pq = jnp.asarray(dig)  # (n_win, 2)

        # RNS-Montgomery engine for the stage-2 exponentiation
        # (docs/RNS_DESIGN.md; ops/rns.py): channel residues + int8
        # matmul base extensions replace the schoolbook product.  Both
        # engines are exact; config.decrypt_engine selects ("auto" ->
        # rns).
        eng = _config.get_config().decrypt_engine
        self.use_rns = eng in ("auto", "rns")
        if self.use_rns:
            from ..ops import rns as _rns
            mb = max(psq.bit_length(), qsq.bit_length())
            mbits_r = -(-mb // 16) * 16   # round up: share cached bases
            self.rns_base = _rns.RnsBase.for_bits(mbits_r)
            self.rns_p = _rns.RnsModulus.build(self.rns_base, psq, Lh)
            self.rns_q = _rns.RnsModulus.build(self.rns_base, qsq, Lh)
            self.rns_window = _config.get_config().rns_exp_window
            nwr = -(-ebits // self.rns_window)
            digr = mg.exponent_digits([p - 1, q - 1], nwr, self.rns_window)
            self.rdig_p = jnp.asarray(digr[:, 0])
            self.rdig_q = jnp.asarray(digr[:, 1])
            # sliding-window schedule: odd-power table, no
            # multiplies-by-one on zero digits; the fixed schedule length
            # keeps the HLO key-independent
            self.rns_sched_window = window_for(ebits, sliding=True)
            self.rsched_p = jnp.asarray(_rns.sliding_schedule(
                p - 1, self.rns_sched_window, ebits))
            self.rsched_q = jnp.asarray(_rns.sliding_schedule(
                q - 1, self.rns_sched_window, ebits))

        # Stage-1 residue fold: the mod-p^2/q^2 reductions of the
        # mod-n^2 Montgomery ciphertext run as ONE byte-plane int8
        # matmul against C[j,l] = limb j of 2^(16l) mod m, a 2-step
        # short REDC, and one modmul by the folded constant
        # F2 = R_h^2 * 2^32 * R_n2^{-1}.  The C planes and F2 are
        # per-key jit ARGUMENTS (key-independent HLO).
        from ..ops import rns as _rns_mod
        Rn2 = 1 << (LIMB_BITS * pub.L)
        self.Cp_lo, self.Cp_hi = map(jnp.asarray, _rns_mod._residue_planes_np(
            psq, Lh, pub.L))
        self.Cq_lo, self.Cq_hi = map(jnp.asarray, _rns_mod._residue_planes_np(
            qsq, Lh, pub.L))
        f2p = pow(Rh, 2, psq) * pow(2, 32, psq) % psq \
            * pow(Rn2, -1, psq) % psq
        f2q = pow(Rh, 2, qsq) * pow(2, 32, qsq) % qsq \
            * pow(Rn2, -1, qsq) % qsq
        self.f2_p = jnp.asarray(int_to_limbs(f2p, Lh)[:, None])
        self.f2_q = jnp.asarray(int_to_limbs(f2q, Lh)[:, None])
        # exact-division inverses: p^{-1}, q^{-1} mod 2^(16*Lq)
        self.pinv_R = jnp.asarray(int_to_limbs(pow(p, -1, Rq), Lq)[:, None])
        self.qinv_R = jnp.asarray(int_to_limbs(pow(q, -1, Rq), Lq)[:, None])
        # Montgomery-form multipliers (x*R mod m) so t*h costs ONE modmul.
        self.hpR = jnp.asarray(int_to_limbs(self.hp * Rq % p, Lq)[:, None])
        self.hqR = jnp.asarray(int_to_limbs(self.hq * Rq % q, Lq)[:, None])
        self.pinvqR = jnp.asarray(
            int_to_limbs(self.pinv_mod_q * Rq % q, Lq)[:, None])
        self.p_limbs = jnp.asarray(int_to_limbs(p, Lq)[:, None])
        self.q_limbs = jnp.asarray(int_to_limbs(q, Lq)[:, None])

    def _sq_ctx(self, B: int) -> mg.MontCtx:
        if B not in self._sq_ctx_cache:
            self._sq_ctx_cache[B] = mg.MontCtx.for_moduli(
                [self.p * self.p] * B + [self.q * self.q] * B, self.Lh)
        return self._sq_ctx_cache[B]

    def _stage_reduce(self, ct_mont: jnp.ndarray) -> jnp.ndarray:
        """Stage 1 with this key's residue planes / folded constants."""
        return _crt_stage_reduce(ct_mont, self.Cp_lo, self.Cp_hi,
                                 self.Cq_lo, self.Cq_hi, self._sq_p,
                                 self._sq_q, self.f2_p, self.f2_q,
                                 self.Lh)

    def decrypt_to_ints(self, ct_mont: jnp.ndarray, b: int) -> list:
        """Batched CRT decrypt: Montgomery cts mod n^2 -> plaintext ints.
        Device program (decrypt_device) + D2H + C-ext limb unpack."""
        return limbs_to_ints(np.asarray(self.decrypt_device(ct_mont)))[:b]

    def decrypt_device(self, ct_mont: jnp.ndarray) -> jnp.ndarray:
        """The device-side CRT decrypt: Montgomery cts mod n^2 ->
        canonical plaintext limbs (Ln, B) still on device.

        Stage 2 runs the mod-p^2 and mod-q^2 exponentiations as two RNS
        chains, or (limb engine) FUSED as one batch of width 2B using
        per-element moduli (the reference backend runs them as separate
        CPU loops inside ipcl::PrivateKey::decrypt).
        """
        B0 = ct_mont.shape[1]
        # Bucket small batch widths to powers of two: every distinct
        # width compiles its own (large) decrypt program, and matmul
        # outputs arrive at many odd widths.  Padding columns hold the
        # Montgomery one (a valid encryption of zero).
        B = B0 if B0 >= 128 else max(8, 1 << (B0 - 1).bit_length())
        if B != B0:
            pad_cols = jnp.broadcast_to(self.pub.ctx.one,
                                        (ct_mont.shape[0], B - B0))
            ct_mont = jnp.concatenate([ct_mont, pad_cols], axis=1)
        # Three jitted stages, each compiled once per width.
        base_m = self._stage_reduce(ct_mont)
        if self.use_rns:
            u_p, u_q = self._rns_exp_halves(base_m)
            u = jnp.concatenate([u_p, u_q], axis=1)
        else:
            u = _crt_stage_exp(base_m, self._sq_ctx(B), self.exp_digits_pq,
                               self.n_win_dec)
        out = _crt_stage_recombine(
            u, self._p_ctx, self._q_ctx, self.pinv_R, self.qinv_R,
            self.hpR, self.hqR, self.p_limbs, self.q_limbs, self.pinvqR,
            self.Lh, self.Lq, self.pub.Ln)
        return out if B == B0 else out[:, :B0]

    def _rns_exp_halves(self, base_m: jnp.ndarray):
        """Stage 2 on the RNS engine: the two half-width exponentiations
        as enter -> shared-exponent chain -> SK exit (ops/rns.py)."""
        from ..ops import rns as _rns

        B = base_m.shape[1] // 2
        u_p = _rns.rns_crt_exp_sched(base_m[:, :B], self.rsched_p,
                                     self.rns_base, self.rns_p,
                                     self._sq_p, self.rns_sched_window,
                                     self.Lh)
        u_q = _rns.rns_crt_exp_sched(base_m[:, B:], self.rsched_q,
                                     self.rns_base, self.rns_q,
                                     self._sq_q, self.rns_sched_window,
                                     self.Lh)
        return u_p, u_q

    def profile_stages(self, ct_mont: jnp.ndarray, b: int) -> dict:
        """Per-stage thunks for a stage breakdown (bench.py).

        Each thunk runs one decrypt stage on the inputs the production
        path would hand it; callers time them individually."""
        B = ct_mont.shape[1]
        base_m = self._stage_reduce(ct_mont)
        base_m.block_until_ready()
        if self.use_rns:
            u_p, u_q = self._rns_exp_halves(base_m)
            u = jnp.concatenate([u_p, u_q], axis=1)
        else:
            u = _crt_stage_exp(base_m, self._sq_ctx(B), self.exp_digits_pq,
                               self.n_win_dec)
        u.block_until_ready()
        m = _crt_stage_recombine(
            u, self._p_ctx, self._q_ctx, self.pinv_R, self.qinv_R,
            self.hpR, self.hqR, self.p_limbs, self.q_limbs, self.pinvqR,
            self.Lh, self.Lq, self.pub.Ln)
        m.block_until_ready()
        stages = {
            "stage1_reduce": lambda: self._stage_reduce(ct_mont),
            "stage3_recombine": lambda: _crt_stage_recombine(
                u, self._p_ctx, self._q_ctx, self.pinv_R, self.qinv_R,
                self.hpR, self.hqR, self.p_limbs, self.q_limbs,
                self.pinvqR, self.Lh, self.Lq, self.pub.Ln),
            "stage4_d2h": lambda: np.asarray(m),
            "stage5_to_ints": lambda: limbs_to_ints(np.asarray(m))[:b],
        }
        if self.use_rns:
            from ..ops import rns as _rns
            stages["stage2_rns_p_half"] = lambda: _rns.rns_crt_exp_sched(
                base_m[:, :B], self.rsched_p, self.rns_base, self.rns_p,
                self._sq_p, self.rns_sched_window, self.Lh)
            stages["stage2_rns_q_half"] = lambda: _rns.rns_crt_exp_sched(
                base_m[:, B:], self.rsched_q, self.rns_base, self.rns_q,
                self._sq_q, self.rns_sched_window, self.Lh)
        else:
            stages["stage2_exp"] = lambda: _crt_stage_exp(
                base_m, self._sq_ctx(B), self.exp_digits_pq, self.n_win_dec)
        return stages
