"""Public HE API: PaillierKeypair / PublicKey / PrivateKey / EncryptedNumber.

Drop-in parity with the reference Python API
(/root/reference/src/ipcl_python/ipcl_python.py) — same classes, operator
algebra (SURVEY.md §2.3), exceptions and pickle state tuples — but every
operation is re-designed batched-first for the device:

* encode/decode are numpy-vectorized (the reference loops Python per
  element, ipcl_python.py:136-139, 238-243);
* exponent alignment is ONE batched modexp with per-element exponents
  2^diff (the reference gathers/scatters sub-batches through C++ calls,
  ipcl_python.py:570-741);
* sum/dot/matmul reductions are device-side log2 rotate-modmul trees
  (the reference's __padded_ct rotate loop, ipcl_python.py:810-827, runs
  per output element in Python);
* matmul materializes the (m*n*k) operand layout with one device gather
  (the reference iterates a Python generator per element,
  ipcl_python.py:777-880).

Known reference quirks handled deliberately:
* `PaillierPublicKey.__init__`'s `self = key` branch (ipcl_python.py:60-61)
  is a no-op bug upstream; here copy-construction actually works.
* length-1 ciphertexts decrypt to a scalar, not a 1-array (:217, :245) —
  reproduced.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import jax.numpy as jnp

from .fixedpoint import (FixedPointNumber, encode_vector, decode_vector,
                         decode_limbs_vector)
from .models import paillier
from .bindings.containers import (
    BigNumber,
    ipclBigNumber,
    ipclKeypair,
    ipclPublicKey,
    ipclPrivateKey,
    ipclPlainText,
    ipclCipherText,
)


class BNUtils:
    """Python int <-> BigNumber converters (reference ipcl_python.py:933-977)."""

    @staticmethod
    def int2Bytes(val: int) -> bytes:
        return val.to_bytes((val.bit_length() + 7) // 8, byteorder="little")

    @staticmethod
    def bytes2Int(val: bytes) -> int:
        return int.from_bytes(val, "little")

    @staticmethod
    def int2BN(val: int) -> BigNumber:
        if val == 0:
            return ipclBigNumber.Zero
        if val == 1:
            return ipclBigNumber.One
        if val == 2:
            return ipclBigNumber.Two
        return BigNumber(BNUtils.int2Bytes(val))

    @staticmethod
    def BN2int(val: BigNumber) -> int:
        return BNUtils.bytes2Int(val.to_bytes())


class PaillierKeypair:
    @staticmethod
    def generate_keypair(n_length: int = 1024, enable_DJN: bool = True
                         ) -> Tuple["PaillierPublicKey", "PaillierPrivateKey"]:
        """Generate a keypair (reference ipcl_python.py:20-40; keygen itself
        mirrors ipcl::generateKeypair — see models/paillier.py)."""
        pub, pri = ipclKeypair.generate_keypair(n_length, enable_DJN)
        return PaillierPublicKey(pub), PaillierPrivateKey(pri)


_HOST_ENC_POOL = None


def _host_pool():
    global _HOST_ENC_POOL
    if _HOST_ENC_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _HOST_ENC_POOL = ThreadPoolExecutor(max_workers=1)
    return _HOST_ENC_POOL


def _hybrid_split_encrypt(pctx, encodings, apply_obfuscator):
    """Concurrent host/device encrypt split, or None when inactive.

    The realization of the reference's QAT:CPU work-split
    (hybridMode ratios, ipcl_bindings.cpp:37-56): the host share of the
    batch encrypts with pure bigint pow in a worker thread WHILE the
    device program runs on the rest (the main thread's device sync
    releases the GIL, so the overlap is real).  Gated, like the
    reference, on context.initializeContext having been called."""
    from .utils import config as _config
    from .utils.context import context as _context
    from .models.paillier import pad_batch
    import jax.numpy as jnp

    ratio = _config.get_config().encrypt_host_ratio
    B = len(encodings)
    if ratio <= 0 or not _context._initialized or B < 2:
        return None
    nh = B if ratio >= 1 else min(B, max(1, int(B * ratio)))
    fut = _host_pool().submit(pctx.host_encrypt, encodings[B - nh:],
                              apply_obfuscator)
    dev = pctx.encrypt(encodings[:B - nh], apply_obfuscator) \
        if nh < B else None    # async dispatch; overlaps the host leg
    host_dev = pctx.import_cts(fut.result())
    if dev is None:
        cols = host_dev[:, :nh]
    else:
        cols = jnp.concatenate([dev[:, :B - nh], host_dev[:, :nh]],
                               axis=1)
    BP = pad_batch(B)
    if cols.shape[1] < BP:
        pad = jnp.broadcast_to(pctx.ctx.one,
                               (cols.shape[0], BP - cols.shape[1]))
        cols = jnp.concatenate([cols, pad], axis=1)
    return cols


class PaillierPublicKey:
    def __init__(self, key, n_length: Optional[int] = None,
                 enable_DJN: Optional[bool] = None):
        if isinstance(key, ipclPublicKey):
            self.n = key.context.n
            self.pubkey = key
        elif isinstance(key, PaillierPublicKey):
            self.n = key.n
            self.pubkey = key.pubkey
        elif isinstance(key, int) and n_length is not None \
                and enable_DJN is not None:
            self.n = key
            self.pubkey = ipclPublicKey(key, n_length, enable_DJN)
        else:
            raise ValueError(
                "PaillierPublicKey: PubKey should be either key value (n),"
                "PaillierPublicKey or IPP-PaillierPublicKey object")
        self.max_int = self.n // 3 - 1
        self.nsquare = self.n * self.n

    def __getstate__(self):
        return self.pubkey

    def __setstate__(self, state):
        self.pubkey = state
        self.n = self.pubkey.context.n
        self.max_int = self.n // 3 - 1
        self.nsquare = self.n * self.n

    def __repr__(self):
        return repr(self.pubkey)

    def __eq__(self, other):
        return self.n == other.n

    def __hash__(self):
        return hash(self.pubkey)

    def apply_obfuscator(self, x):
        if isinstance(x, int):
            return self.pubkey.apply_obfuscator(BNUtils.int2BN(x))
        return self.pubkey.apply_obfuscator(x)

    def raw_encrypt(self, plaintext) -> "PaillierEncryptedNumber":
        return self.encrypt(plaintext, apply_obfuscator=False)

    def encrypt(self, values, apply_obfuscator: bool = True
                ) -> "PaillierEncryptedNumber":
        """Vectorized encrypt of a scalar or 1-D batch.

        With config.encrypt_pipeline_chunks > 1 (the hybridMode knob,
        utils/context.py) large batches run chunked: each chunk's host
        stage (fixed-point encode, limb pack, entropy) overlaps the
        previous chunk's asynchronously dispatched device program."""
        from .utils import config as _config
        from .models.paillier import pad_batch
        import jax.numpy as jnp

        if np.isscalar(values):
            values = [values]

        arr = np.asarray(values)
        if arr.dtype.kind not in "fiu":
            if not all(isinstance(v, (int, float, np.integer, np.floating))
                       for v in values):
                raise ValueError(
                    "PaillierPublicKey.encrypt: input value(s) should be "
                    "integer or float")

        B = len(values)
        chunks = _config.get_config().encrypt_pipeline_chunks
        split_active = (_config.get_config().encrypt_host_ratio > 0)
        if chunks > 1 and not split_active and B >= 256 * chunks:
            csize = pad_batch(-(-B // chunks))
            sliceable = arr if arr.dtype.kind in "fiu" else values
            devs, expos_parts = [], []
            for i in range(0, B, csize):
                encs, exps = encode_vector(sliceable[i:i + csize],
                                           self.n, self.max_int)
                devs.append(self.pubkey.context.encrypt(
                    encs, apply_obfuscator, pad_to=csize))
                expos_parts.append(exps)
            ct_dev = jnp.concatenate(devs, axis=1)[:, :pad_batch(B)]
            expos = np.concatenate(expos_parts)
            ct = ipclCipherText(self.pubkey, _dev=ct_dev, _length=B)
            return PaillierEncryptedNumber(self, ct, exponents=expos,
                                           length=B)

        encodings, expos = encode_vector(values, self.n, self.max_int)
        ct_dev = _hybrid_split_encrypt(self.pubkey.context, encodings,
                                       apply_obfuscator)
        if ct_dev is None:
            ct_dev = self.pubkey.context.encrypt(encodings,
                                                 apply_obfuscator)
        ct = ipclCipherText(self.pubkey, _dev=ct_dev, _length=len(encodings))
        return PaillierEncryptedNumber(self, ct, exponents=expos,
                                       length=len(encodings))


class PaillierPrivateKey:
    def __init__(self, key, p: Optional[int] = None, q: Optional[int] = None):
        if isinstance(key, ipclPrivateKey):
            self.prikey = key
            self.__n = key.context.pub.n
        elif isinstance(key, ipclPublicKey) and p is not None and q is not None:
            self.prikey = ipclPrivateKey(key, BNUtils.int2BN(p),
                                         BNUtils.int2BN(q))
            self.__n = key.context.n
        elif isinstance(key, PaillierPublicKey) and p is not None \
                and q is not None:
            self.prikey = ipclPrivateKey(key.pubkey, BNUtils.int2BN(p),
                                         BNUtils.int2BN(q))
            self.__n = key.n
        else:
            raise KeyError(
                "PaillierPrivateKey: key should be either Private key or"
                " Public key (with p and q)")
        self.__max_int = self.__n // 3 - 1

    def __getstate__(self):
        return (self.prikey, self.__n, self.__max_int)

    def __setstate__(self, state):
        (self.prikey, self.__n, self.__max_int) = state

    def __eq__(self, other: "PaillierPrivateKey"):
        return (self.prikey.p == other.prikey.p) and (
            self.prikey.q == other.prikey.q)

    def __hash__(self):
        return hash(self.prikey)

    def __repr__(self):
        return repr(self.prikey)

    def raw_decrypt(self, ciphertext: "PaillierEncryptedNumber"):
        if ciphertext.public_key.n != self.__n:
            raise ValueError(
                "PaillierPrivateKey.raw_decrypt: Public key mismatch")
        ct = ciphertext.ciphertext()
        ret = self.prikey.context.decrypt_to_ints(ct.device_array(), len(ct))
        return ret if len(ciphertext) > 1 else ret[0]

    def decrypt(self, encrypted_number: "PaillierEncryptedNumber"):
        """Batched decrypt + C-path fixed-point decode straight off the
        plaintext limb array (no intermediate Python-int unpack)."""
        if encrypted_number.public_key.n != self.__n:
            raise ValueError("PailierPrivateKey.decrypt: Public key mismatch")
        ct = encrypted_number.ciphertext()
        m_dev = self.prikey.context.decrypt_device(ct.device_array())
        ret = decode_limbs_vector(np.asarray(m_dev), len(ct),
                                  encrypted_number._expos_np(),
                                  self.__n, self.__max_int)
        return ret if len(encrypted_number) > 1 else ret[0]


class PaillierEncryptedNumber:
    """Vectorized ciphertext with per-element exponents.

    State mirrors the reference (:249-270): public_key, an opaque
    ciphertext container, per-element exponents, and a length — but the
    container is device-resident and every operator below is one (or a
    few) batched device kernels instead of Python loops.
    """

    # Make numpy defer to our reflected operators (pt_array @ ct,
    # pt_array + ct, ...) instead of trying to broadcast over the object.
    __array_priority__ = 1000

    def __init__(self, public_key: PaillierPublicKey,
                 ciphertext: ipclCipherText, exponents, length: int):
        if ciphertext.public_key != public_key.pubkey:
            raise ValueError("PaillierEncryptedNumber: public key mismatch")
        self.__expos = np.asarray(exponents, dtype=np.int64).reshape(-1)
        self.public_key = public_key
        self.__ct = ciphertext
        self.__length = length

    # -- plumbing -----------------------------------------------------------

    def __repr__(self):
        return repr(self.__ct)

    def __getstate__(self) -> tuple:
        return (self.public_key, len(self), self.exponent(),
                self.__ct.host_ints())

    def __setstate__(self, state: tuple):
        (self.public_key, self.__length, expos, ints) = state
        self.__expos = np.asarray(expos, dtype=np.int64).reshape(-1)
        self.__ct = ipclCipherText(self.public_key.pubkey, _ints=ints)

    def __len__(self) -> int:
        return self.__length

    def length(self) -> int:
        return self.__length

    def ciphertext(self) -> ipclCipherText:
        return self.__ct

    def ciphertextBN(self, idx: Optional[int] = None):
        if idx is None:
            return self.__ct.getTexts()
        if not 0 <= idx < self.__length:
            raise IndexError("ciphertext: idx out of range")
        return self.__ct[idx]

    def exponent(self, idx: Optional[int] = None):
        if idx is None:
            return [int(e) for e in self.__expos]
        if not 0 <= idx < self.__length:
            raise IndexError("exponent: idx out of range")
        return int(self.__expos[idx])

    def _expos_np(self) -> np.ndarray:
        return self.__expos

    def apply_obfuscator(self):
        ctx = self.public_key.pubkey.context
        dev = ctx.obfuscate(self.__ct.device_array())
        self.__ct = ipclCipherText(self.public_key.pubkey, _dev=dev,
                                   _length=self.__length)

    def __getitem__(self, key: Union[int, slice]) -> "PaillierEncryptedNumber":
        if isinstance(key, int):
            key = slice(key, key + 1)
        if not 0 <= key.stop <= len(self) or not 0 <= key.start < len(self):
            raise IndexError("__getitem__: key out of range")
        newCT = self.__ct[key]
        return PaillierEncryptedNumber(self.public_key, newCT,
                                       self.__expos[key], len(newCT))

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    # -- helpers ------------------------------------------------------------

    def _ctx(self):
        return self.public_key.pubkey.context

    def _scale_by_pow2(self, ct_dev, diffs: np.ndarray):
        """ct * BASE^diff per element (exponent alignment primitive).

        One batched modexp with per-element exponents 2^diff; elements
        with diff == 0 exponentiate by 1 (identity).
        """
        if not np.any(diffs > 0):
            return ct_dev
        exps = [1 << int(d) if d > 0 else 1 for d in diffs]
        return self._ctx().mul_pt(ct_dev, exps)

    def increase_exponent_to(self, x_ct: ipclCipherText, x_expo,
                             exponent: int) -> ipclCipherText:
        """Raise ciphertext elements to a target fixed-point exponent.

        Reference public method (ipcl_python.py:528-568): every element
        whose exponent is below `exponent` is multiplied by
        BASE^(exponent - x_expo[i]); elements at or above the target are
        returned unchanged (the reference does not error on them).  Here
        the per-element factors run as ONE batched modexp instead of the
        reference's gather/scatter through C++ sub-containers.
        """
        expo_diff = exponent - np.fromiter(x_expo, np.int64)
        if not np.any(expo_diff > 0):
            return x_ct
        dev = self._scale_by_pow2(x_ct.device_array(),
                                  np.maximum(expo_diff, 0))
        return ipclCipherText(self.public_key.pubkey, _dev=dev,
                              _length=len(x_ct))

    def _invert_columns(self, ct_dev, flags: np.ndarray, b: int):
        """Invert flagged ciphertext columns mod n^2, on device.

        Gathers only the flagged columns, inverts them with Montgomery's
        product-tree batch inversion (one single-column xgcd + O(F)
        modmuls — ops.montgomery.mont_inv_tree), and scatters back.  The
        reference instead round-trips every element through host
        gmpy2.invert (ipcl_python.py:272-276).

        With config.fixed_shape_ops the whole batch is inverted
        unconditionally and flagged columns selected with a lane mask —
        no data-dependent gather shape, so the device program (and its
        timing) is independent of the plaintext sign pattern."""
        from .ops import montgomery as mg
        from .utils import config as _config
        import jax.numpy as jnp
        ctx = self._ctx()
        if _config.get_config().fixed_shape_ops:
            inv = mg.mont_inv_tree_hostroot(ct_dev, ctx.ctx, ctx.nsquare)
            mask = np.zeros(ct_dev.shape[1], dtype=bool)
            mask[:len(flags)] = flags
            return jnp.where(jnp.asarray(mask)[None, :], inv, ct_dev)
        idx = np.nonzero(flags)[0].astype(np.int32)
        sub = ctx.gather_batch(ct_dev, idx)          # (L, pad(F))
        inv = mg.mont_inv_tree_hostroot(sub, ctx.ctx, ctx.nsquare)
        return ct_dev.at[:, jnp.asarray(idx)].set(inv[:, :len(idx)])

    # -- addition / subtraction ---------------------------------------------

    def __add__(self, other):
        if self.__length == 1 and isinstance(other, PaillierEncryptedNumber) \
                and len(other) > 1:
            return other.__raw_add(self)
        return self.__raw_add(other)

    def __radd__(self, other):
        return self + other

    def __sub__(self, other):
        if isinstance(other, list):
            other = np.array(other)
        return self.__raw_add(other * -1.0)

    def __rsub__(self, other):
        if isinstance(other, PaillierEncryptedNumber):
            return other - self
        return (self * (-1.0)).__raw_add(other)

    def __raw_add(self, other) -> "PaillierEncryptedNumber":
        if isinstance(other, (np.ndarray, list)):
            if self.__length != len(other):
                raise ValueError(
                    "PaillierEncryptedNumber.__raw_add: array(list) size"
                    " mismatch with PaillierEncryptedNumber")
            other = self.public_key.encrypt(other, apply_obfuscator=False)
        elif np.isscalar(other) and isinstance(other, (int, float)):
            other = self.public_key.encrypt(other, apply_obfuscator=False)
        elif isinstance(other, PaillierEncryptedNumber):
            if self.public_key != other.public_key:
                raise ValueError(
                    "PaillierEncryptedNumber.__raw_add: PublicKey mismatch")
            if self.__length != len(other) and len(other) > 1:
                raise ValueError(
                    "PaillierEncryptedNumber.__raw_add: CipherText size"
                    " mismatch with PaillierEncryptedNumber")

        ctx = self._ctx()
        b = self.__length
        x_dev = self.__ct.device_array()
        y_dev = other.ciphertext().device_array()
        ex = self.__expos
        ey = other._expos_np()

        if len(other) == 1 and b > 1:
            # broadcast: tile the single y column across the batch
            y_dev = ctx.gather_batch(y_dev, np.zeros(b, dtype=np.int32))
            ey = np.broadcast_to(ey, (b,))

        target = np.maximum(ex, ey)
        x_dev = self._scale_by_pow2(x_dev, target - ex)
        y_dev = self._scale_by_pow2(y_dev, target - ey)

        res = ctx.add_ct(x_dev, y_dev)
        ct = ipclCipherText(self.public_key.pubkey, _dev=res, _length=b)
        return PaillierEncryptedNumber(self.public_key, ct, target, b)

    # -- multiplication / division -------------------------------------------

    def __rmul__(self, other):
        return self * other

    def __truediv__(self, other):
        if isinstance(other, list):
            other = np.array(other)
        return self * (1.0 / other)

    def __mul__(self, other) -> "PaillierEncryptedNumber":
        b = self.__length
        if np.isscalar(other):
            encode = FixedPointNumber.encode(other, self.public_key.n,
                                             self.public_key.max_int)
            pt, pt_expo = encode.encoding, encode.exponent
            if not 0 <= pt < self.public_key.n:
                raise ValueError(
                    f"PaillierEncryptedNumber.__mul__: Scalar out of"
                    f"bounds: {pt}")
            pts = np.full(b, 0, dtype=object)
            pts[:] = pt
            pt_expos = np.full(b, pt_expo, dtype=np.int64)
        else:
            if len(other) != self.__length:
                raise ValueError(
                    "PaillierEncryptedNumber.__mul__: Multiply size mismatch")
            encs, pt_expos = encode_vector(other, self.public_key.n,
                                           self.public_key.max_int)
            for pt in encs:
                if not 0 <= pt < self.public_key.n:
                    raise ValueError(f"Scalar out of bounds: {pt}")
            pts = np.empty(b, dtype=object)
            pts[:] = encs

        n = self.public_key.n
        cond = n - self.public_key.max_int
        flags = np.array([pt >= cond for pt in pts], dtype=bool)
        # negative-plaintext rewrite: exponentiate by the SMALL value
        # n - pt and invert the result (keeps the modexp short).
        exps = [int(n - pt) if f else int(pt)
                for pt, f in zip(pts, flags)]

        ctx = self._ctx()
        dev = ctx.mul_pt(self.__ct.device_array(), exps)
        if flags.any():
            dev = self._invert_columns(dev, flags, b)
        res_expo = self.__expos + pt_expos
        ct = ipclCipherText(self.public_key.pubkey, _dev=dev, _length=b)
        return PaillierEncryptedNumber(self.public_key, ct, res_expo, b)

    # -- reductions -----------------------------------------------------------

    def sum(self) -> "PaillierEncryptedNumber":
        ctx = self._ctx()
        max_expo = int(self.__expos.max())
        dev = self._scale_by_pow2(self.__ct.device_array(),
                                  max_expo - self.__expos)
        red = ctx.tree_reduce(dev, self.__length)
        ct = ipclCipherText(self.public_key.pubkey, _dev=red, _length=1)
        return PaillierEncryptedNumber(self.public_key, ct,
                                       exponents=[max_expo], length=1)

    def mean(self) -> "PaillierEncryptedNumber":
        return self.sum() / len(self)

    def dot(self, other) -> "PaillierEncryptedNumber":
        if len(other) != len(self):
            raise ValueError(
                "PaillierEncryptedNumber.dot: input size mismatch with"
                " ciphertext")
        return (self * other).sum()

    # -- matmul ---------------------------------------------------------------

    def _matmul_impl(self, other: np.ndarray, m: int, n: int, k: int,
                     rhs: bool = False) -> "PaillierEncryptedNumber":
        """Batched matrix multiply against a plaintext matrix.

        Index maps reproduce the reference generator exactly
        (__matmul_idx_pt, ipcl_python.py:777-808) but as numpy arrays
        driving batched device gathers + modexps + segmented
        tree-reduces.  The (m*n*k)-wide column layout is processed in
        chunks of whole output groups so the device working set stays
        under config.matmul_chunk_columns ciphertext columns (~1 KB each
        at 2048-bit) instead of materializing all m*n*k at once."""
        from .utils import config as _config

        ctx = self._ctx()
        G = m * k
        nn = self.public_key.n
        dev_self = self.__ct.device_array()

        # Encode the DISTINCT plaintext values once (n*k or m*n of them,
        # vs m*n*k encode calls on the expanded layout).
        flat_pt = other.reshape(-1) if other.ndim == 2 else other
        encs, pt_expos = encode_vector(flat_pt, nn,
                                       self.public_key.max_int)
        for pt in encs:
            if not 0 <= pt < nn:
                raise ValueError(f"Scalar out of bounds: {pt}")
        cond = nn - self.public_key.max_int
        flags_flat = np.array([pt >= cond for pt in encs], dtype=bool)
        exps_flat = np.empty(len(encs), dtype=object)
        exps_flat[:] = [int(nn - pt) if f else int(pt)
                        for pt, f in zip(encs, flags_flat)]

        # One reduction group (n columns) is the indivisible unit: when a
        # single group exceeds matmul_chunk_columns the bound is exceeded
        # by that one group's width (documented in utils/config.py) — the
        # chunking never splits a group across segment_tree_reduce calls.
        g_per = max(1, _config.get_config().matmul_chunk_columns // n)
        red_parts, tg_parts = [], []
        for g0 in range(0, G, g_per):
            g1 = min(G, g0 + g_per)
            gc = g1 - g0
            i = np.arange(g0 * n, g1 * n)
            if rhs:
                idx_self = i % n * k + i // n % k
                ox, oy = i // (n * k), i % n
                pidx = ox * n + oy if other.ndim == 2 else oy
            else:
                idx_self = i // (n * k) * n + i % n
                ox, oy = i % n, i // n % k
                pidx = ox * k + oy if other.ndim == 2 else ox

            ct_g = ctx.gather_batch(dev_self, idx_self)
            temp = ctx.mul_pt(ct_g, list(exps_flat[pidx]))
            flags = flags_flat[pidx]
            if flags.any():
                temp = self._invert_columns(temp, flags, len(i))
            temp_expo = self.__expos[idx_self] + pt_expos[pidx]

            # align each group of n to its max exponent, then reduce
            tg = temp_expo.reshape(gc, n).max(axis=1)
            diffs = (tg[:, None] - temp_expo.reshape(gc, n)).reshape(-1)
            temp = self._scale_by_pow2(temp, diffs)
            red_parts.append(ctx.segment_tree_reduce(temp, gc, n)[:, :gc])
            tg_parts.append(tg)

        if len(red_parts) == 1:
            red = red_parts[0]
        else:
            red = jnp.concatenate(red_parts, axis=1)
        pad = paillier.pad_batch(G)
        if red.shape[1] < pad:
            red = jnp.concatenate(
                [red, jnp.broadcast_to(ctx.ctx.one,
                                       (ctx.L, pad - red.shape[1]))], axis=1)
        tg = np.concatenate(tg_parts)

        ct = ipclCipherText(self.public_key.pubkey, _dev=red, _length=G)
        return PaillierEncryptedNumber(self.public_key, ct, tg, G)

    def __matmul__(self, other) -> "PaillierEncryptedNumber":
        if len(self) % len(other) != 0:
            raise ValueError(
                "PaillierEncryptedNumber.__matmul__: "
                "matrix multiply size mismatch")
        other = np.array(other)
        if other.ndim not in (1, 2):
            raise NotImplementedError(
                f"PaillierEncryptedNumber.__matmul__: input ndim {other.ndim}"
                f"not supported")
        n = other.shape[0]
        k = other.shape[1] if other.ndim == 2 else 1
        m = len(self) // n
        return self._matmul_impl(other, m, n, k)

    def __rmatmul__(self, other) -> "PaillierEncryptedNumber":
        other = np.array(other)
        if other.ndim not in (1, 2):
            raise NotImplementedError(
                f"PaillierEncryptedNumber.__rmatmul__: input ndim "
                f"{other.ndim} not supported")
        m = other.shape[0] if other.ndim == 2 else 1
        n = other.shape[1] if other.ndim == 2 else other.shape[0]
        if len(self) % n != 0:
            raise ValueError(
                "PaillierEncryptedNumber.__rmatmul__: matrix multiply"
                "size mismatch")
        k = len(self) // n
        return self._matmul_impl(other, m, n, k, rhs=True)

    def __imatmul__(self, other) -> "PaillierEncryptedNumber":
        return self @ other
