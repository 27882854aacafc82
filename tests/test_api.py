"""API-level tests: port of the reference suite
(/root/reference/tests/ipcl_python_test.py) plus pickle/container parity.

The reference runs every test against a fresh 2048-bit key; here the CPU
suite uses 256-bit keys for speed (the math is size-independent) and the
full 2048-bit parity run lives in test_parity_2048.py (slow-marked) and
bench.py on the real device.  Unlike the reference's matmul tests, which
call np.allclose without asserting (a known weakness, SURVEY.md §4),
these assert.
"""

import pickle
import random

import numpy as np
import pytest

from pailliercryptolib_python_tpu import (
    PaillierKeypair,
    PaillierEncryptedNumber,
    context,
    hybridControl,
    hybridMode,
)

np.random.seed(42)
random.seed(42)

KEYBITS = 256


@pytest.fixture(scope="module")
def keys():
    return PaillierKeypair.generate_keypair(KEYBITS)


def test_add(keys):
    pk, sk = keys
    x_li = np.ones(100) * np.random.randint(100)
    y_li = np.ones(100) * np.random.randint(1000)
    z_li = np.ones(100) * np.random.rand()
    t_li = list(range(100))
    en_x = pk.encrypt(x_li)
    en_y = pk.encrypt(y_li)
    en_z = pk.encrypt(z_li)
    en_t = pk.encrypt(t_li)
    en_res = en_x + en_y + en_z + en_t
    res = x_li + y_li + z_li + t_li
    de = sk.decrypt(en_res)
    for i in range(100):
        assert de[i] == pytest.approx(res[i], abs=1e-7)


def test_add_scalar_and_array(keys):
    pk, sk = keys
    x = np.arange(10).astype(float)
    en_x = pk.encrypt(x)
    de = sk.decrypt(en_x + 3.5)
    np.testing.assert_allclose(de, x + 3.5)
    de = sk.decrypt(3.5 + en_x)
    np.testing.assert_allclose(de, x + 3.5)
    de = sk.decrypt(en_x + list(range(10)))
    np.testing.assert_allclose(de, x + np.arange(10))


def test_sub(keys):
    pk, sk = keys
    x = np.arange(10).astype(float)
    y = np.random.rand(10)
    en_x = pk.encrypt(x)
    np.testing.assert_allclose(sk.decrypt(en_x - y), x - y, atol=1e-7)
    np.testing.assert_allclose(sk.decrypt(en_x - 2.5), x - 2.5, atol=1e-7)
    np.testing.assert_allclose(sk.decrypt(7.5 - en_x), 7.5 - x, atol=1e-7)
    en_y = pk.encrypt(y)
    np.testing.assert_allclose(sk.decrypt(en_x - en_y), x - y, atol=1e-7)


def test_mul(keys):
    pk, sk = keys
    x_li = np.ones(100) * np.random.randint(100)
    y_li = np.ones(100) * np.random.randint(1000) * -1
    z_li = np.ones(100) * np.random.rand()
    t_li = list(range(100))
    en_x = pk.encrypt(x_li)
    en_res = (en_x * y_li + z_li) * t_li
    de = sk.decrypt(en_res)
    res = (x_li * y_li + z_li) * t_li
    for i in range(100):
        assert de[i] == pytest.approx(res[i], rel=1e-9, abs=1e-7)


def test_mul_scalar_drift(keys):
    # accumulated encode/align error loop (reference test_mul tail, :56-66)
    pk, sk = keys
    x = 9
    en_x = pk.encrypt(x)
    for _ in range(20):
        en_x = en_x + 5000
        en_x = en_x - 0.2
        x = x + 5000 - 0.2
        de = sk.decrypt(en_x)
        assert de == pytest.approx(x, abs=1e-6)


def test_truediv(keys):
    pk, sk = keys
    x = np.arange(1, 9).astype(float)
    en_x = pk.encrypt(x)
    np.testing.assert_allclose(sk.decrypt(en_x / 4.0), x / 4.0, atol=1e-7)
    np.testing.assert_allclose(sk.decrypt(en_x / np.arange(1, 9).astype(float)),
                               x / np.arange(1, 9), atol=1e-7)


def test_sum_mean_dot(keys):
    pk, sk = keys
    x = np.random.rand(17)
    en_x = pk.encrypt(x)
    assert sk.decrypt(en_x.sum()) == pytest.approx(x.sum(), abs=1e-7)
    assert sk.decrypt(en_x.mean()) == pytest.approx(x.mean(), abs=1e-7)
    v = np.random.rand(17)
    assert sk.decrypt(en_x.dot(v)) == pytest.approx(x.dot(v), abs=1e-7)


def test_matmul(keys):
    pk, sk = keys
    for _ in range(4):
        m = np.random.randint(1, 9)
        n = np.random.randint(1, 9)
        k = np.random.randint(1, 9)
        x_li = np.random.rand(m, n)
        y_li = np.random.rand(n, k)
        res = x_li @ y_li
        en_x = pk.encrypt(x_li.flatten())
        de = np.array(sk.decrypt(en_x @ y_li)).reshape([m, k])
        np.testing.assert_allclose(de, res, atol=1e-7)


def test_matmul_1d(keys):
    pk, sk = keys
    m, n = 3, 4
    x = np.random.rand(m, n)
    v = np.random.rand(n)
    en_x = pk.encrypt(x.flatten())
    de = np.array(sk.decrypt(en_x @ v)).reshape(-1)
    np.testing.assert_allclose(de, x @ v, atol=1e-7)


def test_rmatmul(keys):
    pk, sk = keys
    for _ in range(4):
        m = np.random.randint(1, 9)
        n = np.random.randint(1, 9)
        k = np.random.randint(1, 9)
        x_li = np.random.rand(m, n).tolist()
        y_li = np.random.rand(n, k)
        res = np.array(x_li) @ y_li
        en_y = pk.encrypt(y_li.flatten())
        de = np.array(sk.decrypt(x_li @ en_y)).reshape([m, k])
        np.testing.assert_allclose(de, res, atol=1e-7)


def test_imatmul(keys):
    pk, sk = keys
    m, n, k = 4, 3, 2
    x_li = np.random.rand(m, n)
    y_li = np.random.rand(n, k)
    en_x = pk.encrypt(x_li.flatten())
    en_x @= y_li
    de = np.array(sk.decrypt(en_x)).reshape([m, k])
    np.testing.assert_allclose(de, x_li @ y_li, atol=1e-7)


def test_matmul_chunked(keys):
    """Chunked matmul (working-set bound) matches the one-shot result,
    including negative plaintexts and rmatmul orientation."""
    from pailliercryptolib_python_tpu.utils import config as _config

    pk, sk = keys
    m, n, k = 5, 4, 3
    x_li = np.random.rand(m, n)
    y_li = np.random.rand(n, k) - 0.5
    en_x = pk.encrypt(x_li.flatten())
    w_li = np.random.rand(m, n) - 0.5
    en_y = pk.encrypt(np.random.rand(n * k))
    old = _config.get_config().matmul_chunk_columns
    try:
        # force several chunks: n columns per group, 2 groups per chunk
        _config.set_config(matmul_chunk_columns=2 * n)
        de = np.array(sk.decrypt(en_x @ y_li)).reshape([m, k])
        np.testing.assert_allclose(de, x_li @ y_li, atol=1e-7)
        de2 = np.array(sk.decrypt(w_li @ en_y)).reshape([m, k])
        np.testing.assert_allclose(
            de2, w_li @ np.array(sk.decrypt(en_y)).reshape([n, k]),
            atol=1e-7)
    finally:
        _config.set_config(matmul_chunk_columns=old)


def test_broadcast_add(keys):
    pk, sk = keys
    x = np.random.rand(9)
    en_x = pk.encrypt(x)
    en_s = pk.encrypt(2.25)
    np.testing.assert_allclose(sk.decrypt(en_x + en_s), x + 2.25, atol=1e-7)
    np.testing.assert_allclose(sk.decrypt(en_s + en_x), x + 2.25, atol=1e-7)


def test_getitem_iter(keys):
    pk, sk = keys
    x = np.arange(6).astype(float)
    en_x = pk.encrypt(x)
    assert sk.decrypt(en_x[2]) == pytest.approx(2.0)
    sub = en_x[1:4]
    assert len(sub) == 3
    np.testing.assert_allclose(sk.decrypt(sub), x[1:4])
    vals = [sk.decrypt(e) for e in en_x]
    np.testing.assert_allclose(vals, x)
    with pytest.raises(IndexError):
        en_x[7]


def test_apply_obfuscator(keys):
    pk, sk = keys
    x = np.arange(5).astype(float)
    en_x = pk.raw_encrypt(x)
    before = [int(b.value()) for b in en_x.ciphertextBN()]
    en_x.apply_obfuscator()
    after = [int(b.value()) for b in en_x.ciphertextBN()]
    assert before != after
    np.testing.assert_allclose(sk.decrypt(en_x), x)


def test_pickle_roundtrip(keys):
    pk, sk = keys
    x = np.random.rand(7)
    en_x = pk.encrypt(x)

    pk2 = pickle.loads(pickle.dumps(pk))
    assert pk2 == pk
    sk2 = pickle.loads(pickle.dumps(sk))
    assert sk2 == sk
    en2 = pickle.loads(pickle.dumps(en_x))
    np.testing.assert_allclose(sk2.decrypt(en2), x, atol=1e-9)
    # keys from pickled pk still encrypt for the original sk
    en3 = pk2.encrypt(x)
    np.testing.assert_allclose(sk.decrypt(en3), x, atol=1e-9)


def test_pubkey_mismatch_raises(keys):
    pk, sk = keys
    pk2, sk2 = PaillierKeypair.generate_keypair(KEYBITS)
    x = pk.encrypt([1.0, 2.0])
    y = pk2.encrypt([1.0, 2.0])
    with pytest.raises(ValueError):
        x + y
    with pytest.raises(ValueError):
        sk2.decrypt(x)


def test_encrypt_type_validation(keys):
    pk, _ = keys
    with pytest.raises(ValueError):
        pk.encrypt(["a", "b"])


def test_scalar_decrypt_shape(keys):
    # length-1 ciphertexts decrypt to a scalar (reference :217, :245)
    pk, sk = keys
    en = pk.encrypt(3.75)
    assert isinstance(sk.decrypt(en), float)
    assert sk.decrypt(en) == pytest.approx(3.75)


def test_context_and_hybrid_shims():
    assert context.initializeContext("QAT") is True
    # CPU-only test env: accelerator not active
    assert context.isQATActive() in (True, False)
    assert context.terminateContext() is True
    assert context.isQATRunning() is False
    hybridControl.setHybridMode(hybridMode.HALF)
    assert hybridControl.getHybridMode() == hybridMode.HALF
    hybridControl.setHybridOff()
    assert hybridControl.getHybridMode() == hybridMode.IPP


def test_fixed_shape_mode_matches(keys):
    """PAILLIER_FIXED_SHAPE mode (constant-time ct*pt): identical
    results, shape-independent program (full window count + whole-batch
    inversion select)."""
    import numpy as np
    from pailliercryptolib_python_tpu.utils import config as cfg

    pk, sk = keys
    x = np.array([1.5, -2.0, 3.25, 1000.0])
    y = np.array([2.0, -7.5, 0.5, -1.0])
    ct = pk.encrypt(x)
    want = sk.decrypt(ct * y)
    cfg.set_config(fixed_shape_ops=True)
    try:
        got = sk.decrypt(ct * y)
        got_s = sk.decrypt(ct * 3.5)
    finally:
        cfg.set_config(fixed_shape_ops=False)
    assert np.allclose(got, want)
    assert np.allclose(got, x * y, atol=1e-9)
    assert np.allclose(got_s, x * 3.5, atol=1e-9)


def test_hybrid_pipelined_encrypt(keys):
    """hybridMode now maps to real host/device pipelining: chunked
    encrypt must produce ciphertexts that decrypt identically, and the
    exponent bookkeeping must survive chunk boundaries."""
    import numpy as np
    from pailliercryptolib_python_tpu.utils.context import (
        hybridControl, hybridMode)
    from pailliercryptolib_python_tpu.utils import config as cfg

    pk, sk = keys
    vals = np.random.default_rng(3).random(2100) * 100 - 50
    want = sk.decrypt(pk.encrypt(vals))
    try:
        for mode in (hybridMode.OPTIMAL, hybridMode.HALF, hybridMode.IPP,
                     hybridMode.QAT):
            hybridControl.setHybridMode(mode)
            assert cfg.get_config().encrypt_pipeline_chunks >= 1
            ct = pk.encrypt(vals)
            assert len(ct) == 2100
            got = sk.decrypt(ct)
            assert np.allclose(got, want, atol=0)
            assert np.allclose(got, vals, atol=1e-7)
            # slicing across a chunk boundary
            assert np.allclose(sk.decrypt(ct[500:600]), vals[500:600],
                               atol=1e-7)
    finally:
        cfg.set_config(encrypt_pipeline_chunks=1)
    assert hybridControl.getHybridMode() == hybridMode.QAT


def test_hybrid_host_device_split(keys):
    """With the accelerator context initialized, PREF_IPP*/HALF modes
    route a mode-proportional slice of each encrypt batch to the
    CONCURRENT host bigint path (the reference's QAT:CPU work split
    made real); results are indistinguishable
    and decrypt exactly."""
    import numpy as np
    from pailliercryptolib_python_tpu.utils.context import (
        context, hybridControl, hybridMode)
    from pailliercryptolib_python_tpu.utils import config as cfg
    from pailliercryptolib_python_tpu.models import paillier as sch

    pk, sk = keys
    pctx = pk.pubkey.context
    calls = []
    orig = sch.PublicContext.host_encrypt

    def spy(self, encodings, apply_obfuscator=True):
        calls.append(len(encodings))
        return orig(self, encodings, apply_obfuscator)

    x = np.arange(20, dtype=float) + 0.5
    sch.PublicContext.host_encrypt = spy
    try:
        # no context -> no split even with a host-leaning mode
        hybridControl.setHybridMode(hybridMode.HALF)
        assert np.allclose(sk.decrypt(pk.encrypt(x)), x)
        assert calls == []
        # context up -> HALF routes ~50% host, concurrently
        context.initializeContext("QAT")
        assert np.allclose(sk.decrypt(pk.encrypt(x)), x)
        assert calls == [10]
        # IPP: 100% host (faithful "CPU library only")
        hybridControl.setHybridMode(hybridMode.IPP)
        assert np.allclose(sk.decrypt(pk.encrypt(x)), x)
        assert calls == [10, 20]
        # obfuscation still fresh on the host leg
        cts = [pk.encrypt(x[:4]).ciphertextBN() for _ in range(2)]
        assert cts[0] != cts[1]
    finally:
        sch.PublicContext.host_encrypt = orig
        hybridControl.setHybridMode(hybridMode.UNDEFINED)
        cfg.set_config(encrypt_host_ratio=0.0,
                       encrypt_pipeline_chunks=1)
        context.terminateContext()
