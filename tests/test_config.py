"""Runtime config knobs + comb-table HBM lifecycle (utils/config.py).

Covers the SURVEY.md §5 config-row requirement and the per-key device
table budget: many keys in one process must stay under
``comb_hbm_budget_bytes`` (the reference has no analog — its per-key
state lives in external C++ and is never bounded).
"""

import numpy as np
import pytest

from pailliercryptolib_python_tpu.models import paillier as sch
from pailliercryptolib_python_tpu.utils import config as cfg
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints


@pytest.fixture()
def restore_config():
    saved = cfg.get_config().comb_hbm_budget_bytes
    yield
    cfg.set_config(comb_hbm_budget_bytes=saved)


def _mk_pub(seed: int) -> sch.PublicContext:
    kd = fixed_key_ints(256, enable_DJN=True)
    # perturb hs per "key" so tables are genuinely distinct
    hs = pow(kd["hs"], seed + 2, kd["n"] * kd["n"])
    return sch.PublicContext(kd["n"], kd["bits"], True, hs, kd["randbits"])


def test_set_config_rejects_unknown_knob():
    with pytest.raises(ValueError):
        cfg.set_config(definitely_not_a_knob=1)


def test_comb_window_shrinks_to_fit_budget(restore_config):
    kd = fixed_key_ints(256, enable_DJN=True)
    pub_full = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                                 kd["randbits"])
    # a budget small enough that the default window cannot fit
    full_bytes = cfg.comb_table_bytes(pub_full.randbits, pub_full.L,
                                      pub_full.comb_window)
    cfg.set_config(comb_hbm_budget_bytes=full_bytes)  # cap = budget//2
    pub_small = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                                  kd["randbits"])
    assert pub_small.comb_window < pub_full.comb_window
    assert cfg.comb_table_bytes(pub_small.randbits, pub_small.L,
                                pub_small.comb_window) <= full_bytes // 2
    # the shrunken window still encrypts correctly
    priv = sch.PrivateContext(pub_small, kd["p"], kd["q"])
    msgs = [int(v) for v in np.random.default_rng(0).integers(
        0, 1000, size=4)]
    ct = pub_small.encrypt(msgs, apply_obfuscator=True)
    assert priv.decrypt_to_ints(ct, 4) == msgs


def test_comb_registry_evicts_lru_under_budget(restore_config):
    probe = _mk_pub(0)
    one_table = cfg.comb_table_bytes(probe.randbits, probe.L,
                                     probe.comb_window)
    # room for ~3 tables; cap/2 still fits one full-window table
    cfg.set_config(comb_hbm_budget_bytes=3 * one_table)

    pubs = [_mk_pub(i) for i in range(6)]
    for p in pubs:
        _ = p.comb_table
        assert cfg.comb_registry.total_bytes <= 3 * one_table
    # oldest keys were evicted, newest kept
    assert pubs[0]._comb is None
    assert pubs[-1]._comb is not None

    # an evicted key transparently rebuilds and still round-trips
    kd = fixed_key_ints(256, enable_DJN=True)
    pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                            kd["randbits"])
    priv = sch.PrivateContext(pub, kd["p"], kd["q"])
    _ = pub.comb_table
    pub._drop_comb()
    msgs = [7, 11, 13, 17]
    ct = pub.encrypt(msgs, apply_obfuscator=True)
    assert priv.decrypt_to_ints(ct, 4) == msgs


def test_touch_keeps_hot_keys_resident(restore_config):
    probe = _mk_pub(0)
    one_table = cfg.comb_table_bytes(probe.randbits, probe.L,
                                     probe.comb_window)
    cfg.set_config(comb_hbm_budget_bytes=2 * one_table)
    a, b, c = _mk_pub(1), _mk_pub(2), _mk_pub(3)
    _ = a.comb_table
    _ = b.comb_table
    _ = a.comb_table      # touch a — b becomes LRU
    _ = c.comb_table      # evicts b, not a
    assert a._comb is not None
    assert b._comb is None


def test_profiling_hooks():
    from pailliercryptolib_python_tpu.utils import profiling
    import jax.numpy as jnp
    sink = []
    with profiling.timed("op", sink):
        with profiling.annotate("he-op"):
            jnp.zeros(4).block_until_ready()
    assert sink and sink[0][0] == "op" and sink[0][1] >= 0


def test_fixed_shape_covers_encrypt_h2d():
    """Under fixed_shape_ops the encrypt H2D packing is magnitude-
    independent: small payloads transfer the full Ln limbs (without the
    gate, batch max bit-length leaked through transfer size/time even in
    the hardened mode)."""
    pub = _mk_pub(0)
    small, large = 12, pub.n.bit_length() - 1
    # default mode: small payloads take the bucketed fast path
    assert pub.transfer_limbs(small) < pub.Ln
    assert pub.transfer_limbs(large) == pub.Ln
    cfg.set_config(fixed_shape_ops=True)
    try:
        assert pub.transfer_limbs(small) == pub.Ln
        assert pub.transfer_limbs(large) == pub.Ln
        arr = pub.encodings_to_device([3, 5])
        assert arr.shape[0] == pub.Ln
    finally:
        cfg.set_config(fixed_shape_ops=False)
