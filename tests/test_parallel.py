"""Sharding/distribution tests on the 8-device CPU mesh (SURVEY.md §2.4).

Covers: batch-sharded elementwise HE ops (SPMD, no communication),
encrypted all-reduce over mesh collectives, multi-party federated
aggregation, and the driver dry-run entry.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pailliercryptolib_python_tpu.models import paillier as sch
from pailliercryptolib_python_tpu.ops import montgomery as mg
from pailliercryptolib_python_tpu.parallel import mesh as pmesh
from pailliercryptolib_python_tpu.parallel.collective import (
    sharded_he_sum, federated_aggregate)
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints

rng = np.random.default_rng(3)


@pytest.fixture(scope="module")
def setup():
    kd = fixed_key_ints(256, enable_DJN=True)
    pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                            kd["randbits"])
    priv = sch.PrivateContext(pub, kd["p"], kd["q"])
    mesh = pmesh.make_mesh(2, 4)
    return kd, pub, priv, mesh


def test_mesh_shape(setup):
    _, _, _, mesh = setup
    assert dict(mesh.shape) == {"batch_outer": 2, "batch_inner": 4}


def test_sharded_elementwise_add(setup):
    kd, pub, priv, mesh = setup
    B = 64
    xs = [int(v) for v in rng.integers(0, 1000, size=B)]
    ys = [int(v) for v in rng.integers(0, 1000, size=B)]
    ct_x = pmesh.shard_batch(pub.encrypt(xs), mesh)
    ct_y = pmesh.shard_batch(pub.encrypt(ys), mesh)
    out = pub.add_ct(ct_x, ct_y)
    assert priv.decrypt_to_ints(out, B) == [
        (x + y) % kd["n"] for x, y in zip(xs, ys)]


def test_sharded_he_sum(setup):
    kd, pub, priv, mesh = setup
    B = 64
    xs = [int(v) for v in rng.integers(0, 10**6, size=B)]
    ct = pmesh.shard_batch(pub.encrypt(xs), mesh)
    total = sharded_he_sum(ct, pub.ctx, mesh)
    got = priv.decrypt_to_ints(jnp.asarray(total), 1)[0]
    assert got == sum(xs) % kd["n"]


def test_federated_aggregate(setup):
    kd, pub, priv, mesh = setup
    B = 64
    parties = [[int(v) for v in rng.integers(0, 1000, size=B)]
               for _ in range(3)]
    cts = [pmesh.shard_batch(pub.encrypt(p), mesh) for p in parties]
    agg = federated_aggregate(cts, pub.ctx, mesh)
    got = priv.decrypt_to_ints(agg, B)
    assert got == [sum(col) % kd["n"] for col in zip(*parties)]


def test_dryrun_multichip_entry():
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(8)


def test_entry_compiles_on_cpu():
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from __graft_entry__ import entry
    fn, args = entry()
    out = jax.jit(fn).lower(*args).compile()
    assert out is not None


def test_sharded_elementwise_constrains_output(setup):
    kd, pub, priv, mesh = setup
    from pailliercryptolib_python_tpu.parallel.collective import (
        sharded_elementwise)
    from pailliercryptolib_python_tpu.parallel.mesh import batch_sharding
    B = 64
    xs = [int(v) for v in rng.integers(0, 1000, size=B)]
    ys = [int(v) for v in rng.integers(0, 1000, size=B)]
    ct_x = pub.encrypt(xs)            # NOT pre-sharded
    ct_y = pub.encrypt(ys)
    add = sharded_elementwise(
        lambda a, b: mg.mont_mul(a, b, pub.ctx), mesh)
    out = add(ct_x, ct_y)
    # the wrapper must leave the result batch-sharded across the mesh
    assert out.sharding == batch_sharding(mesh)
    assert priv.decrypt_to_ints(out, B) == [
        (x + y) % kd["n"] for x, y in zip(xs, ys)]


def test_federated_aggregate_places_unsharded_inputs(setup):
    kd, pub, priv, mesh = setup
    B = 64
    parties = [[int(v) for v in rng.integers(0, 1000, size=B)]
               for _ in range(2)]
    cts = [pub.encrypt(p) for p in parties]   # single-device arrays
    agg = federated_aggregate(cts, pub.ctx, mesh)
    got = priv.decrypt_to_ints(agg, B)
    assert got == [sum(col) % kd["n"] for col in zip(*parties)]


def test_distributed_single_process_noop(monkeypatch):
    from pailliercryptolib_python_tpu.parallel import distributed as dist
    monkeypatch.delenv("PAILLIER_COORDINATOR", raising=False)
    assert dist.launch_info_from_env() is None
    assert dist.initialize() is False       # single process: no-op
    pid, count = dist.process_info()
    assert (pid, count) == (0, 1)


def test_distributed_env_contract(monkeypatch):
    from pailliercryptolib_python_tpu.parallel import distributed as dist
    monkeypatch.setenv("PAILLIER_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("PAILLIER_NUM_PROCESSES", "4")
    monkeypatch.setenv("PAILLIER_PROCESS_ID", "2")
    info = dist.launch_info_from_env()
    assert info == {"coordinator_address": "10.0.0.1:8476",
                    "num_processes": 4, "process_id": 2}
    monkeypatch.setenv("PAILLIER_NUM_PROCESSES", "1")
    assert dist.launch_info_from_env() is None


def test_elementwise_spmd_adds_no_collectives(setup):
    """Compiled-HLO audit: the sharded elementwise aggregate contains no
    collective ops, and the encrypted all-reduce contains exactly the
    expected all-gathers — evidence the batch axis truly partitions."""
    kd, pub, priv, mesh = setup
    from pailliercryptolib_python_tpu.parallel.mesh import batch_sharding
    B = 64
    sh = batch_sharding(mesh)
    ct = pmesh.shard_batch(pub.encrypt(
        [int(v) for v in rng.integers(0, 1000, size=B)]), mesh)

    elem = jax.jit(lambda a, b: mg.mont_mul(a, b, pub.ctx),
                   in_shardings=(sh, sh), out_shardings=sh)
    txt = elem.lower(ct, ct).compile().as_text()
    for coll in ("all-gather", "all-reduce", "collective-permute",
                 "all-to-all"):
        assert coll not in txt, f"unexpected {coll} in elementwise SPMD"

    red = jax.jit(lambda a: sharded_he_sum(a, pub.ctx, mesh))
    rtxt = red.lower(ct).compile().as_text()
    assert "all-gather" in rtxt, "he_sum should gather per-device partials"


def test_sharded_decrypt_no_batch_collectives(setup):
    """CRT decrypt of a batch-sharded ciphertext runs SPMD: the compiled
    program contains NO batch-axis collective (all-gather / all-to-all /
    collective-permute / all-reduce), and the sharded result matches the
    single-device decrypt (the expensive half of the op suite partitions
    along B like everything else)."""
    from pailliercryptolib_python_tpu.parallel import sharded_ops as so

    kd, pub, priv, mesh = setup
    B = 64
    vals = [int(v) for v in rng.integers(0, 2**62, size=B)]
    ct = pmesh.shard_batch(pub.encrypt(vals), mesh)

    txt = so.lower_sharded_decrypt(priv, ct, mesh)
    for coll in ("all-gather", "all-reduce", "collective-permute",
                 "all-to-all"):
        assert coll not in txt, f"unexpected {coll} in sharded decrypt"

    out = so.sharded_decrypt(priv, ct, mesh)
    assert out.sharding == pmesh.batch_sharding(mesh)
    from pailliercryptolib_python_tpu.ops.limb import limbs_to_ints
    got = limbs_to_ints(np.asarray(out))[:B]
    assert got == vals, "sharded decrypt != plaintext oracle"


def test_sharded_mul_pt_no_batch_collectives(setup):
    """ct*pt on batch-sharded ciphertexts + sharded per-element exponent
    digits: no batch-axis collective; matches the host-path mul_pt."""
    from pailliercryptolib_python_tpu.parallel import sharded_ops as so

    kd, pub, priv, mesh = setup
    B = 64
    vals = [int(v) for v in rng.integers(0, 1000, size=B)]
    exps = [int(v) for v in rng.integers(1, 2**31, size=B)]
    ct = pmesh.shard_batch(pub.encrypt(vals, apply_obfuscator=False),
                           mesh)

    out = so.sharded_mul_pt(pub, ct, exps, mesh)
    fn = next(f for k, f in so._MUL_CACHE.items()
              if k[0] == mesh and k[2] == id(pub))
    plan = pub._rns_mul_plan()
    w = sch.window_for(pub.bits) if plan else 4
    digs = mg.exponent_digits(exps, -(-pub.bits // w), w)
    txt = fn.lower(ct, jnp.asarray(digs.astype("uint32"))) \
            .compile().as_text()
    for coll in ("all-gather", "all-reduce", "collective-permute",
                 "all-to-all"):
        assert coll not in txt, f"unexpected {coll} in sharded mul_pt"

    assert out.sharding == pmesh.batch_sharding(mesh)
    got = priv.decrypt_to_ints(jnp.asarray(np.asarray(out)), B)
    want = [(v * e) % kd["n"] for v, e in zip(vals, exps)]
    assert got == want, "sharded mul_pt != plaintext oracle"
