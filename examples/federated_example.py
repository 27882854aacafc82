#!/usr/bin/env python3
"""Federated encrypted-aggregation example on a device mesh.

The flagship distributed workload: K parties encrypt their
local update vectors under a shared public key; the aggregator sums the
CIPHERTEXTS elementwise (HE add = modmul mod n^2) and reduces to one
encrypted total, all sharded across a ('batch_outer', 'batch_inner') mesh —
only the key holder can decrypt the result.

Run anywhere:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/federated_example.py
On several hosts, set PAILLIER_COORDINATOR / PAILLIER_NUM_PROCESSES /
PAILLIER_PROCESS_ID and the same code runs across them
(parallel/distributed.initialize is called below).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from pailliercryptolib_python_tpu.models import paillier as sch
    from pailliercryptolib_python_tpu.parallel import distributed, mesh
    from pailliercryptolib_python_tpu.parallel.collective import (
        federated_aggregate, sharded_he_sum)

    multihost = distributed.initialize()
    print(f"multi-host: {multihost}; devices: {len(jax.devices())}")

    m = mesh.make_mesh()
    print(f"mesh: {dict(m.shape)}")

    # key holder generates the shared keypair
    kd = sch.generate_key_ints(256, enable_DJN=True)
    pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                            kd["randbits"])
    priv = sch.PrivateContext(pub, kd["p"], kd["q"])

    # K parties hold local gradient-like updates
    K, B = 3, len(jax.devices()) * 32
    rng = np.random.default_rng(0)
    parties = [[int(v) for v in rng.integers(0, 10**6, size=B)]
               for _ in range(K)]

    # each party encrypts; the aggregator shards the batch over the mesh
    cts = [mesh.shard_batch(pub.encrypt(p, apply_obfuscator=True), m)
           for p in parties]

    # elementwise encrypted aggregation (pure SPMD, no communication)
    agg = federated_aggregate(cts, pub.ctx, m)

    # encrypted all-reduce to one total (one small all-gather)
    total_ct = sharded_he_sum(agg, pub.ctx, m)

    # only the key holder can open the results
    elem = priv.decrypt_to_ints(agg, B)
    total = priv.decrypt_to_ints(np.asarray(total_ct), 1)[0]

    expect_elem = [sum(col) % kd["n"] for col in zip(*parties)]
    expect_total = sum(expect_elem) % kd["n"]
    assert elem == expect_elem, "elementwise aggregation mismatch"
    assert total == expect_total, "encrypted all-reduce mismatch"
    print(f"aggregated {B} values from {K} parties across "
          f"{len(jax.devices())} devices; totals verified")


if __name__ == "__main__":
    main()
