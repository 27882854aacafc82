"""Worker process for the 2-process jax.distributed integration test.

Launched by tests/test_distributed_2proc.py with the PAILLIER_* env
contract (parallel/distributed.py).  Each process owns ONE CPU device
(the outer mesh axis is the process axis); the workload is the sharded HE sum —
a genuine cross-process collective over the batch axis.

Prints "RESULT <int>" (the decrypted HE total) on process 0.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np
    import jax

    # CPU cross-process collectives need an explicit transport: without
    # gloo each process gets a LOCAL cpu client and process_count() stays
    # 1.  Env vars are too late when a sitecustomize imported jax before
    # this script ran, so set the config knobs directly (pre-backend-init).
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.config.update("jax_platforms", "cpu")

    from pailliercryptolib_python_tpu.parallel import distributed
    from pailliercryptolib_python_tpu.parallel.mesh import (
        make_mesh, batch_sharding, replicated)
    from pailliercryptolib_python_tpu.parallel.collective import (
        sharded_he_sum)
    from pailliercryptolib_python_tpu.models import paillier as sch
    from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints
    from pailliercryptolib_python_tpu.ops.limb import limbs_to_ints

    assert distributed.initialize(), "multi-host runtime expected"
    pid, nproc = distributed.process_info()
    assert nproc == 2, nproc

    # 256-bit: the fixed (deterministic) key — BOTH processes must derive
    # identical key material (fixed_key_ints generates fresh random keys
    # for other sizes, which would desynchronize the cluster)
    kd = fixed_key_ints(256, enable_DJN=True)
    pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                            kd["randbits"])
    priv = sch.PrivateContext(pub, kd["p"], kd["q"])

    # Each process encrypts ITS OWN shard of the global batch (the
    # federated parties); deterministic plaintexts so the oracle is known.
    B_loc = 64
    base = pid * B_loc
    vals = [base + i + 1 for i in range(B_loc)]
    ct_loc = np.asarray(pub.encrypt(vals, apply_obfuscator=True))

    mesh = make_mesh(n_hosts=nproc, chips_per_host=1)
    sh = batch_sharding(mesh)
    ct = jax.make_array_from_process_local_data(sh, ct_loc)

    rep = replicated(mesh)
    ctx = jax.tree_util.tree_map(
        lambda a: jax.make_array_from_process_local_data(rep, np.asarray(a))
        if a is not None else None, pub.ctx)

    total = sharded_he_sum(ct, ctx, mesh)           # replicated (L, 1)
    total_np = np.asarray(total)

    got = limbs_to_ints(total_np)[0]
    # decrypt on process 0 and verify against the plaintext oracle
    if pid == 0:
        expect = sum(range(1, 2 * B_loc + 1)) % kd["n"]
        import jax.numpy as jnp
        dec = priv.decrypt_to_ints(
            jnp.asarray(total_np, dtype=jnp.uint32), 1)[0]
        assert dec == expect, (dec, expect)
        print(f"RESULT {dec}", flush=True)
    distributed.shutdown()


if __name__ == "__main__":
    main()
