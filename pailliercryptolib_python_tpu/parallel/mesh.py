"""Device-mesh plumbing for sharded HE workloads.

The reference has no distribution layer at all (SURVEY.md §2.4 — pickle
is its only 'communication backend').  Here the ciphertext batch axis is
a first-class sharded dimension: limb arrays are uint32[L, B] with L
(limbs) replicated and B (batch) split over both axes of a
('batch_outer', 'batch_inner') mesh — one outer row per process, the
process's devices along the inner axis — so every elementwise HE kernel
runs SPMD with zero communication and reductions are one small
all-gather of per-device partials.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

OUTER_AXIS = "batch_outer"
INNER_AXIS = "batch_inner"


def make_mesh(n_hosts: int | None = None, chips_per_host: int | None = None,
              devices=None) -> Mesh:
    """Build a ('batch_outer', 'batch_inner') mesh over available devices.

    With a single process all devices land on one outer row; multi-host
    launches (jax.distributed.initialize) get one row per host.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_hosts is None:
        n_hosts = max(1, jax.process_count())
    if chips_per_host is None:
        chips_per_host = len(devices) // n_hosts
    dev_arr = np.asarray(devices).reshape(n_hosts, chips_per_host)
    return Mesh(dev_arr, (OUTER_AXIS, INNER_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (L, B) limb arrays: limbs replicated, batch sharded
    across every mesh axis."""
    return NamedSharding(mesh, P(None, (OUTER_AXIS, INNER_AXIS)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(arr: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Place a (L, B) limb array with the batch axis sharded.

    B must be divisible by the mesh size; pad_batch() already rounds
    batches of 128 or more to a multiple of 128."""
    return jax.device_put(arr, batch_sharding(mesh))


def replicate(tree, mesh: Mesh):
    """Replicate key material (Montgomery contexts, comb tables) on all
    devices — keys are shared; only ciphertexts shard."""
    sh = replicated(mesh)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)
