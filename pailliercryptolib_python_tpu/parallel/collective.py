"""Sharded HE collectives: the encrypted analog of psum/all-reduce.

Ciphertext-space addition is modular multiplication mod n^2, so an
encrypted all-reduce is a modmul tree over the sharded batch axis:
each device reduces its local shard with the log2 rotate-modmul tree,
then the (tiny) per-device partials are all-gathered and folded
locally.  This is the HE analog of gradient all-reduce in federated
learning (SURVEY.md §2.4) — the reference can only do this by pickling
ciphertexts between processes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import montgomery as mg
from ..ops.limb import LIMB_DTYPE
from .mesh import OUTER_AXIS, INNER_AXIS


def _local_tree_reduce(x: jnp.ndarray, one: jnp.ndarray,
                       ctx: mg.MontCtx) -> jnp.ndarray:
    """Reduce a (L, Bloc) block to its HE sum: log2 FOLDING rounds (each
    round modmuls the upper half into the lower half, halving the width
    — same scheme as models.paillier._segment_tree_reduce)."""
    L, Bloc = x.shape
    P2 = 1 << max(0, (Bloc - 1).bit_length())
    if P2 != Bloc:
        pad = jnp.broadcast_to(one, (L, P2 - Bloc))
        x = jnp.concatenate([x, pad], axis=1)
    width = P2
    while width > 1:
        half = width // 2
        x = mg.mont_mul(x[:, :half], x[:, half:], ctx)
        width = half
    return x


def _rep_specs(ctx):
    """Replicated PartitionSpecs matching the MontCtx pytree."""
    return jax.tree_util.tree_map(
        lambda a: P(*([None] * jnp.ndim(a))), ctx)


def sharded_he_sum(ct: jnp.ndarray, ctx: mg.MontCtx, mesh: Mesh,
                   b: int | None = None) -> jnp.ndarray:
    """HE sum of a batch-sharded ciphertext array -> replicated (L, 1).

    Strategy: shard_map over the mesh; each device tree-reduces its local
    shard (zero communication), then partials are all-gathered over both
    mesh axes and folded with log2 modmuls — ~log2(B) local modmuls plus
    one small collective, instead of gathering B ciphertexts.

    Padding columns must hold the Montgomery one (HE zero); callers that
    sliced real data in keep b == B.

    The shard_map program is cached per (mesh, shapes): rebuilding the
    closure every call would defeat jax's jit cache and recompile the
    collective on every invocation (measured: ~27 s/call at 2048-bit).
    """
    key = (mesh, ct.shape, ct.dtype,
           tuple((a.shape, a.dtype) for a in jax.tree_util.tree_leaves(ctx)))
    fn = _HE_SUM_CACHE.get(key)
    if fn is None:
        def local(ct_blk, lctx):
            partial_ = _local_tree_reduce(ct_blk, lctx.one, lctx)  # (L, 1)
            # gather every device's partial over both mesh axes
            allp = jax.lax.all_gather(partial_, INNER_AXIS, axis=1,
                                      tiled=True)
            allp = jax.lax.all_gather(allp, OUTER_AXIS, axis=1, tiled=True)
            return _local_tree_reduce(allp, lctx.one, lctx)        # (L, 1)

        spec_ct = _SPEC_CT
        spec_rep = P(None, None)
        fn = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(spec_ct, _rep_specs(ctx)),
            out_specs=spec_rep, check_vma=False))
        _HE_SUM_CACHE[key] = fn
    return fn(ct, ctx)


_HE_SUM_CACHE: dict = {}


def _batch_specs(tree, mesh: Mesh):
    """Batch-sharded spec for (L, B) arrays whose B divides the mesh,
    replicated for everything else (keys, contexts, scalars)."""
    def spec(a):
        if jnp.ndim(a) == 2 and a.shape[1] % mesh.size == 0 \
                and a.shape[1] > 1:
            return _SPEC_CT
        return P(*([None] * jnp.ndim(a)))
    return jax.tree_util.tree_map(spec, tree)


_SPEC_CT = P(None, (OUTER_AXIS, INNER_AXIS))


def sharded_elementwise(fn, mesh: Mesh):
    """Run an elementwise HE op SPMD over the mesh.

    Elementwise ciphertext ops (add_ct = modmul, obfuscate, encrypt_raw)
    need no communication at all; this wrapper makes that sharding real:
    fn runs under shard_map on each device's batch shard — every (L, B)
    array argument whose batch axis divides the mesh is split along B,
    the rest (key material) is replicated — and the result stays
    batch-sharded.  A custom-call product (the GPU kernel) then runs on
    local shards; XLA never gathers the batch."""
    cache = {}

    def wrapper(*args):
        key = jax.tree_util.tree_structure(args), tuple(
            (jnp.shape(a), jnp.result_type(a))
            for a in jax.tree_util.tree_leaves(args))
        jfn = cache.get(key)
        if jfn is None:
            jfn = jax.jit(jax.shard_map(
                fn, mesh=mesh, in_specs=_batch_specs(args, mesh),
                out_specs=_SPEC_CT, check_vma=False))
            cache[key] = jfn
        return jfn(*args)

    return wrapper


def federated_aggregate(cts: list, ctx: mg.MontCtx,
                        mesh: Mesh | None = None) -> jnp.ndarray:
    """Aggregate K parties' encrypted update vectors (the federated-
    learning headline workload): elementwise HE sum across parties of
    (L, B) ciphertext arrays.  Pure elementwise modmuls — no cross-device
    traffic.

    With a mesh the product chain runs under shard_map on each device's
    batch shard (inputs are resharded to the batch sharding as needed,
    also under an outer jit trace) and the result is batch-sharded."""
    def chain(cts_, ctx_):
        acc = cts_[0]
        for other in cts_[1:]:
            acc = mg.mont_mul(acc, other, ctx_)
        return acc

    if mesh is None:
        return chain(cts, ctx)
    key = (mesh, len(cts))
    fn = _AGG_CACHE.get(key)
    if fn is None:
        fn = jax.jit(jax.shard_map(
            chain, mesh=mesh,
            in_specs=([_SPEC_CT] * len(cts), _rep_specs(ctx)),
            out_specs=_SPEC_CT, check_vma=False))
        _AGG_CACHE[key] = fn
    return fn(list(cts), ctx)


_AGG_CACHE: dict = {}
