"""SPMD drivers for the expensive half of the HE op suite.

The elementwise ops (add_ct, encrypt_raw, obfuscate) partition along the
ciphertext batch axis for free (collective.sharded_elementwise).  CRT
decrypt and ct*pt exponentiation are ALSO elementwise over the batch —
every column's modexp chain is independent, keys are replicated — but
their host drivers (PrivateContext.decrypt_device, PublicContext.mul_pt)
bucket widths and stitch multi-stage jitted programs, which XLA's
auto-sharding is free to serialize through a gather.  These wrappers
make the partitioning structural instead: shard_map runs the full chain
per device shard, so the compiled program provably contains no
batch-axis collective (asserted by tests/test_parallel.py's HLO audit).

The reference runs decrypt as a single-host CPU loop inside
ipcl::PrivateKey::decrypt — it has no multi-device story at all
(SURVEY.md §2.4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import montgomery as mg
from .mesh import OUTER_AXIS, INNER_AXIS

_SPEC_CT = P(None, (OUTER_AXIS, INNER_AXIS))

_DEC_CACHE: dict = {}
_MUL_CACHE: dict = {}


def sharded_decrypt(priv, ct: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Batch-sharded CRT decrypt: (L_n2, B) Montgomery ciphertexts with B
    sharded over the mesh -> (Ln, B) canonical plaintext limbs, still
    batch-sharded.  Each device runs all three CRT stages (reduce, the
    two half-width modexps, recombine) on its local shard; the per-shard
    2B-wide fused layout is LOCAL (the p|q concat happens inside the
    shard), so no cross-device traffic exists anywhere in the chain.

    B must divide the mesh size evenly (shard_batch's contract)."""
    from ..models.paillier import _crt_stage_exp, _crt_stage_recombine

    B = ct.shape[1]
    assert B % mesh.size == 0, "sharded_decrypt: B must divide mesh size"
    Bloc = B // mesh.size
    key = (mesh, ct.shape, id(priv))
    fn = _DEC_CACHE.get(key)
    if fn is None:
        sq_ctx = priv._sq_ctx(Bloc)

        def local(ct_blk):
            base_m = priv._stage_reduce(ct_blk)
            if priv.use_rns:
                u_p, u_q = priv._rns_exp_halves(base_m)
                u = jnp.concatenate([u_p, u_q], axis=1)
            else:
                u = _crt_stage_exp(base_m, sq_ctx, priv.exp_digits_pq,
                                   priv.n_win_dec)
            return _crt_stage_recombine(
                u, priv._p_ctx, priv._q_ctx, priv.pinv_R, priv.qinv_R,
                priv.hpR, priv.hqR, priv.p_limbs, priv.q_limbs,
                priv.pinvqR, priv.Lh, priv.Lq, priv.pub.Ln)

        fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(_SPEC_CT,),
                                   out_specs=_SPEC_CT, check_vma=False))
        _DEC_CACHE[key] = fn
    return fn(ct)


def sharded_mul_pt(pub, ct: jnp.ndarray, exponents: list,
                   mesh: Mesh) -> jnp.ndarray:
    """Batch-sharded HE ct*pt: ct^e per column with both the ciphertexts
    and the per-element exponent digits sharded along B.  The modexp
    chain (RNS per-element kernel when planned, else the positional-limb
    windowed chain) runs entirely within each shard."""
    from ..ops import rns as _rns
    from ..models.paillier import WINDOW, window_for

    B = ct.shape[1]
    assert B % mesh.size == 0, "sharded_mul_pt: B must divide mesh size"
    exps = list(exponents) + [0] * (B - len(exponents))
    rplan = pub._rns_mul_plan()
    if rplan is not None:
        base, rkey = rplan
        w = window_for(pub.bits)
        n_win = -(-pub.bits // w)
        digits = mg.exponent_digits(exps, n_win, w)
    else:
        n_win, w = pub.n_win_ct, WINDOW
        digits = mg.exponent_digits(exps, n_win, WINDOW)

    key = (mesh, ct.shape, id(pub), w, n_win, rplan is None)
    fn = _MUL_CACHE.get(key)
    if fn is None:
        if rplan is not None:
            def local(ct_blk, dig_blk):
                return _rns.rns_pow_elem(ct_blk, dig_blk, base, rkey,
                                         pub.ctx, w, pub.L)
        else:
            def local(ct_blk, dig_blk):
                return mg.mont_exp(ct_blk, dig_blk, pub.ctx, window=WINDOW)

        fn = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=(_SPEC_CT, _SPEC_CT),
            out_specs=_SPEC_CT, check_vma=False))
        _MUL_CACHE[key] = fn
    return fn(ct, jnp.asarray(digits.astype("uint32")))


def lower_sharded_decrypt(priv, ct: jnp.ndarray, mesh: Mesh) -> str:
    """Compiled-HLO text of the sharded decrypt program (for audits)."""
    sharded_decrypt(priv, ct, mesh)      # populate cache
    fn = _DEC_CACHE[(mesh, ct.shape, id(priv))]
    return fn.lower(ct).compile().as_text()
