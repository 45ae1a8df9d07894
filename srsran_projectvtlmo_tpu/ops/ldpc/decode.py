"""Layered scaled min-sum LDPC decoder, int8-exact, batched over codeblocks.

Reproduces the reference arithmetic bit-for-bit
(reference: lib/phy/upper/channel_coding/ldpc/ldpc_decoder_generic.cpp:30-125 and
ldpc_decoder_impl.cpp:116-135):

  per iteration, per layer (= lifted check row):
    v2c   = soft - c2v            (LLR saturated difference: clip +/-120,
                                   infinities +/-127 dominate, a - a = 0)
    min1/min2/argmin of |v2c| and sign product over the row's edges
    c2v'  = copysign(round(min * 0.75|0.8...), sign_prod ^ sign(v2c))
            (no scaling when the magnitude is infinite)
    soft  = promotion_sum(c2v', v2c)  (overflow promotes to +/-127 = fixed bit)

The codeblock batch is the leading array axis; layers run as a lax.scan over
a stacked edge table so one program serves every layer.  `ldpc_decode` runs a
fixed iteration count; `ldpc_decode_es` adds the reference's per-CB CRC early
stop as a per-iteration convergence mask with a batch-wide loop exit.  The
CUDA kernel `decode_cuda.ldpc_decode_es_cuda` is its bit-exact twin.

Layout: soft bits (B, NV+1, Z) int8 (last node is a scatter trash bin);
check-to-variable messages live in the *check* domain (B, M, Emax, Z) so only
soft bits are rotated per layer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ...ran.ldpc_params import BaseGraph
from ...utils.llr import LLR_MAX, LLR_INFTY
from .graphs import get_graph

#: Default scaling factor of the min-sum update (reference default 0.8).
DEFAULT_SCALING = 0.8
DEFAULT_ITERATIONS = 6


@functools.lru_cache(maxsize=None)
def _decode_tables(bg: BaseGraph, z: int):
    g = get_graph(bg, z)
    m, e_max = g.m, g.max_row_degree
    cols = g.row_cols.copy()  # (M, Emax), -1 padded
    shifts = g.row_shifts.copy()
    mask = (cols >= 0).astype(np.int8)
    cols = np.where(cols >= 0, cols, g.n_full)  # trash node index
    zz = np.arange(z, dtype=np.int32)
    # Rotation to check domain: idx_fwd[r, e, i] = (i + s) mod z.
    idx_fwd = (zz[None, None, :] + shifts[:, :, None]) % z
    # Back-rotation to variable domain: idx_bwd[r, e, j] = (j - s) mod z.
    idx_bwd = (zz[None, None, :] - shifts[:, :, None]) % z
    return g, cols.astype(np.int32), mask, idx_fwd.astype(np.int32), idx_bwd.astype(np.int32)


def _sat_sub(a32, b32):
    """LLR saturated difference on int32 carriers (result int32)."""
    plain = jnp.clip(a32 - b32, -LLR_MAX, LLR_MAX)
    nb = -b32
    out = jnp.where(jnp.abs(a32) == LLR_INFTY, a32, jnp.where(jnp.abs(b32) == LLR_INFTY, nb, plain))
    return jnp.where(a32 == b32, 0, out)


def _promotion_sum(a32, b32):
    s = a32 + b32
    plain = jnp.where(jnp.abs(s) > LLR_MAX, jnp.sign(s) * LLR_INFTY, s)
    out = jnp.where(jnp.abs(a32) == LLR_INFTY, a32, jnp.where(jnp.abs(b32) == LLR_INFTY, b32, plain))
    return jnp.where(a32 == -b32, 0, out)


def ldpc_decode(
    llrs,
    bg: BaseGraph,
    z: int,
    *,
    nof_iterations: int = DEFAULT_ITERATIONS,
    scaling_factor: float = DEFAULT_SCALING,
):
    """Decode rate-recovered LLRs.

    Args:
      llrs: (B, N) int8 with N = (n_full - 2) * z, i.e. the codeword without the
        two punctured systematic blocks.  Filler positions must be +LLR_INFTY.
      bg, z: base graph and lifting size.
      nof_iterations: fixed iteration count (reference default 6).
      scaling_factor: min-sum scaling in (0, 1).

    Returns:
      (hard_bits (B, K) uint8, soft_info (B, K) int8 final systematic LLRs).
    """
    return _decode_jit(llrs, bg, z, nof_iterations, float(scaling_factor))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _decode_jit(llrs, bg: BaseGraph, z: int, nof_iterations: int, scaling_factor: float):
    g, cols, mask, idx_fwd, idx_bwd = _decode_tables(bg, z)
    m, e_max, nv = g.m, g.max_row_degree, g.n_full
    b = llrs.shape[0]

    # Assemble soft bits over all variable nodes: 2 punctured blocks get LLR 0.
    soft = jnp.concatenate(
        [
            jnp.zeros((b, 2 * z), jnp.int8),
            llrs.astype(jnp.int8),
            jnp.zeros((b, z), jnp.int8),  # trash node
        ],
        axis=-1,
    ).reshape(b, nv + 1, z).astype(jnp.int32)

    c2v = jnp.zeros((b, m, e_max, z), jnp.int32)

    cols_t = jnp.asarray(cols)
    mask_t = jnp.asarray(mask.astype(np.int32))
    fwd_t = jnp.asarray(idx_fwd)
    bwd_t = jnp.asarray(idx_bwd)

    def layer_step(carry, r):
        soft, c2v = carry
        lcols = jax.lax.dynamic_index_in_dim(cols_t, r, 0, keepdims=False)  # (E,)
        lmask = jax.lax.dynamic_index_in_dim(mask_t, r, 0, keepdims=False)
        lfwd = jax.lax.dynamic_index_in_dim(fwd_t, r, 0, keepdims=False)  # (E, Z)
        lbwd = jax.lax.dynamic_index_in_dim(bwd_t, r, 0, keepdims=False)
        lc2v = jax.lax.dynamic_index_in_dim(c2v, r, 1, keepdims=False)  # (B, E, Z)

        soft_g = jnp.take(soft, lcols, axis=1)  # (B, E, Z) variable domain
        soft_chk = jnp.take_along_axis(soft_g, jnp.broadcast_to(lfwd[None], soft_g.shape), axis=-1)

        v2c = _sat_sub(soft_chk, lc2v)  # (B, E, Z), check domain

        absv = jnp.abs(v2c)
        big = jnp.int32(LLR_INFTY + 1)
        masked_abs = jnp.where(lmask[None, :, None] > 0, absv, big)
        # The reference initializes its running min/second-min at LLR_MAX, so
        # check-to-variable magnitudes are capped at 120 and never become the
        # reserved +/-127 "fixed bit" values (ldpc_decoder_impl.cpp:256-258).
        argmin = jnp.argmin(masked_abs, axis=1, keepdims=True)
        min1 = jnp.minimum(jnp.min(masked_abs, axis=1, keepdims=True), LLR_MAX)
        without_min = jnp.where(
            jnp.arange(e_max)[None, :, None] == argmin, big, masked_abs
        )
        min2 = jnp.minimum(jnp.min(without_min, axis=1, keepdims=True), LLR_MAX)

        sign_bits = (v2c < 0).astype(jnp.int32) * lmask[None, :, None]
        sign_prod = jnp.sum(sign_bits, axis=1, keepdims=True) % 2

        mag = jnp.where(jnp.arange(e_max)[None, :, None] == argmin, min2, min1)
        mag = jnp.floor(mag.astype(jnp.float32) * jnp.float32(scaling_factor) + 0.5).astype(jnp.int32)
        final_sign = sign_prod ^ (v2c < 0).astype(jnp.int32)
        new_c2v = jnp.where(final_sign == 1, -mag, mag) * lmask[None, :, None]

        soft_new_chk = _promotion_sum(new_c2v, v2c)
        soft_new_var = jnp.take_along_axis(
            soft_new_chk, jnp.broadcast_to(lbwd[None], soft_new_chk.shape), axis=-1
        )
        # Masked edges point at the trash node nv (their writes land there and are
        # ignored); real columns are unique within a row so .set is well defined.
        scatter_cols = jnp.where(lmask > 0, lcols, nv)
        soft = soft.at[:, scatter_cols].set(soft_new_var)
        c2v = jax.lax.dynamic_update_index_in_dim(c2v, new_c2v, r, 1)
        return (soft, c2v), None

    def iteration(carry, _):
        carry, _ = jax.lax.scan(layer_step, carry, jnp.arange(m))
        return carry, None

    (soft, c2v), _ = jax.lax.scan(iteration, (soft, c2v), None, length=nof_iterations)

    info = soft[:, : g.kb, :].reshape(b, -1)
    hard = (info <= 0).astype(jnp.uint8)
    return hard, jnp.clip(info, -LLR_INFTY, LLR_INFTY).astype(jnp.int8)


def ldpc_decode_es(
    llrs,
    bg: BaseGraph,
    z: int,
    crc_name: str,
    nof_crc_covered_bits: int,
    *,
    nof_iterations: int = DEFAULT_ITERATIONS,
    scaling_factor: float = DEFAULT_SCALING,
):
    """XLA early-stopping decoder (reference per-iteration CRC stop semantics).

    Bit-exact with the CUDA ldpc_decode_es_cuda: after each full
    layer sweep, the CB CRC is checked on the systematic hard decisions; a
    passing codeblock's output is snapshotted at that iteration (bit-exact
    with stopping it) and the loop exits when all codeblocks have converged
    (reference: lib/phy/upper/channel_coding/ldpc/ldpc_decoder_impl.cpp:116-135).

    Returns (hard (B, K) uint8, soft_info (B, K) int8, crc_ok (B,) bool,
    nof_iterations_used (B,) int32).
    """
    return _decode_es_jit(llrs, bg, z, crc_name, int(nof_crc_covered_bits),
                          nof_iterations, float(scaling_factor))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _decode_es_jit(llrs, bg: BaseGraph, z: int, crc_name: str, kp: int,
                   max_iterations: int, scaling_factor: float):
    from ..crc import POLYS, crc_zero_basis

    g, cols, mask, idx_fwd, idx_bwd = _decode_tables(bg, z)
    m, e_max, nv = g.m, g.max_row_degree, g.n_full
    b = llrs.shape[0]
    order, _ = POLYS[crc_name]
    basis = crc_zero_basis(crc_name, kp)  # (kp, order)
    packed_np = np.zeros(g.kb * z, np.int32)
    packed_np[:kp] = (basis.astype(np.int64)
                      << np.arange(order, dtype=np.int64)).sum(-1).astype(np.int32)
    packed = jnp.asarray(packed_np.reshape(1, g.kb, z))

    soft0 = jnp.concatenate(
        [jnp.zeros((b, 2 * z), jnp.int8), llrs.astype(jnp.int8),
         jnp.zeros((b, z), jnp.int8)], axis=-1,
    ).reshape(b, nv + 1, z).astype(jnp.int32)
    c2v0 = jnp.zeros((b, m, e_max, z), jnp.int32)

    cols_t = jnp.asarray(cols)
    mask_t = jnp.asarray(mask.astype(np.int32))
    fwd_t = jnp.asarray(idx_fwd)
    bwd_t = jnp.asarray(idx_bwd)

    def layer_step(carry, r):
        soft, c2v = carry
        lcols = jax.lax.dynamic_index_in_dim(cols_t, r, 0, keepdims=False)
        lmask = jax.lax.dynamic_index_in_dim(mask_t, r, 0, keepdims=False)
        lfwd = jax.lax.dynamic_index_in_dim(fwd_t, r, 0, keepdims=False)
        lbwd = jax.lax.dynamic_index_in_dim(bwd_t, r, 0, keepdims=False)
        lc2v = jax.lax.dynamic_index_in_dim(c2v, r, 1, keepdims=False)

        soft_g = jnp.take(soft, lcols, axis=1)
        soft_chk = jnp.take_along_axis(soft_g, jnp.broadcast_to(lfwd[None], soft_g.shape), axis=-1)
        v2c = _sat_sub(soft_chk, lc2v)

        absv = jnp.abs(v2c)
        big = jnp.int32(LLR_INFTY + 1)
        masked_abs = jnp.where(lmask[None, :, None] > 0, absv, big)
        argmin = jnp.argmin(masked_abs, axis=1, keepdims=True)
        min1 = jnp.minimum(jnp.min(masked_abs, axis=1, keepdims=True), LLR_MAX)
        without_min = jnp.where(jnp.arange(e_max)[None, :, None] == argmin, big, masked_abs)
        min2 = jnp.minimum(jnp.min(without_min, axis=1, keepdims=True), LLR_MAX)

        sign_bits = (v2c < 0).astype(jnp.int32) * lmask[None, :, None]
        sign_prod = jnp.sum(sign_bits, axis=1, keepdims=True) % 2
        mag = jnp.where(jnp.arange(e_max)[None, :, None] == argmin, min2, min1)
        mag = jnp.floor(mag.astype(jnp.float32) * jnp.float32(scaling_factor) + 0.5).astype(jnp.int32)
        final_sign = sign_prod ^ (v2c < 0).astype(jnp.int32)
        new_c2v = jnp.where(final_sign == 1, -mag, mag) * lmask[None, :, None]

        soft_new_chk = _promotion_sum(new_c2v, v2c)
        soft_new_var = jnp.take_along_axis(
            soft_new_chk, jnp.broadcast_to(lbwd[None], soft_new_chk.shape), axis=-1)
        scatter_cols = jnp.where(lmask > 0, lcols, nv)
        soft = soft.at[:, scatter_cols].set(soft_new_var)
        c2v = jax.lax.dynamic_update_index_in_dim(c2v, new_c2v, r, 1)
        return (soft, c2v), None

    def cond(state):
        it, alldone, *_ = state
        return jnp.logical_and(it < max_iterations, jnp.logical_not(alldone))

    def body(state):
        it, _, soft, c2v, done, outsoft, iters = state
        (soft, c2v), _ = jax.lax.scan(layer_step, (soft, c2v), jnp.arange(m))

        hard = (soft[:, : g.kb] <= 0).astype(jnp.int32)  # (B, KB, Z)
        acc = jax.lax.reduce((hard * packed), jnp.int32(0),
                             jax.lax.bitwise_xor, (1, 2))  # (B,)
        ok = acc == 0
        newly = jnp.logical_and(ok, jnp.logical_not(done))
        outsoft = jnp.where(newly[:, None, None], soft[:, : g.kb], outsoft)
        iters = jnp.where(newly, it + 1, iters)
        done = jnp.logical_or(done, ok)
        return it + 1, jnp.all(done), soft, c2v, done, outsoft, iters

    state0 = (jnp.int32(0), jnp.asarray(False), soft0, c2v0,
              jnp.zeros((b,), bool), jnp.zeros((b, g.kb, z), jnp.int32),
              jnp.full((b,), max_iterations, jnp.int32))
    _, _, soft, _, done, outsoft, iters = jax.lax.while_loop(cond, body, state0)

    final = jnp.where(done[:, None, None], outsoft, soft[:, : g.kb])
    info = final.reshape(b, -1)
    hard = (info <= 0).astype(jnp.uint8)
    return (hard, jnp.clip(info, -LLR_INFTY, LLR_INFTY).astype(jnp.int8),
            done, iters)
