"""Batched simplified-successive-cancellation (SSC) polar decoder.

Min-sum f/g recursion over the code tree, unrolled at trace time for the
static (N, frozen set, PC set) of a PolarCode; the batch axis carries PDCCH
candidates / UCI words.  Constituent-node pruning happens AT TRACE TIME —
the array-program counterpart of the reference's runtime SSC dispatch
(reference: lib/phy/upper/channel_coding/polar/polar_decoder_impl.cpp:209-374
rate-0/rate-1/repetition node handling):

 * rate-0 (all frozen): emits constant zeros, no recursion;
 * rate-1 (all info): per-position hard decision + one GF(2) butterfly;
 * repetition (info = last leaf only): sign of the LLR sum;
 * SPC (frozen = first leaf only): hard decisions with a parity flip at the
   least-reliable position.

Parity-check bits use the allocator's 5-stage cyclic register.  Pruned
subtrees update the register in closed form: after an m-leaf subtree,
final[q] = orig[(q+m) % 5] XOR (info bits u_j with (j+1-m) % 5 == q), so
PC-polar codes prune identically to plain ones.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .code import PolarCode


def _gf2_transform(x):
    """u = F^{(x)n} x over the last axis (F is an involution over GF(2))."""
    m = x.shape[-1]
    h = 1
    while h < m:
        y = x.reshape(x.shape[:-1] + (m // (2 * h), 2, h))
        a = y[..., 0, :] ^ y[..., 1, :]
        x = jnp.concatenate([a[..., None, :], y[..., 1:2, :]], -2)
        x = x.reshape(x.shape[:-3] + (m,))
        h *= 2
    return x


def _reg_update(reg, m: int, u, info_locals):
    """Closed-form PC-register update across a pruned m-leaf subtree.

    u: (..., m) decoded subtree bits; info_locals: local indices of info
    leaves.  final[q] = orig[(q+m)%5] ^ xor{u_j : (j+1-m)%5 == q}.
    """
    rot = tuple(reg[(q + m) % 5] for q in range(5))
    if not len(info_locals):
        return rot
    out = list(rot)
    for q in range(5):
        js = [j for j in info_locals if (j + 1 - m) % 5 == q]
        if not js:
            continue
        if len(js) == 1:
            acc = u[..., js[0]]
        else:
            sel = u[..., jnp.asarray(np.asarray(js))]
            acc = (jnp.sum(sel.astype(jnp.int32), axis=-1) & 1).astype(jnp.uint8)
        out[q] = out[q] ^ acc
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _decode_fn(code: PolarCode):
    frozen = code.frozen_mask
    pc_set = set(code.pc_set.tolist())

    def leaf(i: int, llr, reg):
        # Rotate the PC register (always, for every leaf index).
        reg = (reg[1], reg[2], reg[3], reg[4], reg[0])
        if frozen[i]:
            bit = jnp.zeros(llr.shape, jnp.uint8)
        elif i in pc_set:
            bit = reg[0]
        else:
            bit = (llr <= 0).astype(jnp.uint8)
            reg = (reg[0] ^ bit, reg[1], reg[2], reg[3], reg[4])
        return bit, reg

    def rec(llr, base: int, reg):
        m = llr.shape[-1]
        sub = frozen[base:base + m]
        has_pc = any((base + j) in pc_set for j in range(m))
        if not has_pc and m >= 2:
            if sub.all():  # rate-0
                z = jnp.zeros(llr.shape, jnp.uint8)
                return z, z, _reg_update(reg, m, z, [])
            if not sub.any():  # rate-1
                x = (llr <= 0).astype(jnp.uint8)
                u = _gf2_transform(x)
                return x, u, _reg_update(reg, m, u, list(range(m)))
            if sub[:-1].all() and not sub[-1]:  # repetition
                bit = (jnp.sum(llr, axis=-1) <= 0).astype(jnp.uint8)
                x = jnp.broadcast_to(bit[..., None], llr.shape)
                u = jnp.concatenate(
                    [jnp.zeros(llr.shape[:-1] + (m - 1,), jnp.uint8),
                     bit[..., None]], -1)
                return x, u, _reg_update(reg, m, u, [m - 1])
            if sub[0] and not sub[1:].any():  # single parity check
                x = (llr <= 0).astype(jnp.uint8)
                parity = (jnp.sum(x.astype(jnp.int32), -1) & 1).astype(jnp.uint8)
                amin = jnp.argmin(jnp.abs(llr), axis=-1)
                flip = (jnp.arange(m) == amin[..., None]).astype(jnp.uint8)
                x = x ^ (parity[..., None] * flip)
                u = _gf2_transform(x)
                return x, u, _reg_update(reg, m, u, list(range(1, m)))
        if m == 1:
            bit, reg = leaf(base, llr[..., 0], reg)
            return bit[..., None], bit[..., None], reg
        half = m // 2
        a, b = llr[..., :half], llr[..., half:]
        f = jnp.sign(a) * jnp.sign(b) * jnp.minimum(jnp.abs(a), jnp.abs(b))
        xl, ul, reg = rec(f, base, reg)
        g = b + (1.0 - 2.0 * xl.astype(llr.dtype)) * a
        xr, ur, reg = rec(g, base + half, reg)
        return jnp.concatenate([xl ^ xr, xr], -1), jnp.concatenate([ul, ur], -1), reg

    @jax.jit
    def decode(llrs):
        x = llrs.astype(jnp.float32)
        b = x.shape[:-1]
        reg = tuple(jnp.zeros(b, jnp.uint8) for _ in range(5))
        _, u, _ = rec(x, 0, reg)
        return u

    return decode


def polar_decode(llrs, code: PolarCode):
    """(B, N) LLRs (int8 or float; positive = bit 0) -> (B, N) decoded u."""
    return _decode_fn(code)(llrs)
