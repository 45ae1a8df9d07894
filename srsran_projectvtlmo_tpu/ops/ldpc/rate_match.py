"""LDPC rate matching / recovery, TS 38.212 Sections 5.4.2.1-5.4.2.2.

The circular-buffer bit selection (rv-dependent k0, filler skipping) and the
row-column bit interleaver are pure index permutations, precomputed on host per
(bg, z, filler, rv, E, Qm) and applied on device as a single gather (Tx) or a
scatter-accumulate (Rx).
reference: lib/phy/upper/channel_coding/ldpc/ldpc_rate_matcher_impl.cpp:60-115,
ldpc_rate_dematcher_impl.cpp:46-184.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ...ran.ldpc_params import BaseGraph
from ...utils.llr import LLR_MAX, LLR_INFTY


def k0_index(bg: BaseGraph, rv: int, n_cb: int, z: int) -> int:
    """Starting position of the circular buffer per redundancy version (Table 5.4.2.1-2)."""
    if bg == BaseGraph.BG1:
        num = {0: 0, 1: 17, 2: 33, 3: 56}[rv]
        den = 66
    else:
        num = {0: 0, 1: 13, 2: 25, 3: 43}[rv]
        den = 50
    return (num * n_cb // (den * z)) * z


@functools.lru_cache(maxsize=None)
def rate_match_plan(
    bg: BaseGraph,
    z: int,
    nof_filler: int,
    rv: int,
    e: int,
    qm: int,
    n_cb: int | None = None,
) -> np.ndarray:
    """(E,) int32 gather indices from the N-bit circular buffer to the output bits.

    The buffer is the encoder output minus the two punctured systematic blocks:
    length N = (n_full - 2) * z.  Filler bits occupy [K - 2Z - F, K - 2Z).
    """
    n_nodes = 66 if bg == BaseGraph.BG1 else 50
    kb = 22 if bg == BaseGraph.BG1 else 10
    n = n_nodes * z
    if n_cb is None:
        n_cb = n
    k0 = k0_index(bg, rv, n_cb, z)

    filler_start = kb * z - 2 * z - nof_filler
    filler_end = kb * z - 2 * z
    is_filler = np.zeros(n_cb, dtype=bool)
    is_filler[filler_start:filler_end] = True

    order = (k0 + np.arange(n_cb)) % n_cb
    valid = order[~is_filler[order]]
    reps = -(-e // len(valid))
    sel = np.tile(valid, reps)[:e].astype(np.int32)

    # Bit interleaver: f[i + j*Qm] = e[i*(E/Qm) + j]  (Section 5.4.2.2).
    j = np.arange(e // qm)
    i = np.arange(qm)
    perm = (i[None, :] * (e // qm) + j[:, None]).reshape(-1)  # index into e for output pos j*Qm+i
    return sel[perm]


def rate_match(codeword, bg: BaseGraph, z: int, nof_filler: int, rv: int, e: int, qm: int):
    """Tx bit selection+interleave: codeword (B, N) bits -> (B, E) bits."""
    idx = jnp.asarray(rate_match_plan(bg, z, nof_filler, rv, e, qm))
    return jnp.take(codeword, idx, axis=-1)


@functools.lru_cache(maxsize=None)
def rate_dematch_plan(bg: BaseGraph, z: int, nof_filler: int, rv: int, e: int, qm: int):
    """(scatter_idx (E,), filler_mask (N,)) for Rx soft-bit recovery."""
    sel = rate_match_plan(bg, z, nof_filler, rv, e, qm)
    n_nodes = 66 if bg == BaseGraph.BG1 else 50
    kb = 22 if bg == BaseGraph.BG1 else 10
    n = n_nodes * z
    filler = np.zeros(n, dtype=bool)
    filler[kb * z - 2 * z - nof_filler:kb * z - 2 * z] = True
    return sel, filler


@functools.lru_cache(maxsize=None)
def rate_dematch_gather_plan(bg: BaseGraph, z: int, nof_filler: int, rv: int,
                             e: int, qm: int):
    """Inverse (gather) tables for rate recovery: (src (k_max, N) int32 with
    -1 = no contribution, filler_mask (N,)).

    Gathers vectorize better than scatters; a dematch is at most ceil(E/N') gathers (k_max is
    1 for code rates above 1/3, 2-3 with repetition), each a fast
    vectorized take.
    """
    sel, filler = rate_dematch_plan(bg, z, nof_filler, rv, e, qm)
    n = len(filler)
    counts = np.bincount(sel, minlength=n)
    k_max = max(1, int(counts.max()))
    src = np.full((k_max, n), -1, np.int32)
    fill = np.zeros(n, np.int64)
    for i, s in enumerate(sel):
        src[fill[s], s] = i
        fill[s] += 1
    return src, filler


@functools.lru_cache(maxsize=None)
def rate_dematch_slice_plan(bg: BaseGraph, z: int, nof_filler: int, rv: int,
                            e: int, qm: int):
    """Slice-plan fast path: when no circular-buffer wrap occurs (code rate
    above 1/3, the operating regime), the dematch is a block deinterleave
    (a reshape/transpose) followed by a handful of contiguous copies — no
    gather at all.  Returns (runs [(dst, src, len)], gaps {dst: np int8 vals})
    or None when repetition/wrap forces the gather path.
    """
    n_nodes = 66 if bg == BaseGraph.BG1 else 50
    kb = 22 if bg == BaseGraph.BG1 else 10
    n = n_nodes * z
    k0 = k0_index(bg, rv, n, z)
    filler = np.zeros(n, dtype=bool)
    filler[kb * z - 2 * z - nof_filler:kb * z - 2 * z] = True
    order = (k0 + np.arange(n)) % n
    valid = order[~filler[order]]
    if e > len(valid):
        return None  # repetition: gather path
    sel = valid[:e]
    if not np.all(np.diff(sel) >= 1):
        return None  # wrapped selection
    # Contiguous runs of sel.
    breaks = np.flatnonzero(np.diff(sel) != 1)
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks + 1, [len(sel)]])
    runs = [(int(sel[a]), int(a), int(b - a)) for a, b in zip(starts, ends)]
    gap_vals = np.where(filler, LLR_INFTY, 0).astype(np.int8)
    return runs, gap_vals, n


def rate_dematch(llrs, bg: BaseGraph, z: int, nof_filler: int, rv: int, e: int, qm: int):
    """Rx: (..., E) int8 LLRs -> (..., N) int8 circular-buffer LLRs.

    Repeated positions accumulate (saturated at +/-LLR_MAX); filler positions are
    fixed to +LLR_INFTY (bit surely 0); unseen positions are 0. Leading axes
    (batch, codeblock) are free batch dims.
    """
    plan = rate_dematch_slice_plan(bg, z, nof_filler, rv, e, qm)
    if plan is not None:
        runs, gap_vals, n = plan
        # Deinterleave (Section 5.4.2.2 inverse) as a transpose.
        x = jnp.swapaxes(llrs.reshape(llrs.shape[:-1] + (e // qm, qm)), -1, -2)
        x = x.reshape(llrs.shape[:-1] + (e,))
        x = jnp.clip(x, -LLR_MAX, LLR_MAX)
        lead = llrs.shape[:-1]
        parts = []
        pos = 0
        for dst, src, ln in runs:
            if dst > pos:
                parts.append(jnp.broadcast_to(
                    jnp.asarray(gap_vals[pos:dst]), lead + (dst - pos,)))
            parts.append(x[..., src:src + ln])
            pos = dst + ln
        if pos < n:
            parts.append(jnp.broadcast_to(
                jnp.asarray(gap_vals[pos:n]), lead + (n - pos,)))
        return jnp.concatenate(parts, axis=-1)

    src, filler = rate_dematch_gather_plan(bg, z, nof_filler, rv, e, qm)
    acc = jnp.zeros(llrs.shape[:-1] + (len(filler),), jnp.int32)
    x = llrs.astype(jnp.int32)
    for k in range(src.shape[0]):
        idx = jnp.asarray(np.maximum(src[k], 0))
        mask = jnp.asarray(src[k] >= 0)
        acc = acc + jnp.where(mask, x[..., idx], 0)
    acc = jnp.clip(acc, -LLR_MAX, LLR_MAX)
    acc = jnp.where(jnp.asarray(filler), LLR_INFTY, acc)
    return acc.astype(jnp.int8)


@functools.lru_cache(maxsize=None)
def _bit_major_pieces(bg: BaseGraph, z: int, nof_filler: int, rv: int,
                      e: int, qm: int):
    """Slice pieces of the bit-major (qm, e//qm) demap layout, in circular
    buffer order: [(dst, row, col0, col1)] plus (gap_vals, n).

    The deinterleaved (e-order) stream is exactly the row-major flattening of
    the bit-major array, so every contiguous e-run splits into at most a few
    per-row contiguous column slices — the Section 5.4.2.2 deinterleave
    disappears into slicing (no int8 transpose).
    Returns None when repetition/wrap forces the gather path.
    """
    plan = rate_dematch_slice_plan(bg, z, nof_filler, rv, e, qm)
    if plan is None:
        return None
    runs, gap_vals, n = plan
    width = e // qm
    pieces = []
    for dst, src, ln in runs:
        pos = src
        while pos < src + ln:
            row, col = divmod(pos, width)
            take = min(src + ln - pos, width - col)
            pieces.append((dst + (pos - src), row, col, col + take))
            pos += take
    return pieces, gap_vals, n


def rate_dematch_bit_major(x4, bg: BaseGraph, z: int, nof_filler: int,
                           rv: int, e: int, qm: int):
    """Rx rate recovery from bit-major demapped LLRs.

    Args:
      x4: (B, qm, C, e//qm) int8 LLRs — `soft_demap(..., bit_major=True)`
        output sliced to one equal-E codeblock group and reshaped; the
        deinterleave is implicit in this layout.

    Returns (B, C, N) int8 circular-buffer LLRs, identical to `rate_dematch`
    on the equivalent interleaved input.
    """
    plan = _bit_major_pieces(bg, z, nof_filler, rv, e, qm)
    b, _, c, width = x4.shape
    if plan is None:
        # Repetition/wrap: rebuild the interleaved stream and take the
        # gather path (rare low-rate configs).
        x = jnp.transpose(x4, (0, 2, 3, 1)).reshape(b, c, e)
        return rate_dematch(x, bg, z, nof_filler, rv, e, qm)
    pieces, gap_vals, n = plan
    xc = jnp.clip(x4, -LLR_MAX, LLR_MAX)
    lead = (b, c)
    parts = []
    pos = 0
    for dst, row, col0, col1 in pieces:
        if dst > pos:
            parts.append(jnp.broadcast_to(
                jnp.asarray(gap_vals[pos:dst]), lead + (dst - pos,)))
        parts.append(xc[:, row, :, col0:col1])
        pos = dst + (col1 - col0)
    if pos < n:
        parts.append(jnp.broadcast_to(
            jnp.asarray(gap_vals[pos:n]), lead + (n - pos,)))
    return jnp.concatenate(parts, axis=-1)


def harq_combine(buffer, new_llrs):
    """Soft-combine a dematched transmission into the HARQ buffer (promotion sum).

    reference: lib/phy/upper/channel_coding/ldpc/ldpc_rate_dematcher_impl.cpp:116
    combines with saturation; fixed bits (+/-INFTY) stay fixed.
    """
    from ...utils.llr import llr_promotion_sum

    return llr_promotion_sum(buffer, new_llrs)
