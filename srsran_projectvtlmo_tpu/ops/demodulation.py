"""Soft demodulation (max-log LLRs) for BPSK ... 256QAM.

The reference implements exact max-log LLRs as per-modulation piecewise-linear
interval tables (reference: lib/phy/upper/channel_modulation/
demodulation_mapper_qam16.cpp:36-90, *_qam256.cpp:48-84).  Here the same
max-log values are computed from true constellation distances, which is exact
for Gray-mapped square QAM and maps the hot loop onto a matrix product:

    metric(y, c) = |c|^2 - 2 Re(y c*)          (the |y|^2 term cancels)
    llr_b = (min over c: b=1 - min over c: b=0) / noise_var

followed by the reference's quantization: clip at RANGE_LIMIT=20, scale to
int8 LLR_MAX=120 (lib/phy/upper/channel_modulation/*: RANGE_LIMIT_FLOAT).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ran.modulation import Modulation, bits_per_symbol
from ..utils.llr import llr_quantize
from .modulation import constellation

#: Quantization range: float LLR of +/-range maps to int8 +/-120.  The
#: reference uses 24 for the BPSK family and QPSK, 20 for the QAM orders
#: (demodulation_mapper_{qpsk,qam16,qam64,qam256}.cpp RANGE_LIMIT_FLOAT);
#: validated against its interval tables in tests/test_reference_parity.py.
RANGE_LIMIT = 20.0


def _range_limit(mod: Modulation) -> float:
    if mod in (Modulation.BPSK, Modulation.PI_2_BPSK, Modulation.QPSK):
        return 24.0
    return RANGE_LIMIT


@functools.lru_cache(maxsize=None)
def _demap_tables(mod: Modulation):
    pts = constellation(mod)  # (M,)
    qm = bits_per_symbol(mod)
    m = len(pts)
    idx = np.arange(m)
    bits = ((idx[:, None] >> np.arange(qm - 1, -1, -1)[None, :]) & 1).astype(bool)  # (M, Qm)
    c_pair = np.stack([pts.real, pts.imag], axis=-1).astype(np.float32)  # (M, 2)
    c_norm = (np.abs(pts) ** 2).astype(np.float32)
    return c_pair, c_norm, bits


def _dyadic_cover(idx: tuple[int, ...]) -> list[tuple[int, int]]:
    """Cover a sorted index set by maximal aligned dyadic blocks.

    Returns [(level, j)] meaning block [j * 2^level, (j+1) * 2^level) — the
    standard segment-tree decomposition, so per-bit minima can reuse one
    shared min pyramid instead of scanning all constellation points.
    """
    blocks = []
    runs = []
    start = prev = idx[0]
    for i in idx[1:]:
        if i != prev + 1:
            runs.append((start, prev + 1))
            start = i
        prev = i
    runs.append((start, prev + 1))
    for a, b in runs:
        while a < b:
            lev = 0
            while a % (2 << lev) == 0 and a + (2 << lev) <= b:
                lev += 1
            blocks.append((lev, a >> lev))
            a += 1 << lev
    return blocks


@functools.lru_cache(maxsize=None)
def _demap_min_plan(mod: Modulation):
    """Per-bit min-pyramid cover blocks for the separable (Gray PAM) demap.

    Returns (max_level, {(bit, value): [(level, j), ...]}); minima over each
    bit's point set reduce to a handful of pyramid lookups — bit-exact with
    the full masked min (min is exact, any association order gives the same
    result) at ~4x fewer vector ops.
    """
    tabs = _demap_axis_tables(mod)
    if tabs is None:
        return None
    pam, bit_axis, bits_pam = tabs
    covers = {}
    max_level = 0
    qm = bits_pam.shape[1]
    for b in range(qm):
        for v in (False, True):
            idx = tuple(int(i) for i in np.flatnonzero(bits_pam[:, b] == v))
            blocks = _dyadic_cover(idx)
            covers[(b, v)] = blocks
            max_level = max(max_level, max(lev for lev, _ in blocks))
    return max_level, covers


@functools.lru_cache(maxsize=None)
def _demap_axis_tables(mod: Modulation):
    """Per-axis separable demap tables for square Gray QAM.

    3GPP square QAM is a product of two Gray PAM axes (I bits = even bit
    positions, Q bits = odd): |y - c|^2 = (re - cI)^2 + (im - cQ)^2, so the
    Q-axis minimum cancels in every I-bit max-log LLR and vice versa.  This
    cuts the distance-metric working set from M points to 2*sqrt(M).

    Returns (pam (Mp,), bit_axis (Qm,) 0=I/1=Q, bits_pam (Mp, Qm) bool) or
    None when the constellation is not separable (BPSK variants).
    """
    pts = constellation(mod)
    qm = bits_per_symbol(mod)
    if qm < 2:
        return None
    m = len(pts)
    idx = np.arange(m)
    bits = ((idx[:, None] >> np.arange(qm - 1, -1, -1)[None, :]) & 1).astype(bool)
    re, im = pts.real.astype(np.float32), pts.imag.astype(np.float32)
    pam = np.unique(re)
    if len(pam) * len(pam) != m or not np.array_equal(pam, np.unique(im)):
        return None
    bit_axis = np.zeros(qm, np.int8)
    bits_pam = np.zeros((len(pam), qm), bool)
    for b in range(qm):
        # A bit is I-axis iff its value is a function of re alone.
        by_re = {}
        axis_i = True
        for j in range(m):
            key = re[j]
            if key in by_re and by_re[key] != bits[j, b]:
                axis_i = False
                break
            by_re[key] = bits[j, b]
        bit_axis[b] = 0 if axis_i else 1
        vals = re if axis_i else im
        for pi, level in enumerate(pam):
            js = np.flatnonzero(vals == level)
            vset = np.unique(bits[js, b])
            if len(vset) != 1:
                return None  # not separable on this axis
            bits_pam[pi, b] = bool(vset[0])
    return pam.astype(np.float32), bit_axis, bits_pam


def soft_demap(symbols_pair, noise_var, mod: Modulation, bit_major: bool = False):
    """Max-log soft demapping.

    Args:
      symbols_pair: (..., nsym, 2) float32 equalized symbols.  The leading
        axes are arbitrary: callers may keep the (T, S, L) slot structure so
        a slot-constant noise variance broadcasts LAZILY instead of being
        materialized per RE.
      noise_var: post-equalization noise variance, broadcastable against the
        symbols' leading axes (e.g. (..., nsym), or (..., 1, S, L) against
        (..., T, S, L)).
      mod: modulation scheme.
      bit_major: when True, return (..., Qm-leading) planes — stacked at
        axis `symbols.ndim - 2` so (B, T, S, L, 2) symbols give
        (B, Qm, T, S, L); a reshape to the rate-dematcher's deinterleaved
        (B, Qm, nre) layout is then free.  Planes are quantized to int8
        BEFORE stacking (4x less copy traffic than stacking float planes).

    Returns:
      (..., nsym * Qm) int8 LLRs (positive = bit 0), quantized at range 20;
      or bit-major int8 planes when bit_major.
    """
    c_pair, c_norm, bits = _demap_tables(mod)
    qm = bits_per_symbol(mod)
    if mod == Modulation.PI_2_BPSK:
        # Derotate odd symbols by -pi/2: (re, im) -> (im, -re).
        n = symbols_pair.shape[-2]
        odd = (jnp.arange(n) % 2 == 1)[..., None]
        rot = jnp.stack([symbols_pair[..., 1], -symbols_pair[..., 0]], -1)
        symbols_pair = jnp.where(odd, rot, symbols_pair)
    axis_tabs = _demap_axis_tables(mod)
    inf = jnp.float32(np.inf)
    if axis_tabs is not None:
        # Separable Gray QAM: per-axis PAM distances only (16 points for
        # QAM256 instead of 256) — the cross-axis minimum cancels exactly.
        # Per-bit minima come from a shared dyadic min pyramid (bit-exact
        # with a full masked min; min is associative and exact).
        pam, bit_axis, bits_pam = axis_tabs
        max_level, covers = _demap_min_plan(mod)
        x = symbols_pair.astype(jnp.float32)
        # Per-axis pyramids of scalar-expanded per-level metrics: every array
        # is (..., nsym) and every op is elementwise, so the whole demap
        # fuses into one pass over x — no (..., Mp) materialization, no
        # strided lane slicing.
        pyramids = []
        for ax in range(2):
            x2 = 2.0 * x[..., ax]
            level0 = [np.float32(p) * np.float32(p) - x2 * np.float32(p)
                      for p in pam]
            pyr = [level0]
            for _ in range(max_level):
                prev = pyr[-1]
                pyr.append([jnp.minimum(prev[2 * j], prev[2 * j + 1])
                            for j in range(len(prev) // 2)])
            pyramids.append(pyr)

        def set_min(bit: int, val: bool, ax: int):
            parts = [pyramids[ax][lev][j] for lev, j in covers[(bit, val)]]
            return functools.reduce(jnp.minimum, parts)

        llrs = []
        for b in range(qm):
            ax = int(bit_axis[b])
            llrs.append(set_min(b, True, ax) - set_min(b, False, ax))
        llr = None if bit_major else jnp.stack(llrs, axis=-1)
    else:
        # (..., nsym, M) distance metrics via one matmul.
        cross = jnp.matmul(symbols_pair.astype(jnp.float32), jnp.asarray(c_pair).T,
                           preferred_element_type=jnp.float32)
        metric = jnp.asarray(c_norm) - 2.0 * cross
        llrs = []
        for b in range(qm):
            mask1 = jnp.asarray(bits[:, b])
            min1 = jnp.min(jnp.where(mask1, metric, inf), axis=-1)
            min0 = jnp.min(jnp.where(mask1, inf, metric), axis=-1)
            llrs.append(min1 - min0)
        llr = None if bit_major else jnp.stack(llrs, axis=-1)  # (..., nsym, Qm)
    if bit_major:
        # Divide + quantize per PLANE (stays fused with each plane's mins and
        # with the broadcastable noise variance), stack int8.
        nv = noise_var
        planes = [
            llr_quantize(jnp.where(nv > 0, p / jnp.maximum(nv, 1e-38), 0.0),
                         _range_limit(mod))
            for p in llrs
        ]
        # Qm plane axis right after the batch axis: (B, Qm, ...spatial...).
        return jnp.stack(planes, axis=1)
    # Scale by 1/noise_var; zero/neg variance yields LLR 0 (reference safe_div).
    nv = noise_var[..., None]
    llr = jnp.where(nv > 0, llr / jnp.maximum(nv, 1e-38), 0.0)
    llr = llr_quantize(llr, _range_limit(mod))
    return llr.reshape(llr.shape[:-2] + (llr.shape[-2] * qm,))


def hard_demap(llrs):
    """LLR <= 0 -> bit 1."""
    return (llrs <= 0).astype(jnp.uint8)
