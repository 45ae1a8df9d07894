"""PRACH preamble generation and detection (TS 38.211 Section 6.3.3).

Generation: Zadoff-Chu roots x_u(n) = exp(-j pi u n(n+1) / L) with the standard
logical->physical root mapping (data/prach_tables.npz) and cyclic shifts
C_v = v * N_cs (unrestricted set).

Detection mirrors the reference's frequency-domain correlator
(reference: lib/phy/upper/channel_processors/prach_detector_generic_impl.cpp:89-339):
per root sequence, conj-multiply the received occasion spectrum, zero-padded
IDFT to the time domain, accumulate power per N_cs-shift window, compare the
window peak against the occasion noise floor.  All roots/windows batch into one
jitted program.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.cplx import to_cplx

LONG = 839
SHORT = 139

_DATA = Path(__file__).resolve().parent.parent / "data" / "prach_tables.npz"

#: TS 38.211 Tables 6.3.3.1-5/6/7, unrestricted set: zeroCorrelationZone -> N_cs.
NCS_UNRESTRICTED = {
    "1.25kHz": (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119, 167, 279, 419),
    "5kHz": (0, 13, 26, 33, 38, 41, 49, 55, 64, 76, 93, 119, 139, 209, 279, 419),
    "short": (0, 2, 4, 6, 8, 10, 12, 13, 15, 17, 19, 23, 27, 34, 46, 69),
}


@functools.lru_cache(maxsize=1)
def _root_luts():
    with np.load(_DATA) as z:
        return z["long_root_lut"].astype(int), z["short_root_lut"].astype(int)


def physical_root(logical_index: int, long_format: bool) -> int:
    long_lut, short_lut = _root_luts()
    lut = long_lut if long_format else short_lut
    return int(lut[logical_index % len(lut)])


def zc_sequence(u: int, length: int, cyclic_shift: int = 0) -> np.ndarray:
    """Time-domain ZC root sequence with cyclic shift, complex64 (host)."""
    n = (np.arange(length) + cyclic_shift) % length
    phase = -np.pi * u * n * (n + 1) / length
    return np.exp(1j * phase).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def zc_freq(u: int, length: int) -> np.ndarray:
    """DFT of the unshifted root sequence (host, cached)."""
    return np.fft.fft(zc_sequence(u, length)).astype(np.complex64)


_THRESH = Path(__file__).resolve().parent.parent / "data" / "prach_thresholds.npz"

#: prach_subcarrier_spacing / prach_format_type enums of the reference's
#: calibration table (prach_detector_generic_thresholds.h).
_SCS_ENUM = {15e3: 0, 30e3: 1, 60e3: 2, 120e3: 3, 1.25e3: 4, 5e3: 5}
_FMT_ENUM = {"0": 0, "1": 1, "2": 2, "3": 3, "A1": 4, "A2": 5, "A3": 6,
             "B1": 7, "B4": 8, "C0": 9, "C2": 10, "A1_B1": 11, "A2_B2": 12,
             "A3_B3": 13}


@functools.lru_cache(maxsize=1)
def _threshold_table():
    with np.load(_THRESH) as z:
        return {k: z[k].copy() for k in z.files}


def threshold_and_margin(nof_rx_ports: int, scs_hz: float, fmt: str,
                         zcz: int, combine_symbols: bool):
    """(threshold, margin, flag) from the reference's validated calibration
    table; falls back to the reference's own defaults for uncovered combos
    (reference: prach_detector_generic_thresholds.h:152-168: 2.0/5 long,
    0.3/12 short; flag "red" = combination not validated)."""
    t = _threshold_table()
    sel = ((t["nof_rx_ports"] == nof_rx_ports)
           & (t["scs"] == _SCS_ENUM[scs_hz])
           & (t["format"] == _FMT_ENUM[fmt])
           & (t["zcz"] == zcz)
           & (t["combine"] == combine_symbols))
    idx = np.flatnonzero(sel)
    if len(idx):
        i = int(idx[0])
        flag = {0: "red", 1: "orange", 2: "green"}[int(t["flag"][i])]
        return float(t["threshold"][i]), int(t["margin"][i]), flag
    if fmt in ("0", "1", "2", "3"):
        return 2.0, 5, "red"
    return 0.3, 12, "red"


@dataclass(frozen=True)
class PrachDetectorConfig:
    """Static detection configuration for one occasion format."""

    sequence_length: int          # 839 or 139
    root_sequence_index: int      # logical start index
    zero_correlation_zone: int    # index into the N_cs table
    ncs_table: str = "1.25kHz"
    nof_preambles: int = 64
    #: Preamble format ("0".."3" long; "A1".."C2" short); None = "0" for long
    #: sequences, "C0" for short.
    format: str | None = None
    #: Numerology for short formats (RA SCS = 15 kHz << numerology).
    numerology: int = 0
    #: Non-coherently combine the occasion's repeated preamble symbols before
    #: correlation (reference: prach_detector_generic_impl.cpp:222-243).
    combine_symbols: bool = True
    #: Detection threshold override; None resolves the reference's validated
    #: (threshold, margin) calibration table at detect time
    #: (reference: prach_detector_generic_thresholds.h:42-55).
    threshold: float | None = None

    @property
    def fmt(self) -> str:
        if self.format is not None:
            return self.format
        return "0" if self.sequence_length == LONG else "C0"

    @property
    def preamble(self):
        from ..ran.prach_preamble import preamble_info
        return preamble_info(self.fmt, self.numerology)

    @property
    def ncs(self) -> int:
        return NCS_UNRESTRICTED[self.ncs_table][self.zero_correlation_zone]

    @functools.cached_property
    def plan(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(roots (R,), preamble index of first shift per root (R,), shifts/root)."""
        l = self.sequence_length
        shifts_per_root = l // self.ncs if self.ncs else 1
        roots = []
        first = []
        count = 0
        logical = self.root_sequence_index
        while count < self.nof_preambles:
            roots.append(physical_root(logical, l == LONG))
            first.append(count)
            count += shifts_per_root
            logical += 1
        return np.asarray(roots), np.asarray(first), shifts_per_root


def prach_generate(cfg: PrachDetectorConfig, preamble_index: int) -> np.ndarray:
    """Frequency-domain preamble (host): DFT of the cyclically shifted root."""
    roots, first, spr = cfg.plan
    i_root = preamble_index // spr
    v = preamble_index % spr
    seq = zc_sequence(roots[i_root], cfg.sequence_length, v * cfg.ncs)
    return np.fft.fft(seq).astype(np.complex64) / np.sqrt(cfg.sequence_length)


def _detector_tables(cfg: PrachDetectorConfig, nfft: int, margin: int):
    """Host plan mirroring the reference detector's window geometry
    (reference: prach_detector_generic_impl.cpp:128-275).

    Returns (conj root spectra (R, L), window gather idx (nwin, win_len),
    reference-energy gather idx (nwin, win_len + 2*margin), win_len,
    max_delay_limit).
    """
    roots, first, spr = cfg.plan
    l = cfg.sequence_length
    cp_prach = cfg.preamble.cp_prach
    ncs = cfg.ncs
    conj_freq = np.stack([np.conj(zc_freq(int(u), l)) for u in roots])
    # win_width = min(N_cs, cp_prach) (cp_prach when Ncs == 0), at IDFT rate.
    win_seq = min(ncs, cp_prach) if ncs else cp_prach
    win_len = max((win_seq * nfft) // l, 1)
    # A preamble with shift C_v = v*Ncs peaks at lag (tau - C_v) mod L:
    # window v starts at (nfft - (Ncs*v*nfft)//L) mod nfft.
    starts = [(nfft - (ncs * v * nfft) // l) % nfft for v in range(spr)]
    win_idx = (np.asarray(starts)[:, None] + np.arange(win_len)[None, :]) % nfft
    ref_idx = ((np.asarray(starts)[:, None] - margin)
               + np.arange(win_len + 2 * margin)[None, :]) % nfft
    # Spurious-peak guard: accept delays < 0.8 * max_delay
    # (reference: prach_detector_generic_impl.cpp:165-167, 326-327).
    max_delay_seq = cp_prach if ncs == 0 else min(max(ncs, 1) - 1, cp_prach)
    max_delay = (max_delay_seq * nfft) // l
    return (conj_freq.astype(np.complex64), win_idx.astype(np.int32),
            ref_idx.astype(np.int32), win_len, max_delay)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _detect_jit(rx_freq_pair, cfg: PrachDetectorConfig, nfft: int, margin: int):
    """Reference-faithful detection metric over (B, P, S, L) occasions.

    Per (port, symbol): correlate with each root spectrum, IDFT to the delay
    domain, modulus square; per shift window accumulate the numerator
    (window power scaled nfft/L) and the noise denominator (reference energy
    over window +/- margin minus the window sample), then metric = num/|den|
    (reference: prach_detector_generic_impl.cpp:200-315).
    """
    conj_freq, win_idx, ref_idx, win_len, max_delay = _detector_tables(
        cfg, nfft, margin)
    rx = to_cplx(rx_freq_pair)  # (B, P, S, L)
    if cfg.combine_symbols:
        rx = jnp.sum(rx, axis=2, keepdims=True)  # coherent symbol combining
    prod = rx[:, :, :, None, :] * jnp.asarray(conj_freq)[None, None, None]
    corr = jnp.fft.ifft(prod, n=nfft, axis=-1)
    power = jnp.abs(corr) ** 2  # (B, P, S', R, nfft)
    l = cfg.sequence_length

    w = jnp.take(power, jnp.asarray(win_idx.reshape(-1)), axis=-1)
    w = w.reshape(power.shape[:-1] + win_idx.shape)  # (B,P,S',R,nwin,win_len)
    w = w * (np.float32(nfft) / np.float32(l))
    eref = jnp.take(power, jnp.asarray(ref_idx.reshape(-1)), axis=-1)
    eref = eref.reshape(power.shape[:-1] + ref_idx.shape).sum(-1)  # (B,P,S',R,nwin)

    # Non-coherent accumulation over ports (and symbols when not combined).
    num = jnp.sum(w, axis=(1, 2))  # (B, R, nwin, win_len)
    diff = eref[..., None] - w
    diff = jnp.where(jnp.abs(diff) < 1e-30, 1e-9, diff)
    den = jnp.abs(jnp.sum(diff, axis=(1, 2)))
    metric = num / den  # (B, R, nwin, win_len)

    # Neglect delays beyond 0.8 * max_delay (adjacent-window spill).
    delay_ok = (np.arange(win_len) < 0.8 * max_delay)
    metric = jnp.where(jnp.asarray(delay_ok)[None, None, None, :], metric,
                       -jnp.inf)
    peak = jnp.max(metric, axis=-1)
    argpeak = jnp.argmax(metric, axis=-1)

    # Device-side finishing (the reference finishes inside detect,
    # prach_detector_generic_impl.cpp:300-339): reorder the per-(root,
    # window) peaks into preamble order and scale the peak lag to a TA in
    # sequence samples, so ONE compact (B, nof_preambles) pair crosses the
    # device boundary and the host threshold scan is a vector compare.
    roots, first, spr = cfg.plan
    gr = np.zeros(cfg.nof_preambles, np.int32)
    gv = np.zeros(cfg.nof_preambles, np.int32)
    for r in range(len(roots)):
        for v in range(spr):
            idx = first[r] + v
            if idx < cfg.nof_preambles:
                gr[idx], gv[idx] = r, v
    metric_pre = peak[:, jnp.asarray(gr), jnp.asarray(gv)]
    ta_pre = (argpeak[:, jnp.asarray(gr), jnp.asarray(gv)].astype(jnp.float32)
              * np.float32(l / nfft))
    return metric_pre, ta_pre


def prach_detect(rx_freq_pair, cfg: PrachDetectorConfig, oversampling: int = 2):
    """Detect preambles in received occasion spectra.

    Args:
      rx_freq_pair: received frequency-domain occasion —
        (B, L, 2) single port/symbol, or (B, P, S, L, 2) multi-port with S
        repeated preamble symbols (non-coherently combined across ports,
        coherently across symbols when cfg.combine_symbols).
      cfg: detector configuration.

    Returns per batch: list of (preamble_index, time_advance_samples, metric)
    with metric normalized by the configuration's validated threshold
    (> 1.0 = detection), matching the reference's reported detection_metric
    (reference: prach_detector_generic_impl.cpp:332-333).
    """
    if rx_freq_pair.ndim == 3:
        rx_freq_pair = rx_freq_pair[:, None, None]
    l = cfg.sequence_length
    nof_ports = rx_freq_pair.shape[1]
    # Reference IDFT sizes: 1024 long / 256 short
    # (channel_processor_factories.h:202-203), scalable via `oversampling`.
    base = 1024 if l == LONG else 256
    nfft = base * max(1, oversampling // 2)
    if cfg.threshold is not None:
        thr, margin = cfg.threshold, 5
    else:
        thr, margin, _flag = threshold_and_margin(
            nof_ports, cfg.preamble.scs_hz, cfg.fmt,
            cfg.zero_correlation_zone, cfg.combine_symbols)
    metric, ta = _detect_jit(rx_freq_pair, cfg, nfft, margin)

    # ONE compact (B, nof_preambles) fetch; the threshold scan is a numpy
    # vector compare (reference finishes inside detect,
    # prach_detector_generic_impl.cpp:300-339).
    metric, ta = jax.device_get((metric, ta))
    results = []
    for b in range(metric.shape[0]):
        hits = np.flatnonzero(metric[b] > thr)
        results.append([(int(i), float(ta[b, i]), float(metric[b, i] / thr))
                        for i in hits])
    return results
