"""OFDM modulation / demodulation (TS 38.211 Section 5.3) as batched FFT programs.

grid -> time samples: per-symbol subcarrier mapping around DC, batched IFFT over
all symbols of the slot, cyclic-prefix insertion (long CP on the first symbol of
each half subframe), TS 38.211 Section 5.4 phase compensation, scaling.
reference: lib/phy/lower/modulation/ofdm_modulator_impl.cpp:56-101 (modulate),
ofdm_demodulator_impl.cpp:94 (demodulate).

All public entry points use real-pair I/O (see utils/cplx.py); complex math is
jit-internal.  Shapes are static per (nof_symbols, nof_subc, dft_size, mu, slot).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.cplx import to_cplx, from_cplx

SYMBOLS_PER_SLOT = 14
SYMBOLS_PER_SLOT_EXTENDED = 12


def nof_symbols_per_slot(cp: str = "normal") -> int:
    return SYMBOLS_PER_SLOT if cp == "normal" else SYMBOLS_PER_SLOT_EXTENDED


def cp_lengths(dft_size: int, mu: int, slot_in_subframe: int, cp: str = "normal") -> list[int]:
    """CP lengths in samples for the symbols of the given slot.

    Normal CP: 14 symbols, 144 * (dft/2048) samples each, plus
    16 * 2^mu * (dft/2048) on symbols at subframe position l = 0 and
    l = 7 * 2^mu (first of each half subframe): the 16-kappa term of TS
    38.211 Section 5.3.1 is NOT scaled by 2^-mu, so in samples at rate
    dft * scs it grows with 2^mu (found by the reference OFDM oracle:
    ofdm_modulator_impl get_symbol_size; slot at dft 512 / mu 1 is 7680
    samples, not 7676).  Extended CP: 12 symbols, 512 * (dft/2048) each
    (TS 38.211 Table 5.3.1-1).
    """
    if cp == "extended":
        return [512 * dft_size // 2048] * SYMBOLS_PER_SLOT_EXTENDED
    base = 144 * dft_size // 2048
    extra = 16 * (1 << mu) * dft_size // 2048
    lengths = []
    for l_slot in range(SYMBOLS_PER_SLOT):
        l_sub = slot_in_subframe * SYMBOLS_PER_SLOT + l_slot
        long_cp = l_sub == 0 or l_sub == 7 * (1 << mu)
        lengths.append(base + (extra if long_cp else 0))
    return lengths


def slot_sample_count(dft_size: int, mu: int, slot_in_subframe: int = 0,
                      cp: str = "normal") -> int:
    return (sum(cp_lengths(dft_size, mu, slot_in_subframe, cp))
            + nof_symbols_per_slot(cp) * dft_size)


@functools.lru_cache(maxsize=None)
def _phase_compensation(dft_size: int, mu: int, slot_in_subframe: int, center_freq_hz: float,
                        cp: str = "normal") -> np.ndarray:
    """Per-symbol phase compensation factors exp(-j 2 pi f_c t_start_l)."""
    scs = 15e3 * (1 << mu)
    srate = dft_size * scs
    cps = cp_lengths(dft_size, mu, slot_in_subframe, cp)
    t = 0.0
    factors = []
    for l in range(nof_symbols_per_slot(cp)):
        t_start = (t + cps[l]) / srate  # symbol body start
        factors.append(np.exp(-2j * np.pi * center_freq_hz * t_start))
        t += cps[l] + dft_size
    return np.asarray(factors, dtype=np.complex64)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def ofdm_modulate(grid_pair, dft_size: int, mu: int, slot_in_subframe: int = 0,
                  center_freq_hz: float = 0.0, scale: float = 1.0, cp: str = "normal"):
    """(..., nsym, nsubc, 2) resource grid -> (..., nsamples, 2) baseband.

    Subcarrier k in [0, nsubc) maps to DFT bin (k - nsubc/2) mod dft.
    """
    nsym = nof_symbols_per_slot(cp)
    nsubc = grid_pair.shape[-2]
    grid = to_cplx(grid_pair)  # (..., nsym, nsubc)
    half = nsubc // 2
    # Bin layout [grid upper half | guard zeros | grid lower half] as ONE
    # concatenate: the .at[].set scatter form lowered to two full-buffer
    # dynamic-update-slices worth ~50% of the modulate's device time.
    mid = jnp.zeros(grid.shape[:-1] + (dft_size - nsubc,), jnp.complex64)
    bins = jnp.concatenate([grid[..., half:], mid, grid[..., :half]], axis=-1)
    x = jnp.fft.ifft(bins, axis=-1) * (dft_size * scale)
    phase = jnp.asarray(_phase_compensation(dft_size, mu, slot_in_subframe, center_freq_hz, cp))
    x = x * phase.reshape((nsym, 1))
    cps = cp_lengths(dft_size, mu, slot_in_subframe, cp)
    pieces = []
    for l in range(nsym):
        sym = x[..., l, :]
        pieces.append(sym[..., dft_size - cps[l]:])
        pieces.append(sym)
    out = jnp.concatenate(pieces, axis=-1)
    return from_cplx(out)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6, 7, 8))
def ofdm_demodulate(samples_pair, nsubc: int, dft_size: int, mu: int,
                    slot_in_subframe: int = 0, center_freq_hz: float = 0.0,
                    scale: float = 1.0, cp: str = "normal",
                    out_dtype: str = "f32"):
    """(..., nsamples, 2) baseband -> (..., nsym, nsubc, 2) resource grid.

    out_dtype "bf16" stores the grid as bfloat16 real pairs — the analog of
    the reference's cbf16 resource grid
    (reference: lib/phy/support/resource_grid_impl.h:41-51) — halving grid
    HBM traffic between the lower PHY and the channel processors.
    """
    nsym = nof_symbols_per_slot(cp)
    x = to_cplx(samples_pair)
    cps = cp_lengths(dft_size, mu, slot_in_subframe, cp)
    offs = []
    t = 0
    for l in range(nsym):
        offs.append(t + cps[l])
        t += cps[l] + dft_size
    syms = jnp.stack([jax.lax.dynamic_slice_in_dim(x, o, dft_size, axis=-1) for o in offs], axis=-2)
    bins = jnp.fft.fft(syms, axis=-1) / jnp.complex64(dft_size)
    phase = jnp.asarray(_phase_compensation(dft_size, mu, slot_in_subframe, center_freq_hz, cp))
    bins = bins * jnp.conj(phase).reshape((nsym, 1))
    half = nsubc // 2
    grid = jnp.concatenate(
        [bins[..., dft_size - half:], bins[..., : nsubc - half]], axis=-1
    ) * jnp.complex64(scale)
    out = from_cplx(grid)
    if out_dtype == "bf16":
        out = out.astype(jnp.bfloat16)
    return out


# ----------------------------------------------------------- PRACH demod ----

def prach_window_samples(sequence_length: int, prach_scs_hz: float, sample_rate_hz: float) -> int:
    """Samples per PRACH sequence repetition: fs / prach_scs."""
    n = sample_rate_hz / prach_scs_hz
    assert abs(n - round(n)) < 1e-6, "sample rate must be a multiple of the PRACH SCS"
    return int(round(n))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def prach_demodulate(samples_pair, sequence_length: int, freq_offset_subc: int,
                     prach_scs_hz: float, sample_rate_hz: float):
    """Extract the frequency-domain PRACH occasion from baseband time samples.

    Args:
      samples_pair: (..., nwin, 2) one sequence-length window (CP already
        skipped), nwin = fs / prach_scs.
      sequence_length: 839 or 139.
      freq_offset_subc: first occupied PRACH subcarrier relative to the
        window's DC (lowest frequency of the occasion).

    Returns (..., sequence_length, 2) frequency samples.
    reference: lib/phy/lower/modulation/ofdm_prach_demodulator_impl.cpp.
    """
    nwin = prach_window_samples(sequence_length, prach_scs_hz, sample_rate_hz)
    x = to_cplx(samples_pair)
    bins = jnp.fft.fft(x, axis=-1) / jnp.complex64(np.sqrt(nwin))
    idx = (freq_offset_subc + jnp.arange(sequence_length)) % nwin
    return from_cplx(bins[..., idx])


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def prach_modulate(freq_pair, sequence_length: int, freq_offset_subc: int,
                   prach_scs_hz: float, sample_rate_hz: float):
    """Inverse of prach_demodulate: place the occasion and IFFT to time (UE side)."""
    nwin = prach_window_samples(sequence_length, prach_scs_hz, sample_rate_hz)
    z = to_cplx(freq_pair)
    bins = jnp.zeros(z.shape[:-1] + (nwin,), jnp.complex64)
    idx = (freq_offset_subc + jnp.arange(sequence_length)) % nwin
    bins = bins.at[..., idx].set(z)
    x = jnp.fft.ifft(bins, axis=-1) * jnp.complex64(np.sqrt(nwin))
    return from_cplx(x)
