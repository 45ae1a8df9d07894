"""Modulation mapping, TS 38.211 Section 5.1 (BPSK ... 256QAM, Gray-coded).

bits -> constellation points via a 2^Qm lookup table gathered on device
(reference: lib/phy/upper/channel_modulation/modulation_mapper_lut_impl.cpp).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ran.modulation import Modulation, bits_per_symbol


@functools.lru_cache(maxsize=None)
def constellation(mod: Modulation) -> np.ndarray:
    """Complex64 table of 2^Qm points; index = bits MSB-first (b0 is MSB)."""
    qm = bits_per_symbol(mod)
    idx = np.arange(1 << qm)
    b = ((idx[:, None] >> np.arange(qm - 1, -1, -1)[None, :]) & 1).astype(np.float64)
    # s(b) = 1 - 2b
    s = 1.0 - 2.0 * b
    if mod in (Modulation.BPSK, Modulation.PI_2_BPSK):
        pts = s[:, 0] * (1 + 1j) / np.sqrt(2)
    elif mod == Modulation.QPSK:
        pts = (s[:, 0] + 1j * s[:, 1]) / np.sqrt(2)
    elif mod == Modulation.QAM16:
        re = s[:, 0] * (2 - s[:, 2])
        im = s[:, 1] * (2 - s[:, 3])
        pts = (re + 1j * im) / np.sqrt(10)
    elif mod == Modulation.QAM64:
        re = s[:, 0] * (4 - s[:, 2] * (2 - s[:, 4]))
        im = s[:, 1] * (4 - s[:, 3] * (2 - s[:, 5]))
        pts = (re + 1j * im) / np.sqrt(42)
    elif mod == Modulation.QAM256:
        re = s[:, 0] * (8 - s[:, 2] * (4 - s[:, 4] * (2 - s[:, 6])))
        im = s[:, 1] * (8 - s[:, 3] * (4 - s[:, 5] * (2 - s[:, 7])))
        pts = (re + 1j * im) / np.sqrt(170)
    else:
        raise ValueError(mod)
    return pts.astype(np.complex64)


def modulate_np(bits: np.ndarray, mod: Modulation) -> np.ndarray:
    """Host-side numpy mapper (for slot-prep paths that stay off-device;
    eager complex device ops are not supported by the target runtime)."""
    qm = bits_per_symbol(mod)
    table = constellation(mod)
    groups = np.asarray(bits, dtype=np.int64).reshape(-1, qm)
    weights = np.asarray([1 << (qm - 1 - i) for i in range(qm)])
    sym = table[(groups * weights).sum(-1)]
    if mod == Modulation.PI_2_BPSK:
        rot = np.where(np.arange(len(sym)) % 2 == 1, 1j, 1.0)
        sym = (sym * rot).astype(np.complex64)
    return sym


#: Per-modulation amplitude normalization (TS 38.211 Section 5.1).
_NORM = {Modulation.QPSK: 2.0, Modulation.QAM16: 10.0,
         Modulation.QAM64: 42.0, Modulation.QAM256: 170.0}


def modulate(bits, mod: Modulation):
    """bits (..., nsym * Qm) uint8 -> complex64 symbols (..., nsym).

    Square QAM evaluates the TS 38.211 nested Gray formula arithmetically
    from the bit planes — pure elementwise work that fuses with its
    producers, where a 2^Qm table lookup lowers to a slow general gather
    (the gather was >50% of the DL slot program's device profile).

    For PI_2_BPSK, even symbol indices use the base point and odd indices the
    pi/2-rotated point (TS 38.211 Section 5.1.1).
    """
    qm = bits_per_symbol(mod)
    shape = bits.shape[:-1] + (bits.shape[-1] // qm, qm)
    if mod in _NORM:
        groups = bits.reshape(shape)
        s = 1.0 - 2.0 * groups.astype(jnp.float32)  # (..., nsym, Qm)
        if mod == Modulation.QPSK:
            re, im = s[..., 0], s[..., 1]
        elif mod == Modulation.QAM16:
            re = s[..., 0] * (2.0 - s[..., 2])
            im = s[..., 1] * (2.0 - s[..., 3])
        elif mod == Modulation.QAM64:
            re = s[..., 0] * (4.0 - s[..., 2] * (2.0 - s[..., 4]))
            im = s[..., 1] * (4.0 - s[..., 3] * (2.0 - s[..., 5]))
        else:  # QAM256
            re = s[..., 0] * (8.0 - s[..., 2] * (4.0 - s[..., 4] * (2.0 - s[..., 6])))
            im = s[..., 1] * (8.0 - s[..., 3] * (4.0 - s[..., 5] * (2.0 - s[..., 7])))
        inv = np.float32(1.0 / np.sqrt(_NORM[mod]))
        return jax.lax.complex(re * inv, im * inv)
    table = jnp.asarray(constellation(mod))
    groups = bits.reshape(shape).astype(jnp.int32)
    weights = jnp.asarray([1 << (qm - 1 - i) for i in range(qm)], dtype=jnp.int32)
    idx = jnp.sum(groups * weights, axis=-1)
    sym = table[idx]
    if mod == Modulation.PI_2_BPSK:
        n = sym.shape[-1]
        rot = jnp.where(jnp.arange(n) % 2 == 1, jnp.complex64(1j), jnp.complex64(1.0))
        sym = sym * rot
    return sym


def modulate_planes(planes, mod: Modulation):
    """Square-QAM mapping from BIT PLANES: planes (..., Qm, nsym) uint8 ->
    complex64 (..., nsym).

    The TS 38.212 rate-match interleaver f[i + j*Qm] = e[i*(E/Qm) + j] makes
    bit plane i of the transmitted symbols a CONTIGUOUS slice of the e-order
    stream, so a transmitter that keeps bits in e-order needs no interleave
    permutation at all — this is the TX mirror of the receiver's bit-major
    soft demap.
    """
    assert mod in _NORM, "plane modulation covers square QAM"
    s = 1.0 - 2.0 * planes.astype(jnp.float32)  # (..., Qm, nsym)
    if mod == Modulation.QPSK:
        re, im = s[..., 0, :], s[..., 1, :]
    elif mod == Modulation.QAM16:
        re = s[..., 0, :] * (2.0 - s[..., 2, :])
        im = s[..., 1, :] * (2.0 - s[..., 3, :])
    elif mod == Modulation.QAM64:
        re = s[..., 0, :] * (4.0 - s[..., 2, :] * (2.0 - s[..., 4, :]))
        im = s[..., 1, :] * (4.0 - s[..., 3, :] * (2.0 - s[..., 5, :]))
    else:  # QAM256
        re = s[..., 0, :] * (8.0 - s[..., 2, :] * (4.0 - s[..., 4, :]
                                                  * (2.0 - s[..., 6, :])))
        im = s[..., 1, :] * (8.0 - s[..., 3, :] * (4.0 - s[..., 5, :]
                                                  * (2.0 - s[..., 7, :])))
    inv = np.float32(1.0 / np.sqrt(_NORM[mod]))
    return jax.lax.complex(re * inv, im * inv)
