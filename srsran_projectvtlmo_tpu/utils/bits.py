"""Packed-bit helpers (numpy host side).

The reference keeps coded bits in a packed `bit_buffer`
(reference: include/srsran/adt/bit_buffer.h); on the device the natural carriers are
uint8 0/1 arrays for compute and packed uint32 words (LSB-first) for storage/IO.
"""

from __future__ import annotations

import numpy as np


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """uint8 0/1 array (length multiple of anything) -> uint32 words, LSB-first."""
    bits = np.asarray(bits, dtype=np.uint8)
    pad = (-len(bits)) % 32
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])
    b = np.packbits(bits.reshape(-1, 32), axis=1, bitorder="little")
    return b.view(np.uint32).reshape(-1)


def unpack_bits(words: np.ndarray, length: int) -> np.ndarray:
    """uint32 words (LSB-first) -> uint8 0/1 array of `length`."""
    w = np.asarray(words, dtype=np.uint32).reshape(-1, 1).view(np.uint8)
    bits = np.unpackbits(w, axis=1, bitorder="little").reshape(-1)
    return bits[:length]
