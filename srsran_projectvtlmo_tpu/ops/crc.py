"""CRC calculators for TS 38.212 Section 5.1.

The reference ships generic/LUT/CLMUL CPU implementations
(reference: lib/phy/upper/channel_coding/crc_calculator_generic_impl.cpp:29-55).
On the device, CRC over GF(2) is a bit-matrix product: crc(m) = XOR over set message
bits of basis vectors r_d = x^(d + L) mod g(x), where d is the bit's distance
from the message end.  We precompute the basis once per (poly, max length) on
the host (log-doubling, vectorized) and evaluate on device as a single
matmul with an exact float32 accumulation followed by mod 2 (0/1 operands
are exact even when the inputs round to TF32, and the sums stay below 2^24).

`crc_host` gives an identical host-side numpy implementation for small inputs
and for the segmenter's per-CB CRC attachment.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

#: Generator polynomials including the leading term, as in TS 38.212 Section 5.1.
POLYS = {
    "CRC24A": (24, 0x1864CFB),
    "CRC24B": (24, 0x1800063),
    "CRC24C": (24, 0x1B2B117),
    "CRC16": (16, 0x11021),
    "CRC11": (11, 0xE21),
    "CRC6": (6, 0x61),
}


def _mul_x_matrix(order: int, poly: int) -> np.ndarray:
    """24x24 (or LxL) GF(2) matrix applying r -> r*x mod g. Bit i = coeff of x^i."""
    mat = np.zeros((order, order), dtype=np.uint8)
    g = poly & ((1 << order) - 1)  # g without the leading term
    for i in range(order):
        shifted = i + 1
        if shifted < order:
            mat[shifted, i] = 1
        else:
            for j in range(order):
                mat[j, i] = (g >> j) & 1
    return mat


@functools.lru_cache(maxsize=None)
def crc_basis(name: str, length: int) -> np.ndarray:
    """Basis matrix (length, order) uint8: row d = x^(length-1-d + order) mod g.

    Row d multiplies message bit d (MSB-first message of `length` bits).
    """
    order, poly = POLYS[name]
    a = _mul_x_matrix(order, poly)
    # r for distance 0 (last message bit): x^order mod g.
    r0 = np.zeros(order, dtype=np.uint8)
    g = poly & ((1 << order) - 1)
    for j in range(order):
        r0[j] = (g >> j) & 1
    # Build rows for distance d = 0.. by doubling: block_{2m} = [block_m ; A^m block_m].
    rows = r0[None, :].copy()
    a_pow = a.copy()  # A^m with m = current block length
    while rows.shape[0] < length:
        ext = (rows.astype(np.int64) @ a_pow.T.astype(np.int64)) % 2
        rows = np.concatenate([rows, ext.astype(np.uint8)], axis=0)
        a_pow = (a_pow.astype(np.int64) @ a_pow.astype(np.int64) % 2).astype(np.uint8)
    rows = rows[:length]
    # Distance d corresponds to message index length-1-d.
    return rows[::-1].copy()


@functools.lru_cache(maxsize=None)
def crc_zero_basis(name: str, length: int) -> np.ndarray:
    """Zero-shift basis (length, order) uint8: row i = x^(length-1-i) mod g.

    For an MSB-first sequence s = payload||crc of `length` bits,
    xor_i s_i * row_i == 0 iff the CRC checks (the appended CRC makes the
    whole sequence a multiple of g).  Used for in-loop convergence detection
    in the LDPC decoders (reference checks the CB CRC each iteration,
    lib/phy/upper/channel_coding/ldpc/ldpc_decoder_impl.cpp:126-134).
    """
    order, poly = POLYS[name]
    a = _mul_x_matrix(order, poly)
    r0 = np.zeros(order, dtype=np.uint8)
    r0[0] = 1  # x^0
    rows = r0[None, :].copy()
    a_pow = a.copy()
    while rows.shape[0] < length:
        ext = (rows.astype(np.int64) @ a_pow.T.astype(np.int64)) % 2
        rows = np.concatenate([rows, ext.astype(np.uint8)], axis=0)
        a_pow = (a_pow.astype(np.int64) @ a_pow.astype(np.int64) % 2).astype(np.uint8)
    rows = rows[:length]
    return rows[::-1].copy()


def crc_host(bits: np.ndarray, name: str) -> np.ndarray:
    """CRC of an MSB-first uint8 bit array -> uint8 bit array of CRC (MSB first)."""
    order, _ = POLYS[name]
    basis = crc_basis(name, len(bits))
    rem = (bits.astype(np.int64) @ basis.astype(np.int64)) % 2  # coeff of x^j at bit j
    return rem[::-1].astype(np.uint8)  # MSB (x^{L-1}) first


@functools.lru_cache(maxsize=None)
def _packed_basis(name: str, n: int):
    basis = crc_basis(name, n).astype(np.int64)  # (N, order)
    order = basis.shape[1]
    return (basis << np.arange(order, dtype=np.int64)).sum(-1).astype(np.int32)


def crc_device(bits, name: str):
    """Batched device CRC: bits (..., N) uint8/int -> (..., order) uint8 MSB-first.

    Short messages use one float32 matmul (exact for N < 2^24);
    long messages (transport-block CRCs over hundreds of kilobits) pack the
    basis rows into int32 lanes and XOR-reduce — ~25x less memory traffic
    than streaming the float basis, bit-identical by construction.
    """
    order, _ = POLYS[name]
    n = bits.shape[-1]
    if n >= 32768:
        mask = jnp.asarray(_packed_basis(name, n))  # (N,) int32
        terms = bits.astype(jnp.int32) * mask
        rem = jax.lax.reduce(terms, jnp.int32(0),
                             jax.lax.bitwise_xor, dimensions=(terms.ndim - 1,))
        js = jnp.arange(order - 1, -1, -1)
        return ((rem[..., None] >> js) & 1).astype(jnp.uint8)
    basis = jnp.asarray(crc_basis(name, n), dtype=jnp.float32)  # (N, order)
    rem = jnp.matmul(bits.astype(jnp.float32), basis, preferred_element_type=jnp.float32)
    rem = jnp.mod(rem.astype(jnp.int32), 2).astype(jnp.uint8)
    return rem[..., ::-1]  # MSB first


def crc_check_device_cbs(payload_bits_3d, name: str, total_len: int):
    """CRC check over the concatenation of per-CB payload bits.

    Args:
      payload_bits_3d: (..., C, Kpay) bits; the TB stream is the row-major
        concatenation truncated to `total_len` (payload + appended CRC).
      total_len: number of leading bits covered by the check.

    Returns (...) bool.  Avoids materializing the flattened TB: a
    (C, Kpay)-flatten of oddly-sized bit planes would lower to a relayout
    copy; the zero-basis rows fold the flatten into the dot_general instead.
    """
    order, _ = POLYS[name]
    c, kpay = payload_bits_3d.shape[-2], payload_bits_3d.shape[-1]
    assert c * kpay >= total_len
    basis = crc_zero_basis(name, total_len).astype(np.int64)  # (total_len, order)
    packed = np.zeros(c * kpay, np.int32)
    packed[:total_len] = (basis << np.arange(order, dtype=np.int64)
                          ).sum(-1).astype(np.int32)
    mask = jnp.asarray(packed.reshape(c, kpay))
    terms = payload_bits_3d.astype(jnp.int32) * mask
    nd = terms.ndim
    rem = jax.lax.reduce(terms, jnp.int32(0), jax.lax.bitwise_xor,
                         dimensions=(nd - 2, nd - 1))
    return rem == 0


def crc_check_device(bits_with_crc, name: str):
    """Check CRC over (..., N+order) bits: returns boolean (...) true when OK."""
    order, _ = POLYS[name]
    payload = bits_with_crc[..., :-order]
    expect = bits_with_crc[..., -order:].astype(jnp.uint8)
    got = crc_device(payload, name)
    return jnp.all(got == expect, axis=-1)
