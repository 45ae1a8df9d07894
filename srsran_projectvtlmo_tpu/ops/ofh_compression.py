"""O-RAN fronthaul IQ compression (BFP + none) as batched device programs.

The reference implements O-RAN.WG4.CUS Annex A.1.2 block-floating-point
compression with per-ISA SIMD kernels and a byte-level PRB packer
(reference: lib/ofh/compression/iq_compression_bfp_impl.cpp:52-137,
lib/ofh/compression/quantizer.h:34-105,
lib/ofh/compression/iq_compression_bfp_impl.h:63-77). Here the whole
symbol's PRBs batch on leading axes and the bit-level wire packing is a
vectorized bit-expansion program, so compression of a full slot is one
fused device program feeding the fronthaul gateway.

Semantics are kept exactly:
  * quantization to Q_BIT_WIDTH=16 with gain 2^15-1 and round-to-nearest;
  * per-PRB max_abs = max(|max|, |min|-1) over the 24 real samples;
  * exponent = max(0, (16-W) - min(16-W, clz16(max_abs)-1));
  * mantissas are arithmetic right shifts by the exponent;
  * decompression scales (mantissa << exponent) back by 1/(2^15-1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MAX_IQ_WIDTH = 16
_Q_GAIN = float((1 << (MAX_IQ_WIDTH - 1)) - 1)  # 32767
NOF_SUBC = 12
SAMPLES_PER_PRB = 2 * NOF_SUBC


def _quantize16(iq_pair, iq_scaling: float):
    """float (..., 2) in [-1,1] -> int16-valued int32 (reference quantizer::to_fixed_point)."""
    scaled = iq_pair * jnp.float32(_Q_GAIN * iq_scaling)
    q = jnp.round(scaled).astype(jnp.int32)
    return jnp.clip(q, -32768, 32767)


def _bits_needed(x):
    """Number of significant bits of nonnegative x < 2^16 (16 - clz16)."""
    n = jnp.zeros_like(x)
    for k in range(MAX_IQ_WIDTH):
        n = n + (x >= (1 << k)).astype(x.dtype)
    return n


@functools.partial(jax.jit, static_argnums=(1, 2))
def bfp_compress(iq_pair, data_width: int, iq_scaling: float = 1.0):
    """BFP-compress PRBs of IQ samples.

    Args:
      iq_pair: (..., n_prb, 12, 2) float32 resource elements as real pairs.
      data_width: compressed mantissa width W in bits (1..16).
      iq_scaling: input scale applied before quantization.

    Returns:
      (mantissas (..., n_prb, 24) int32 in [-2^(W-1), 2^(W-1)-1],
       exponents (..., n_prb) int32)
    """
    assert 1 <= data_width <= MAX_IQ_WIDTH
    q = _quantize16(iq_pair, iq_scaling)
    flat = q.reshape(q.shape[:-3] + (q.shape[-3], SAMPLES_PER_PRB))
    max_v = jnp.max(flat, axis=-1)
    min_v = jnp.min(flat, axis=-1)
    # reference: iq_compression_bfp_impl.cpp:57-60 (|min|-1 avoids int16 overflow)
    max_abs = jnp.maximum(jnp.abs(max_v), jnp.abs(min_v) - 1)

    max_shift = MAX_IQ_WIDTH - data_width
    # reference: iq_compression_bfp_impl.h:63-77 (clz-based exponent)
    lz_wo_sign = jnp.where(max_abs > 0, 15 - _bits_needed(max_abs),
                           jnp.int32(max_shift))
    raw_exp = jnp.minimum(jnp.int32(max_shift), lz_wo_sign)
    exponent = jnp.maximum(0, jnp.int32(max_shift) - raw_exp)

    mant = jnp.right_shift(flat, exponent[..., None])  # arithmetic (signed)
    return mant, exponent


@functools.partial(jax.jit, static_argnums=(1, 2))
def bfp_decompress(mantissas, data_width: int, iq_scaling: float = 1.0,
                   exponents=None):
    """Inverse of bfp_compress -> (..., n_prb, 12, 2) float32.

    reference: lib/ofh/compression/iq_compression_bfp_impl.cpp:101-122.
    """
    del data_width  # mantissas arrive sign-extended already
    scaled = mantissas << exponents[..., None]
    out = scaled.astype(jnp.float32) / jnp.float32(_Q_GAIN * iq_scaling)
    return out.reshape(mantissas.shape[:-1] + (NOF_SUBC, 2))


@functools.partial(jax.jit, static_argnums=(1,))
def none_compress(iq_pair, iq_scaling: float = 1.0):
    """'none' compression = plain 16-bit quantization
    (reference: lib/ofh/compression/iq_compression_none_impl.cpp)."""
    q = _quantize16(iq_pair, iq_scaling)
    return q.reshape(q.shape[:-3] + (q.shape[-3], SAMPLES_PER_PRB))


@functools.partial(jax.jit, static_argnums=(1,))
def none_decompress(samples, iq_scaling: float = 1.0):
    out = samples.astype(jnp.float32) / jnp.float32(_Q_GAIN * iq_scaling)
    return out.reshape(samples.shape[:-1] + (NOF_SUBC, 2))


@functools.partial(jax.jit, static_argnums=(1,))
def pack_prbs(mantissas, data_width: int, exponents=None):
    """Pack per-PRB mantissas (+ optional leading exponent byte) to wire bytes.

    O-RAN U-plane udCompParam/PRB layout: one exponent byte (when exponents
    is given) followed by 24 big-endian data_width-bit fields
    (reference: lib/ofh/compression/compressed_prb_packer.cpp).

    mantissas: (..., n_prb, 24) int32. Returns (..., n_prb, nbytes) uint8.
    """
    w = data_width
    u = jnp.asarray(mantissas, jnp.int32) & ((1 << w) - 1)
    # Expand to a bitstream: bit j of sample s sits at stream position s*w+j.
    shifts = jnp.arange(w - 1, -1, -1, dtype=jnp.int32)
    bits = (u[..., None] >> shifts) & 1  # (..., 24, w)
    stream = bits.reshape(bits.shape[:-2] + (SAMPLES_PER_PRB * w,))
    pad = (-stream.shape[-1]) % 8
    if pad:
        stream = jnp.concatenate(
            [stream, jnp.zeros(stream.shape[:-1] + (pad,), stream.dtype)], -1)
    by = stream.reshape(stream.shape[:-1] + ((stream.shape[-1]) // 8, 8))
    weights = (1 << jnp.arange(7, -1, -1, dtype=jnp.int32))
    data = jnp.sum(by * weights, axis=-1).astype(jnp.uint8)
    if exponents is None:
        return data
    exp_b = exponents[..., None].astype(jnp.uint8)
    return jnp.concatenate([exp_b, data], axis=-1)


@functools.partial(jax.jit, static_argnums=(1, 2))
def unpack_prbs(prb_bytes, data_width: int, has_exponent: bool = True):
    """Inverse of pack_prbs -> (mantissas (..., 24) int32 sign-extended, exponents)."""
    w = data_width
    if has_exponent:
        exponents = prb_bytes[..., 0].astype(jnp.int32)
        data = prb_bytes[..., 1:]
    else:
        exponents = None
        data = prb_bytes
    db = data.astype(jnp.int32)
    shifts = jnp.arange(7, -1, -1, dtype=jnp.int32)
    bits = (db[..., None] >> shifts) & 1
    stream = bits.reshape(bits.shape[:-2] + (bits.shape[-2] * 8,))
    stream = stream[..., : SAMPLES_PER_PRB * w]
    fields = stream.reshape(stream.shape[:-1] + (SAMPLES_PER_PRB, w))
    weights = (1 << jnp.arange(w - 1, -1, -1, dtype=jnp.int32))
    raw = jnp.sum(fields * weights, axis=-1)
    # Sign extend from data_width (reference: quantizer::sign_extend).
    sign = 1 << (w - 1)
    mant = jnp.where(raw >= sign, raw - (1 << w), raw)
    return mant, exponents


def compress_symbol(iq_pair, params_type: str, data_width: int,
                    iq_scaling: float = 1.0):
    """Compress one symbol's worth of PRBs to wire bytes.

    iq_pair: (..., n_prb, 12, 2) float32; returns (..., n_prb, nbytes) uint8.
    Mirrors iq_compressor_selector dispatch
    (reference: lib/ofh/compression/iq_compressor_selector.cpp).
    """
    if params_type == "bfp":
        mant, exp = bfp_compress(iq_pair, data_width, iq_scaling)
        return pack_prbs(mant, data_width, exp)
    if params_type == "none":
        samples = none_compress(iq_pair, iq_scaling)
        return pack_prbs(samples, MAX_IQ_WIDTH)
    raise ValueError(f"unsupported compression type {params_type!r}")


def decompress_symbol(prb_bytes, params_type: str, data_width: int,
                      iq_scaling: float = 1.0):
    """Inverse of compress_symbol -> (..., n_prb, 12, 2) float32."""
    if params_type == "bfp":
        mant, exp = unpack_prbs(prb_bytes, data_width, True)
        return bfp_decompress(mant, data_width, iq_scaling, exponents=exp)
    if params_type == "none":
        samples, _ = unpack_prbs(prb_bytes, MAX_IQ_WIDTH, False)
        return none_decompress(samples, iq_scaling)
    raise ValueError(f"unsupported compression type {params_type!r}")


def golden_bfp_compress_prb(samples16: np.ndarray, data_width: int):
    """Scalar numpy golden model of one-PRB BFP compression for tests
    (independent port of O-RAN.WG4.CUS A.1.2 as the reference implements it)."""
    assert samples16.shape == (SAMPLES_PER_PRB,)
    max_abs = max(abs(int(samples16.max())), abs(int(samples16.min())) - 1)
    max_shift = MAX_IQ_WIDTH - data_width
    if max_abs > 0 and max_shift > 0:
        lz = 15 - int(max_abs).bit_length()
    else:
        lz = max_shift
    raw_exp = min(max_shift, lz)
    exp = max(0, max_shift - raw_exp)
    return (samples16.astype(np.int32) >> exp), exp
