"""Layer mapping and channel precoding (TS 38.211 Sections 7.3.1.3-7.3.1.5).

Codeword -> layers is a reshape; layers -> antenna ports is one einsum over the
precoding matrix -- the matrix-unit equivalent of the reference's per-RE
AVX kernels (reference: include/srsran/phy/generic_functions/precoding/
channel_precoder.h:49-61, lib/phy/generic_functions/precoding/*).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.cplx import to_cplx, from_cplx


def layer_map(symbols, nof_layers: int):
    """(..., G) codeword symbols -> (..., nof_layers, G / nof_layers).

    TS 38.211 Table 7.3.1.3-1: x^(l)(i) = d(nof_layers * i + l).
    """
    g = symbols.shape[-1]
    return jnp.swapaxes(
        symbols.reshape(symbols.shape[:-1] + (g // nof_layers, nof_layers)), -1, -2
    )


def layer_demap(layers):
    """(..., L, M) -> (..., L*M) inverse of layer_map."""
    x = jnp.swapaxes(layers, -1, -2)
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def precode(layers_pair, weights_pair):
    """Apply a precoding matrix.

    Args:
      layers_pair: (..., L, M, 2) layer symbols (M resource elements).
      weights_pair: (P, L, 2) or (..., P, L, 2) precoding matrix.

    Returns: (..., P, M, 2) antenna-port symbols.
    """
    x = to_cplx(layers_pair)
    w = to_cplx(weights_pair)
    out = jnp.einsum("...pl,...lm->...pm", w, x)
    return from_cplx(out)


def identity_precoder(nof_ports: int, nof_layers: int, scale: float | None = None) -> np.ndarray:
    """One-layer-per-port mapping (or wideband identity-like matrix), real-pair."""
    w = np.zeros((nof_ports, nof_layers), np.complex64)
    for l in range(nof_layers):
        w[l % nof_ports, l] = 1.0
    if scale is None:
        scale = 1.0 / np.sqrt(max(1, nof_layers // nof_ports) if nof_ports >= nof_layers else nof_layers)
    w *= scale
    return np.stack([w.real, w.imag], -1).astype(np.float32)
