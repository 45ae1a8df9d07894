"""Complex-sample carriers with real-only device I/O.

The framework-wide convention, kept from its first target (whose runtime
could not move complex64 between host and device): complex values cross program boundaries as a trailing real/imag
pair axis `(..., 2)` in float32 (or bfloat16 for resource-grid storage, matching
the reference's cbf16 grids, reference: lib/phy/support/resource_grid_impl.h:41),
and are materialized as jnp complex64 only inside jitted programs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def to_cplx(pair):
    """(..., 2) real pair -> complex (jit-internal only)."""
    return jax.lax.complex(pair[..., 0].astype(jnp.float32), pair[..., 1].astype(jnp.float32))


def from_cplx(z, dtype=jnp.float32):
    """complex -> (..., 2) real pair."""
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1).astype(dtype)


def np_to_pair(z: np.ndarray, dtype=np.float32) -> np.ndarray:
    return np.stack([z.real, z.imag], axis=-1).astype(dtype)


def pair_to_np(pair: np.ndarray) -> np.ndarray:
    pair = np.asarray(pair)
    if pair.dtype not in (np.float32, np.float64):
        # bf16 grid storage arrives as an ml_dtypes extension dtype that
        # can't cast straight to complex; upcast through float32.
        pair = pair.astype(np.float32)
    return pair[..., 0].astype(np.complex64) + 1j * pair[..., 1].astype(np.complex64)



