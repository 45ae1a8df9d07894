"""Multi-cell slot pipelines sharded over a device mesh.

Cells (or slots in flight) ride the leading batch axis, sharded over the mesh's
"cell" axis: every per-cell program in models/ is already batched over that
axis, so partitioning is purely data parallel -- no cross-cell collectives on
the hot path, matching the reference's independent per-cell upper PHYs
(reference: lib/du_low/du_low_impl.h:31-48: one upper_phy per cell).

The codeblock axis inside each cell remains a device-local batch; sharding it
across devices (for very large TBs) is the "sp" axis of the north-star config
(parallel.cb_shard) and can be expressed by adding a second mesh axis to the shardings here.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.pusch_rx import PuschRxConfig, build_pusch_rx_slot
from ..models.ulsch_tx import build_ulsch_tx_slot


def build_multi_cell_pusch_rx(cfg: PuschRxConfig, mesh: Mesh, axis: str = "cell"):
    """Jitted fn over the mesh: samples (ncells, P, nsamp, 2) -> result dict.

    Input must be sharded (ncells over `axis`); outputs inherit the sharding.
    """
    rx = build_pusch_rx_slot(cfg)
    in_sharding = NamedSharding(mesh, P(axis, None, None, None))

    @jax.jit
    def sharded_rx(samples):
        samples = jax.lax.with_sharding_constraint(samples, in_sharding)
        return rx(samples)

    return sharded_rx


def build_multi_cell_ulsch_tx(cfg: PuschRxConfig, mesh: Mesh, axis: str = "cell"):
    tx = build_ulsch_tx_slot(cfg)
    in_sharding = NamedSharding(mesh, P(axis, None))

    @jax.jit
    def sharded_tx(tb_bits):
        tb_bits = jax.lax.with_sharding_constraint(tb_bits, in_sharding)
        return tx(tb_bits)

    return sharded_tx
