"""Codeblock-axis sharding: split one transport block's LDPC work across devices.

The north-star scaling config shards codeblocks over the mesh (SURVEY
Section 2.4 item 1: the reference forks CB batches onto thread pools,
pusch_decoder_impl.cpp:309-385; here the batch shards over the mesh and each
device runs its codeblocks locally -- no cross-device traffic during decoding,
one all-gather of hard bits at the end, inserted by XLA from the shardings).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ran.ldpc_params import BaseGraph
from ..ops.ldpc.decode import ldpc_decode
from ..ops.ldpc.select import es_decoder


def build_sharded_ldpc_decode(mesh: Mesh, bg: BaseGraph, z: int,
                              nof_iterations: int = 6, *, axis: str = "cb"):
    """Jitted fn: llrs (B, N) int8 with B divisible by the mesh axis size.

    Each device decodes its codeblock shard; outputs are re-assembled by XLA.
    """
    def local(llrs):
        return ldpc_decode(llrs, bg, z, nof_iterations=nof_iterations)

    sharded = shard_map(
        local, mesh=mesh,
        in_specs=P(axis, None),
        out_specs=(P(axis, None), P(axis, None)),
        check_vma=False,
    )
    return jax.jit(sharded)


def build_sharded_ldpc_decode_es(mesh: Mesh, bg: BaseGraph, z: int,
                                 crc_name: str, nof_crc_covered_bits: int,
                                 max_iterations: int = 6, *,
                                 axis: str = "cb"):
    """PRODUCTION CB-axis decode: the CRC-gated early-stop decoder chosen by
    `ops.ldpc.select` inside a shard_map over the mesh `axis` — each device
    decodes ITS codeblock shard and XLA inserts the per-codeword soft/hard-bit
    all-gather from the output shardings.  The shard_map is what keeps the
    kernel's custom call per shard, so a mesh deployment never all-gathers
    the LLRs before decode (reference analog: one task per CB on the decoder
    executor pool, pusch_decoder_impl.cpp:309-385).

    Jitted fn: llrs (B, N) int8, B divisible by the axis size ->
    (hard (B, K), soft (B, K), crc_ok (B,), iterations (B,)).
    """
    decode = es_decoder()

    def local(llrs):
        return decode(llrs, bg, z, crc_name, nof_crc_covered_bits,
                      nof_iterations=max_iterations)

    sharded = shard_map(
        local, mesh=mesh,
        in_specs=P(axis, None),
        out_specs=(P(axis, None), P(axis, None), P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(sharded)
