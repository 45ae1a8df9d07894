"""PUSCH UCI multiplexing with the CSI part-1 -> part-2 two-phase protocol.

The reference sizes CSI part 2 from the decoded part-1 payload inside the
demultiplexer (reference: lib/phy/upper/channel_processors/pusch/
pusch_processor_impl.cpp:40-92 csi-part1-feedback, ulsch_demultiplex_impl.cpp
set_csi_part2 :241).  Data-dependent sizes cannot live inside one jitted
program, so the protocol runs as two device phases with a host decision point:

  phase A: the fused PUSCH rx program with `decode_sch=False` — frontend
      (estimate, equalize, demap, descramble) -> codeword LLRs; HARQ-ACK and
      CSI part 1 decoded on device (their TS 38.212 Section 6.2.7 placement
      is independent of CSI part 2).
  host: csi2_size = part2_size_map[int(csi1 bits)]  (the FAPI adaptor's
      uci-part2 correspondence table).
  phase B (`models.pusch_rx.build_pusch_phase_b`, one program per csi2-size
      bucket): extract + decode CSI part 2, gather the SCH positions for that
      bucket's placement plan, rate-recover (+HARQ-combine) and LDPC-decode
      the SCH.

Both phases support `dynamic_params`: DM-RS references, descrambling signs
and placeholder fix signs ride as runtime inputs, so a churning UE set
compiles ONE phase-A program per shape and one phase-B program per
(shape, part2-size) bucket — the production FAPI path (`phy.upper_phy`)
uses exactly this mode.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


from ..models.pusch_rx import (
    PuschRxConfig, cached_pusch_rx_from_grid, cached_pusch_phase_b,
    flatten_tb_bits)
from ..ops.ulsch_demux import placeholder_fix_signs
from ..ran.modulation import bits_per_symbol


@dataclass(frozen=True)
class PuschUciConfig:
    #: rx.nof_harq_ack_bits / rx.nof_csi_part1_bits hold the phase-A payloads.
    rx: PuschRxConfig
    #: part2_size_map[value(csi1 bits)] -> nof csi2 bits (0 = absent).
    part2_size_map: tuple[int, ...]


@functools.lru_cache(maxsize=None)
def _phase_a_cfg(rx: PuschRxConfig) -> PuschRxConfig:
    return dataclasses.replace(rx, decode_sch=False, nof_csi_part2_bits=0)


@functools.lru_cache(maxsize=None)
def _phase_b_cfg(rx: PuschRxConfig) -> PuschRxConfig:
    return dataclasses.replace(rx, decode_sch=True, nof_csi_part2_bits=0)


class PuschUciProcessor:
    """Two-phase PUSCH processor with HARQ-ACK / CSI1 / CSI2 decoding."""

    def __init__(self, cfg: PuschUciConfig):
        self.cfg = cfg
        rx = cfg.rx
        assert rx.nof_csi_part1_bits > 0, "two-phase CSI needs part-1 bits"
        self._qm = bits_per_symbol(rx.modulation)
        self._cfg_a = _phase_a_cfg(rx)
        self._cfg_b = _phase_b_cfg(rx)
        self._phase_a = cached_pusch_rx_from_grid(self._cfg_a)

    def csi2_sizes(self, csi1_bits: np.ndarray) -> list[int]:
        """Host decision point: CSI part-2 sizes from decoded part-1 rows."""
        k = self.cfg.rx.nof_csi_part1_bits
        weights = 1 << np.arange(k - 1, -1, -1)
        values = (np.asarray(csi1_bits) * weights).sum(-1)
        return [int(self.cfg.part2_size_map[int(v)]) for v in values]

    def csi2_fix_signs(self, csi2_size: int, scr_bits) -> jnp.ndarray:
        """(B, E_csi2) int8 placeholder fix signs for the dynamic phase B
        (one row per batch element's scrambling sequence)."""
        plan, _ = self._cfg_b.demux_plan(csi2_size)
        rows = [placeholder_fix_signs(plan.csi2_bit_idx, csi2_size, self._qm, s)
                for s in scr_bits]
        return jnp.asarray(np.stack(rows), jnp.int8)

    def process(self, grid_pair, harq_buffer=None, ref_dmrs=None,
                dyn_signs=None, dyn_uci_fix=None, scr_bits=None):
        """Run both phases on an extracted-allocation grid batch.

        Static mode (rx.dynamic_params=False): only `grid_pair` (and
        optionally `harq_buffer`).  Dynamic mode additionally takes the
        fused program's runtime inputs (`ref_dmrs`, `dyn_signs`,
        `dyn_uci_fix` = (ack_fix, csi1_fix, None)) plus `scr_bits` — the
        per-row Gold scrambling bit sequences, used to derive the phase-B
        CSI-part-2 fix signs once the size is known.
        """
        cfg = self.cfg
        rx = cfg.rx
        if rx.dynamic_params:
            assert ref_dmrs is not None and dyn_signs is not None \
                and scr_bits is not None, \
                "dynamic mode takes (ref_dmrs, dyn_signs, scr_bits)"
            a = self._phase_a(grid_pair, None, ref_dmrs, dyn_signs, dyn_uci_fix)
        else:
            a = self._phase_a(grid_pair)
        csi1_np = np.asarray(a["csi1_bits"])
        sizes = self.csi2_sizes(csi1_np)
        assert len(set(sizes)) == 1, "mixed csi2 sizes in one batch not supported yet"
        csi2_size = sizes[0]

        phase_b = cached_pusch_phase_b(self._cfg_b, csi2_size)
        csi2_fix = None
        if rx.dynamic_params and csi2_size:
            csi2_fix = self.csi2_fix_signs(csi2_size, scr_bits)
        out = dict(phase_b(a["codeword_llr"], harq_buffer, csi2_fix))
        out["csi1_bits"] = csi1_np
        out["csi1_metric"] = np.asarray(a["csi1_metric"])
        out["csi1_valid"] = out["csi1_metric"] > 0.0
        out["csi2_size"] = csi2_size
        if csi2_size:
            out["csi2_valid"] = np.asarray(out["csi2_metric"]) > 0.0
        out["tb_bits"] = flatten_tb_bits(np.asarray(out["tb_bits_cb"]), rx.tbs)
        out["snr_db"], out["evm"], out["ta_s"] = a["snr_db"], a["evm"], a["ta_s"]
        if rx.nof_harq_ack_bits:
            out["harq_ack_bits"] = np.asarray(a["harq_ack_bits"])
            out["harq_ack_metric"] = np.asarray(a["harq_ack_metric"])
        return out
