"""Upper-PHY orchestration: the du_low-equivalent slot engine for one cell.

Consumes FAPI-shaped PDUs (fapi.pdus) and drives the jitted slot programs:
DL: SSB assembly + PDCCH candidates + PDSCH onto the cell resource grid, then
OFDM modulation; UL: carrier OFDM demodulation once, then PUSCH (with the
device-resident HARQ pool), PUCCH 0/1/2 and PRACH processing, producing CRC /
RxData / UCI / RACH indications.

Replaces the reference's executor/pool machinery
(reference: lib/phy/upper/upper_phy_impl.h:46-130, upper_phy_factories.cpp,
downlink_processor_single_executor_impl.cpp, uplink_processor_impl.cpp:70-153)
with per-configuration compiled-program caches; "pools" become jit caches and
batching, and task-type executors become independent program dispatches.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..fapi.pdus import (
    DlTtiRequest, UlTtiRequest, TxDataRequest,
    CrcIndication, RxDataIndication, UciIndication, RachIndication,
)
from ..models.pusch_rx import (
    PuschRxConfig, cached_pusch_rx_from_grid, flatten_tb_bits)
from ..ops import ofdm as ofdm_mod
from ..ops import prach as prach_mod
from ..ops.dmrs import dmrs_type1_sequence
from ..utils.cplx import np_to_pair, pair_to_np
from . import pucch as pucch_mod
from .harq import RxBufferPool


@dataclass
class ExpertPhyConfig:
    """Expert PHY knobs (reference: du_low_config.h:63-123).

    Every field is consumed: decoder selection and iteration count plumb
    into `PuschRxConfig` (here and in `parallel.multi_cell_phy`),
    `max_proc_delay_slots` sets the `phy.realtime.SlotPipeline` deadline
    budget, and `log_level` initializes the app logger (apps/gnb_sim.py).
    """

    pusch_decoder_max_iterations: int = 6
    #: Early-stop LDPC decoder: "cuda", "xla" or None = by platform
    #: (ops.ldpc.select; the reference's impl selection "auto",
    #: channel_coding_factories.cpp:103-110).
    ldpc_decoder: str | None = None
    max_proc_delay_slots: int = 2
    log_level: str = "warning"
    #: When set, completed UL slot grids append to this binary capture file
    #: (phy.rx_symbol_handler.RxSymbolFileDumper; the reference's YAML
    #: `phy_rx_symbols_filename`,
    #: upper_phy_rx_symbol_handler_printer_decorator.h).
    rx_symbols_filename: str | None = None


@dataclass(frozen=True)
class CellConfig:
    nof_rb: int = 273
    dft_size: int = 4096
    numerology: int = 1
    nof_tx_ports: int = 1
    nof_rx_ports: int = 1
    phys_cell_id: int = 1
    #: Subcarrier offset where the SSB sits in the carrier grid.
    ssb_subc_offset: int = 0
    #: First RB of the CORESET for PDCCH placement.
    coreset_rb_start: int = 0
    #: Store the assembled DL resource grid as bfloat16 real pairs (the
    #: analog of the reference's cbf16 grid storage, reference:
    #: lib/phy/support/resource_grid_impl.h:41-51).  Assembly still
    #: ACCUMULATES in float32 (precoding einsums, overlapping adds); only
    #: the materialized grid — what the OFDM modulator reads and what
    #: crosses the device boundary — is quantized.  EVM-bounded parity:
    #: tests/test_bf16_grid.py::test_dl_bf16_grid_parity.
    grid_bf16: bool = True

    @property
    def nof_subc(self) -> int:
        return self.nof_rb * 12


def extract_pusch_allocation(grid, pdu):
    """Slice the PUSCH allocation out of batched carrier grids
    (B, P, 14, nsubc, 2) -> (B, P, nsym, nsub_alloc, 2), hop-aware: each
    symbol's rows come from that symbol's hop PRB (reference: per-hop RE
    extraction in the PUSCH demodulator)."""
    hop = getattr(pdu, "hop_symbol", None)
    k0 = pdu.rb_start * 12
    nsub = pdu.rb_size * 12
    s0, ns = pdu.start_symbol, pdu.nof_symbols
    if hop is None:
        return grid[:, :, s0:s0 + ns, k0:k0 + nsub, :]
    k1 = pdu.second_hop_prb * 12
    return jnp.concatenate([
        grid[:, :, s0:hop, k0:k0 + nsub, :],
        grid[:, :, hop:s0 + ns, k1:k1 + nsub, :],
    ], axis=2)


def pusch_dmrs_ref_values(slot: int, pdu) -> np.ndarray:
    """(ndmrs, npil) complex64 DM-RS reference for one PUSCH PDU: type 1/2,
    CRB-indexed from the PDU's (per-hop) PRB start."""
    from ..ops.dmrs import dmrs_type2_sequence

    hop = getattr(pdu, "hop_symbol", None)

    def _prb(sym_abs: int) -> int:
        if hop is not None and sym_abs >= hop:
            return pdu.second_hop_prb
        return pdu.rb_start

    gen = (dmrs_type2_sequence if getattr(pdu, "dmrs_config_type", 1) == 2
           else dmrs_type1_sequence)
    return np.stack([
        gen(slot, s, pdu.n_id, pdu.rb_size, prb_start=_prb(s))
        for s in pdu.dmrs_symbols
    ])


class FapiValidationError(ValueError):
    """Raised when a slot message fails FAPI validation
    (reference: fapi message_validators reject + error.indication path)."""

    def __init__(self, report):
        self.report = report
        super().__init__("; ".join(str(e) for e in report.errors))


class UpperPhy:
    """One cell's upper PHY: DL slot assembly and UL slot processing."""

    def __init__(self, cfg: CellConfig, expert: ExpertPhyConfig | None = None):
        self.cfg = cfg
        self.expert = expert or ExpertPhyConfig()
        self.harq_pool = RxBufferPool()
        #: PRACH occasions skipped because their capture buffer was not fully
        #: filled (late/lost symbols): detecting on zero-padded symbols would
        #: dilute the correlation peak against thresholds calibrated for full
        #: S-symbol combining and silently miss real preambles.
        self.nof_dropped_prach_occasions = 0
        #: Retransmissions decoded WITHOUT their soft-combining history
        #: because the HARQ rx-buffer pool was exhausted (the reference flags
        #: pool exhaustion, rx_buffer_pool_impl.cpp reserve failure path).
        self.nof_dropped_harq_reservations = 0

    # ------------------------------------------------------------------ DL --

    def process_dl_slot(self, request: DlTtiRequest, tx_data: TxDataRequest | None = None,
                        validate: bool = True, fetch: bool = True):
        """Build the DL slot and return (grid (nports, nsym, nsubc) complex64
        -- squeezed to (nsym, nsubc) for single-port cells -- and the OFDM
        samples (..., nsamples, 2) float32 numpy).

        With fetch=False the raw DEVICE arrays (grid real-pair, samples) are
        returned unsynced so callers can pipeline slots (phy.realtime
        SlotPipeline) instead of blocking on the readback.

        All RE mapping (PDSCH with precoding, PDCCH, SSB, CSI-RS) happens in
        one fused device program (`phy.dl_slot.DlSlotProgram`); this method
        only computes the slot-dependent pilot/DCI values on the host.
        """
        if validate:
            from ..fapi import validators as _v

            rep = _v.validate_dl_tti_request(request)
            if tx_data is not None:
                rep.errors.extend(_v.validate_tx_data_request(tx_data, request).errors)
            if not rep.ok:
                raise FapiValidationError(rep)
        cfg = self.cfg
        slot = request.slot
        from . import dl_slot as dl_mod

        program = dl_mod.get_dl_slot_program(request, cfg)
        (tb_bits, pdsch_dmrs, pdcch_syms, pdcch_dmrs, ssb_grids,
         csi_vals) = dl_mod.build_dl_slot_inputs(program, request, tx_data, slot)

        grid_pair, samples = program.run(
            slot, tb_bits, pdsch_dmrs, pdcch_syms, pdcch_dmrs, ssb_grids,
            csi_vals, pdsch_pdus=tuple(request.pdsch),
            pdcch_pdus=tuple(request.pdcch), ssb_pdus=tuple(request.ssb))
        if not fetch:
            return grid_pair, samples
        out_grid = pair_to_np(np.asarray(grid_pair))
        if cfg.nof_tx_ports == 1:
            out_grid = out_grid[0]
            samples = samples[0]
        return out_grid, np.asarray(samples)

    # ------------------------------------------------------------------ UL --

    def process_ul_slot(self, request: UlTtiRequest, samples: np.ndarray,
                        prach_samples: "np.ndarray | PrachBuffer | None" = None,
                        validate: bool = True):
        """Process one UL slot.

        Args:
          request: the slot's UL PDUs.
          samples: (nof_rx_ports, nsamples, 2) received baseband.
          prach_samples: optional frequency-domain PRACH occasion — either an
            (L, 2) single-port array, or a `phy.prach_buffer.PrachBuffer`
            filled by the lower-PHY occasion collector; with a buffer, each
            PRACH PDU selects its occasion via its `fd_occasion` attribute
            (default 0) and all ports are combined non-coherently.

        Returns a list of indication objects.
        """
        if validate:
            from ..fapi import validators as _v

            rep = _v.validate_ul_tti_request(request)
            if not rep.ok:
                raise FapiValidationError(rep)
        cfg = self.cfg
        slot = request.slot
        indications: list = []

        grid = None
        if request.pusch or request.pucch or request.srs:
            grid = ofdm_mod.ofdm_demodulate(
                jnp.asarray(samples), cfg.nof_subc, cfg.dft_size, cfg.numerology,
                slot % (1 << cfg.numerology),
            )  # (P, 14, nsubc, 2)

        for pdu in request.pusch:
            indications.extend(self._process_pusch(slot, pdu, grid))

        for pdu in request.pucch:
            indications.append(self._process_pucch(slot, pdu, grid))

        for pdu in request.srs:
            indications.append(self._process_srs(slot, pdu, grid, samples))

        if prach_samples is not None:
            from .prach_buffer import PrachBuffer

            for pdu in request.prach:
                det_cfg = prach_mod.PrachDetectorConfig(
                    sequence_length=prach_mod.LONG if pdu.format_is_long else prach_mod.SHORT,
                    root_sequence_index=pdu.root_sequence_index,
                    zero_correlation_zone=pdu.zero_correlation_zone,
                    ncs_table="1.25kHz" if pdu.format_is_long else "short",
                )
                if isinstance(prach_samples, PrachBuffer):
                    if not prach_samples.full:
                        # Partially-captured occasion: skip detection rather
                        # than combine all-zero symbols (see
                        # nof_dropped_prach_occasions).
                        self.nof_dropped_prach_occasions += 1
                        import logging

                        logging.getLogger("upper_phy").warning(
                            "PRACH occasion at slot %d dropped: capture "
                            "buffer not fully filled", slot)
                        continue
                    # (S, P, L, 2) occasion -> (1, P, S, L, 2) detector input
                    # with multi-port non-coherent combining.
                    occ = np.transpose(
                        prach_samples.occasion(getattr(pdu, "fd_occasion", 0)),
                        (1, 0, 2, 3))[None]
                else:
                    occ = prach_samples[None]
                dets = prach_mod.prach_detect(jnp.asarray(occ), det_cfg)[0]
                indications.append(RachIndication(slot=slot, preambles=dets))

        return indications

    def _pusch_rx_cfg(self, slot, pdu, *, nof_csi2: int, two_phase: bool):
        """Dynamic-params PuschRxConfig for one PUSCH PDU (rnti/n_id/slot
        values ride as inputs; only SHAPE lands in the compile key)."""
        cfg = self.cfg
        exp = self.expert
        hop = getattr(pdu, "hop_symbol", None)
        return PuschRxConfig(
            nof_rb=pdu.rb_size, modulation=pdu.modulation,
            target_code_rate=pdu.target_code_rate, nof_layers=pdu.nof_layers,
            nof_ofdm_symbols=pdu.nof_symbols,
            dmrs_symbols=tuple(s - pdu.start_symbol for s in pdu.dmrs_symbols),
            rv=pdu.rv, rnti=0, n_id=0,
            start_symbol=pdu.start_symbol, rb_start=pdu.rb_start,
            nof_rx_ports=cfg.nof_rx_ports, dft_size=cfg.dft_size,
            numerology=cfg.numerology,
            slot=slot % (1 << cfg.numerology),
            nof_harq_ack_bits=getattr(pdu, "nof_harq_ack_bits", 0),
            nof_csi_part1_bits=getattr(pdu, "nof_csi_part1_bits", 0),
            nof_csi_part2_bits=0 if two_phase else nof_csi2,
            dmrs_config_type=getattr(pdu, "dmrs_config_type", 1),
            # The second-hop PRB is a VALUE (the hop's DM-RS reference and
            # grid rows come from the caller); normalize it to 0 in the
            # compile key so hop-PRB churn never recompiles.
            hop_symbol=hop, second_hop_prb=0 if hop is not None else None,
            nof_ldpc_iterations=exp.pusch_decoder_max_iterations,
            ldpc_decoder=exp.ldpc_decoder,
            dynamic_params=True,
        )

    def _pusch_grid_and_ref(self, slot, pdu, grid):
        """Extract the allocation grid (hop-aware) and build the per-PDU
        DM-RS reference input (type 1/2, CRB-indexed, per-hop PRBs)."""
        sub = extract_pusch_allocation(grid[None], pdu)
        ref = pusch_dmrs_ref_values(slot, pdu)
        return sub, jnp.asarray(np_to_pair(ref))[None]

    def _pusch_inputs(self, slot, pdu, grid):
        """Program configuration and device inputs for one PUSCH PDU.

        Every PDU runs through the dynamic-value program: the DM-RS
        reference (absolute slot + n_id, per-hop PRBs), descrambling signs
        (rnti/n_id) and the UCI placeholder fix signs are device INPUTS, so
        one compiled program per shape serves every UE and every slot —
        including ACK/CSI-on-PUSCH, intra-slot hopping and DM-RS type 2
        (reference analog: per-slot PDU churn,
        fapi_to_phy_translator.cpp:290-351).  CSI part 2 with a varying
        part2_size_map runs the two-phase part1->part2 protocol
        (phy.pusch_uci; reference: pusch_processor_impl.cpp:40-92).

        Returns (rx_cfg, p2map or None when single-phase, scrambling bits,
        (sub, ref_in, signs_in, uci_fix)).
        """
        nof_ack = getattr(pdu, "nof_harq_ack_bits", 0)
        nof_csi1 = getattr(pdu, "nof_csi_part1_bits", 0)
        p2map = tuple(getattr(pdu, "part2_size_map", ()) or ())
        const_csi2 = 0
        two_phase = False
        if nof_csi1 and p2map:
            if len(set(p2map)) == 1:
                const_csi2 = p2map[0]
            else:
                two_phase = True
        rx_cfg = self._pusch_rx_cfg(slot, pdu, nof_csi2=const_csi2,
                                    two_phase=two_phase)
        sub, ref_in = self._pusch_grid_and_ref(slot, pdu, grid)
        from ..ops import prg as prg_mod

        cinit = ((pdu.rnti << 15) + pdu.n_id) & 0x7FFFFFFF
        scr = prg_mod.gold_sequence_bits(cinit, rx_cfg.nof_codeword_bits)
        signs_in = jnp.asarray(1 - 2 * scr.astype(np.int8))[None]
        uci_fix = None
        if nof_ack or nof_csi1:
            from ..models.pusch_rx import cached_demux_plan
            from ..ops.ulsch_demux import placeholder_fix_signs
            from ..ran.modulation import bits_per_symbol

            qm = bits_per_symbol(pdu.modulation)
            plan, _ = cached_demux_plan(
                rx_cfg, 0 if two_phase else const_csi2)

            def fix(idx, nbits):
                if not nbits:
                    return None
                return jnp.asarray(
                    placeholder_fix_signs(idx, nbits, qm, scr), jnp.int8)[None]

            uci_fix = (fix(plan.ack_bit_idx, nof_ack),
                       fix(plan.csi1_bit_idx, nof_csi1),
                       None if two_phase
                       else fix(plan.csi2_bit_idx, const_csi2))
        return (rx_cfg, p2map if two_phase else None, scr,
                (sub, ref_in, signs_in, uci_fix))

    def pusch_program(self, slot, pdu, grid):
        """(jitted program, args) that `process_ul_slot` dispatches for a
        single-phase PUSCH PDU carrying new data, on the demodulated carrier
        `grid` (P, 14, nsubc, 2): for timing and inspecting the program."""
        rx_cfg, p2map, _, (sub, ref_in, signs_in, uci_fix) = self._pusch_inputs(
            slot, pdu, grid)
        if p2map is not None:
            raise ValueError("a PDU with a varying CSI part-2 map runs two programs")
        return cached_pusch_rx_from_grid(rx_cfg), (sub, None, ref_in, signs_in, uci_fix)

    def _process_pusch(self, slot, pdu, grid):
        nof_ack = getattr(pdu, "nof_harq_ack_bits", 0)
        nof_csi1 = getattr(pdu, "nof_csi_part1_bits", 0)
        rx_cfg, p2map, scr, (sub, ref_in, signs_in, uci_fix) = self._pusch_inputs(
            slot, pdu, grid)
        seg = rx_cfg.segmentation
        buf_idx = self.harq_pool.reserve(
            slot, pdu.rnti, pdu.harq_id, seg.nof_cb, new_data=pdu.new_data
        )
        if buf_idx is None and not pdu.new_data:
            self.nof_dropped_harq_reservations += 1
            import logging

            logging.getLogger("upper_phy").warning(
                "HARQ pool exhausted: rnti=0x%x harq=%d retransmission "
                "decodes without soft-combining history", pdu.rnti, pdu.harq_id)
        n = seg.nof_cw_bits_per_cb
        harq = None
        if buf_idx is not None and not pdu.new_data:
            harq = self.harq_pool.get_soft(buf_idx, seg.nof_cb, n)[None]

        if p2map is not None:
            from .pusch_uci import PuschUciConfig, PuschUciProcessor

            proc = PuschUciProcessor(PuschUciConfig(rx=rx_cfg,
                                                    part2_size_map=p2map))
            out = proc.process(sub, harq, ref_in, signs_in, uci_fix,
                               scr_bits=scr[None])
        else:
            rx = cached_pusch_rx_from_grid(rx_cfg)
            out = rx(sub, harq, ref_in, signs_in, uci_fix)
        if buf_idx is not None:
            self.harq_pool.store(buf_idx, seg.nof_cb, n, out["harq_soft"][0])
        ok = bool(np.asarray(out["tb_crc_ok"])[0])
        if ok:
            self.harq_pool.release(pdu.rnti, pdu.harq_id)
        inds = [
            CrcIndication(slot=slot, rnti=pdu.rnti, harq_id=pdu.harq_id, tb_crc_ok=ok),
            RxDataIndication(
                slot=slot, rnti=pdu.rnti, harq_id=pdu.harq_id,
                tb_bits=flatten_tb_bits(np.asarray(out["tb_bits_cb"]), rx_cfg.tbs)[0] if ok else None,
            ),
        ]
        if nof_ack or nof_csi1:
            csi2_n = out.get("csi2_bits")
            uci = UciIndication(
                slot=slot, rnti=pdu.rnti,
                harq_bits=(np.asarray(out["harq_ack_bits"])[0] if nof_ack
                           else np.empty(0, np.uint8)),
                uci_bits=None,
                valid=bool(np.asarray(out["harq_ack_metric"])[0] > 0.0)
                if nof_ack else bool(np.asarray(out["csi1_metric"])[0] > 0.0),
            )
            if nof_csi1:
                uci.csi1_bits = np.asarray(out["csi1_bits"])[0]
                uci.csi1_valid = bool(np.asarray(out["csi1_metric"])[0] > 0.0)
            if csi2_n is not None and np.size(np.asarray(csi2_n)) > 0:
                uci.csi2_bits = np.asarray(csi2_n)[0]
                uci.csi2_valid = bool(np.asarray(out["csi2_metric"])[0] > 0.0)
            inds.append(uci)
        return inds

    def _process_srs(self, slot, pdu, grid, samples):
        """Dispatch one SRS PDU: comb-RE extraction + channel/TA estimate ->
        SrsIndication (reference: lib/phy/upper/uplink_processor_impl.cpp
        process_srs, srs_estimator_generic_impl.cpp)."""
        from ..fapi.pdus import SrsIndication
        from ..ops import srs as srs_mod

        scfg = srs_mod.SrsConfig(
            nof_rb=pdu.nof_rb, comb_size=pdu.comb_size,
            comb_offset=pdu.comb_offset, start_symbol=pdu.start_symbol,
            nof_symbols=pdu.nof_symbols, sequence_id=pdu.sequence_id,
            cyclic_shift=pdu.cyclic_shift,
            nof_antenna_ports=pdu.nof_antenna_ports,
        )
        k0 = pdu.prb_start * 12
        sub = grid[None, :, pdu.start_symbol:pdu.start_symbol + pdu.nof_symbols,
                   k0:k0 + pdu.nof_rb * 12, :]
        est = srs_mod.srs_estimate(sub, scfg)
        ce = pair_to_np(np.asarray(est["ce_pair"]))[0]
        return SrsIndication(
            slot=slot, rnti=pdu.rnti, channel=ce,
            noise_var=float(np.mean(np.asarray(est["noise_var"]))),
            time_alignment_s=float(np.mean(np.asarray(est["ta_s"]))),
        )

    def _process_pucch(self, slot, pdu, grid):
        # Slice the allocation out of the DEVICE grid for ALL rx ports —
        # (1, P, S, 12*nof_prb, 2) — and hand it to the jitted detector; the
        # reference combines every configured port
        # (pucch_detector_impl.cpp:225-241) and reads REs from the shared
        # grid without copying it off-device.
        k0 = pdu.prb_start * 12
        sub = grid[:, pdu.start_symbol:pdu.start_symbol + pdu.nof_symbols,
                   k0:k0 + pdu.nof_prb * 12, :][None]
        if pdu.format == 0:
            f0 = pucch_mod.PucchFormat0Config(
                n_id=pdu.n_id, slot=slot, start_symbol=pdu.start_symbol,
                nof_symbols=pdu.nof_symbols,
                initial_cyclic_shift=pdu.initial_cyclic_shift,
                nof_harq_bits=pdu.nof_harq_bits, sr_opportunity=pdu.sr_opportunity,
            )
            bits, metric, sr = pucch_mod.detect_pucch_format0(sub, f0)
            return UciIndication(slot=slot, rnti=pdu.rnti,
                                 harq_bits=np.asarray(bits)[0], uci_bits=None,
                                 valid=bool(np.asarray(metric)[0] > 1.0),
                                 sr_detected=bool(np.asarray(sr)[0]))
        if pdu.format == 1:
            hop = getattr(pdu, "second_hop_prb", None)
            f1 = pucch_mod.PucchFormat1Config(
                n_id=pdu.n_id, slot=slot, start_symbol=pdu.start_symbol,
                nof_symbols=pdu.nof_symbols,
                initial_cyclic_shift=pdu.initial_cyclic_shift,
                time_domain_occ=pdu.time_domain_occ, nof_harq_bits=pdu.nof_harq_bits,
                intra_slot_hopping=hop is not None,
            )
            if hop is not None:
                # Second-hop symbols take their 12 REs from the hop's PRB
                # (still on device, all ports).
                half = pdu.nof_symbols // 2
                k1 = hop * 12
                sub = jnp.concatenate([
                    grid[:, pdu.start_symbol:pdu.start_symbol + half,
                         k0:k0 + 12, :],
                    grid[:, pdu.start_symbol + half:pdu.start_symbol + pdu.nof_symbols,
                         k1:k1 + 12, :],
                ], axis=1)[None]
            bits, metric = pucch_mod.detect_pucch_format1(sub, f1)
            return UciIndication(slot=slot, rnti=pdu.rnti,
                                 harq_bits=np.asarray(bits)[0], uci_bits=None,
                                 valid=bool(np.asarray(metric)[0] > 1.0))
        if pdu.format == 2:
            f2 = pucch_mod.PucchFormat2Config(
                n_id=pdu.n_id, n_id0=pdu.n_id0, rnti=pdu.rnti, slot=slot,
                start_symbol=pdu.start_symbol, nof_symbols=pdu.nof_symbols,
                nof_prb=pdu.nof_prb, nof_uci_bits=pdu.nof_uci_bits,
            )
            bits, ok = pucch_mod.process_pucch_format2(sub, f2)
            return UciIndication(slot=slot, rnti=pdu.rnti,
                                 harq_bits=np.empty(0, np.uint8),
                                 uci_bits=np.asarray(bits)[0],
                                 valid=bool(np.asarray(ok)[0]))
        raise ValueError(f"unsupported PUCCH format {pdu.format}")
