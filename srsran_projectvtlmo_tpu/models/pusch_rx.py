"""PUSCH receive slot model: the Phase-2 flagship end-to-end uplink program.

One jitted program per static configuration covering the UL shared channel for
a slot: (OFDM demodulation) -> DM-RS channel estimation -> MMSE equalization ->
soft demapping -> descrambling -> rate recovery (+HARQ combining) -> layered
min-sum LDPC decoding -> CRC checks.

This replaces the reference's executor-forked PUSCH pipeline
(reference: lib/phy/upper/channel_processors/pusch/pusch_processor_impl.cpp:115-298,
pusch_decoder_impl.cpp:294-398) with one fused device program; codeblocks and
UEs batch on leading axes.

Supported envelope: DM-RS type 1, 2 CDM groups without data (DM-RS symbols
carry no PUSCH data), 1-4 layers (fd-OCC CDM per group; layers 2-3 on CDM
group 1 — the full reference port set, pusch_constants.h:47 MAX_NOF_LAYERS=4,
dmrs_pusch_estimator_impl.cpp:43-53; the reference PROCESSOR itself constrains
to 2, pusch_processor_impl.cpp:311-312), 1-4 rx ports.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ran.modulation import bits_per_symbol
from ..ops import prg as prg_mod
from ..ops import ofdm as ofdm_mod
from ..ops.crc import crc_check_device, crc_check_device_cbs
from ..ops.channel_estimate import estimate_channel_hop
from ..ops.dmrs import dmrs_type1_sequence
from ..ops.equalization import (
    mmse_weights, zf_weights, apply_weights, apply_weights_ports_first)
from ..ops.demodulation import soft_demap
from ..ops.ldpc import rate_matching as rm
from ..ops.ldpc.decode import ldpc_decode
from ..ops.ldpc.select import es_decoder
from .sch_config import SchChainConfig


@dataclass(frozen=True)
class PuschRxConfig(SchChainConfig):
    nof_rx_ports: int = 1
    dft_size: int = 4096
    numerology: int = 1
    slot: int = 0
    nof_ldpc_iterations: int = 6
    #: Early-stop LDPC decoder: "cuda" (the GPU kernel), "xla", or None to
    #: let the platform choose (ops.ldpc.select; bit-exact either way).
    ldpc_decoder: str | None = None
    #: Stop LDPC iterations per codeblock once its CRC passes (bit-exact with
    #: the reference's per-iteration CRC stop,
    #: lib/phy/upper/channel_coding/ldpc/ldpc_decoder_impl.cpp:126-134);
    #: per-CB iteration counts are reported in the result dict.
    ldpc_early_stop: bool = True
    #: Equalizer: "mmse" (reference default) or "zf"
    #: (reference: lib/phy/upper/equalization/equalize_zf_1xn.h).
    equalizer: str = "mmse"
    #: Store the demodulated resource grid as bfloat16 real pairs (the
    #: reference's cbf16 grid, resource_grid_impl.h:41-51, DEFAULT as there);
    #: estimation and equalization still run in float32 on the extracted
    #: REs.  EVM-bounded parity incl. the 4-port/2-layer north-star shape:
    #: tests/test_bf16_grid.py.
    grid_bf16: bool = True
    #: UCI payload bits multiplexed on PUSCH (TS 38.212 Section 6.2.7: <=2 ACK
    #: bits puncture the SCH, >2 and CSI are rate-matched around).
    nof_harq_ack_bits: int = 0
    nof_csi_part1_bits: int = 0
    #: Static CSI part 2 size; the dynamic part1->part2 protocol lives in
    #: phy.pusch_uci and overrides this per size bucket.
    nof_csi_part2_bits: int = 0
    alpha_scaling: float = 1.0
    beta_offset_harq_ack: float = 2.0
    beta_offset_csi_part1: float = 2.0
    beta_offset_csi_part2: float = 2.0
    #: Estimate CFO from DM-RS phase drift and derotate the data symbols'
    #: channel estimates (reference: port_channel_estimator_average_impl.cpp
    #: :245-253 compensate_cfo). Needs >= 2 DM-RS symbols to engage.
    compensate_cfo: bool = True
    #: Emit the dematched soft bits ("harq_soft") for HARQ-buffer storage
    #: (the reference always writes its rx_buffer softbits; callers that
    #: never retransmit can drop the (B, C, N) output materialization).
    emit_harq_soft: bool = True
    #: Per-batch-element cell parameters as *inputs*: the DM-RS reference and
    #: descrambling signs become runtime arrays instead of baked constants, so
    #: ONE compiled program serves many cells with different rnti/n_id/slot
    #: (the multi-cell du_low sharding path).  Compatible with UCI-on-PUSCH
    #: (fix signs ride as inputs), intra-slot hopping (per-hop DM-RS refs are
    #: inputs) and DM-RS type 2.
    dynamic_params: bool = False
    #: False = stop after the frontend + ACK/CSI-part-1 decode and return the
    #: descrambled (punct-zeroed) codeword LLRs ("codeword_llr") instead of
    #: demux+LDPC-decoding the SCH: phase A of the CSI part1->part2 protocol
    #: (the part-2 size is a host decision; `build_pusch_phase_b` finishes
    #: per size bucket).  Requires nof_csi_part1_bits > 0.
    decode_sch: bool = True
    #: DM-RS configuration type (TS 38.211 6.4.1.1.3): type 1 = comb-2
    #: pilots (6/RB per CDM group, group delta 1), type 2 = adjacent pairs
    #: at k = 6n + k' (4/RB per group, group delta 2).  The reference
    #: estimator carries both (dmrs_pusch_estimator_impl.cpp:55-66).
    dmrs_config_type: int = 1
    #: Intra-slot frequency hopping: slot symbol index (absolute) where the
    #: second hop starts, and the second hop's PRB start. The channel is
    #: estimated independently per hop and the DM-RS sequence is CRB-indexed
    #: per hop; per-hop noise/TA/CFO are averaged
    #: (reference: port_channel_estimator_average_impl.cpp:238-330 hop loop).
    #: The grid passed to the rx program is the *extracted allocation* — the
    #: caller gathers each symbol's rows from that symbol's hop offset.
    hop_symbol: int | None = None
    second_hop_prb: int | None = None

    @property
    def scs_hz(self) -> float:
        return 15e3 * (1 << self.numerology)

    def symbol_epochs_s(self) -> tuple[float, ...]:
        """Start time (s) of each slot symbol's useful part (CP excluded)."""
        from ..ops.ofdm import cp_lengths

        cps = cp_lengths(self.dft_size, self.numerology,
                         self.slot % (1 << self.numerology))
        fs = self.dft_size * self.scs_hz
        t, out = 0, []
        for cp_len in cps:
            out.append((t + cp_len) / fs)
            t += cp_len + self.dft_size
        return tuple(out)

    def ulsch_info(self, nof_csi_part2_bits: int | None = None):
        """Per-field RE/bit budget (reference: lib/ran/pusch/ulsch_info.cpp:163)."""
        from ..ran.ulsch_info import get_ulsch_information
        from ..ran.modulation import bits_per_symbol as _bps

        seg = self.segmentation
        return get_ulsch_information(
            nof_rb=self.nof_rb,
            start_symbol_index=self.start_symbol,
            nof_symbols=self.nof_ofdm_symbols,
            dmrs_symbols=tuple(self.start_symbol + s for s in self.dmrs_symbols),
            nof_layers=self.nof_layers,
            qm=_bps(self.modulation),
            target_code_rate=self.target_code_rate,
            tbs=self.tbs,
            sum_nof_cb_size=seg.nof_cb * seg.nof_bits_per_cb,
            nof_harq_ack_bits=self.nof_harq_ack_bits,
            nof_csi_part1_bits=self.nof_csi_part1_bits,
            nof_csi_part2_bits=(self.nof_csi_part2_bits
                                if nof_csi_part2_bits is None else nof_csi_part2_bits),
            alpha_scaling=self.alpha_scaling,
            beta_offset_harq_ack=self.beta_offset_harq_ack,
            beta_offset_csi_part1=self.beta_offset_csi_part1,
            beta_offset_csi_part2=self.beta_offset_csi_part2,
        )

    def demux_plan(self, nof_csi_part2_bits: int | None = None):
        """Exact TS 38.212 Section 6.2.7 placement plan for this config."""
        from ..ops.ulsch_demux import build_ulsch_demux_plan
        from ..ran.modulation import bits_per_symbol as _bps

        csi2 = (self.nof_csi_part2_bits
                if nof_csi_part2_bits is None else nof_csi_part2_bits)
        info = self.ulsch_info(csi2)
        return build_ulsch_demux_plan(
            nof_prb=self.nof_rb,
            start_symbol_index=self.start_symbol,
            nof_symbols=self.nof_ofdm_symbols,
            dmrs_symbols=tuple(self.start_symbol + s for s in self.dmrs_symbols),
            qm=_bps(self.modulation),
            nof_layers=self.nof_layers,
            nof_harq_ack_bits=self.nof_harq_ack_bits,
            nof_enc_harq_ack_bits=info.nof_harq_ack_bits,
            nof_harq_ack_rvd=info.nof_harq_ack_rvd,
            nof_csi_part1_bits=self.nof_csi_part1_bits,
            nof_enc_csi_part1_bits=info.nof_csi_part1_bits,
            nof_csi_part2_bits=csi2,
            nof_enc_csi_part2_bits=info.nof_csi_part2_bits,
        ), info


@functools.lru_cache(maxsize=None)
def cached_demux_plan(cfg: "PuschRxConfig", nof_csi_part2_bits: int | None = None):
    """Per-config cache of the Section 6.2.7 placement plan: the plan is
    shape-only (rnti/n_id-independent), so dispatch paths computing per-UE
    placeholder fix signs reuse it across the whole UE churn."""
    return cfg.demux_plan(nof_csi_part2_bits)


def flatten_tb_bits(tb_bits_cb, tbs: int):
    """(B, C, Kpay) per-codeblock payload bits -> (B, tbs) TB bits.

    Works on numpy (free view after a device fetch) or jnp arrays; the
    device program returns the per-CB layout to avoid an XLA loop-ized
    relayout copy (see build_pusch_rx_from_grid).
    """
    b = tb_bits_cb.shape[0]
    return tb_bits_cb.reshape(b, -1)[:, :tbs]


def decode_uci_field(llr_field, nof_payload_bits: int, qm: int):
    """Decode one UCI field from its extracted (B, G_field) LLRs.

    Returns (bits (B, K) uint8, metric (B,) float32): short-block ML detection
    metric for K <= 11, CRC pass (as float) for the polar path
    (reference: lib/phy/upper/channel_processors/uci/uci_decoder_impl.cpp:30-123).
    """
    from ..ops import short_block
    from ..ops import uci as uci_mod

    if nof_payload_bits <= 11:
        return short_block.detect(llr_field, nof_payload_bits, qm)
    bits, ok = uci_mod.uci_decode(
        jnp.clip(llr_field, -127, 127).astype(jnp.int8), nof_payload_bits, qm)
    return bits, ok.astype(jnp.float32)


def _decode_sch_groups(cfg: PuschRxConfig, parts, cb_ranges, harq_buffer):
    """Shared SCH decode tail (traced inside a jitted caller): per-equal-E
    group HARQ combining + early-stop LDPC decode + CB/TB CRC.

    `parts` are the per-group dematched soft buffers (B, nof_cb_in_group, N);
    `cb_ranges` the group [a, b) CB index ranges.  Used by the fused rx
    program and by the CSI part-2 phase-B program (`build_pusch_phase_b`).
    Returns {tb_crc_ok, cb_crc_ok, tb_bits_cb, ldpc_iterations, harq_soft}.
    """
    seg = cfg.segmentation
    z = seg.lifting_size
    b = parts[0].shape[0]
    c = sum(bnd - a for a, bnd in cb_ranges)
    # HARQ combining per equal-E group: the full (B, C, N) soft buffer is
    # only concatenated when a caller will store it (emit_harq_soft) —
    # the decoder itself runs per group, straight off each group's
    # dematch output.
    if harq_buffer is not None:
        parts = [rm.harq_combine(harq_buffer[:, a:bnd], part)
                 for (a, bnd), part in zip(cb_ranges, parts)]
    soft = (None if not cfg.emit_harq_soft else
            (parts[0] if len(parts) == 1
             else jnp.concatenate(parts, axis=1)))

    kp = seg.nof_payload_bits_per_cb
    if cfg.ldpc_early_stop:
        # Per-CB CRC-gated early stop inside the decoder (the kernel's CRC
        # verdict doubles as the CB CRC check).
        crc_cb = ("CRC24B" if seg.cb_crc_bits
                  else ("CRC24A" if seg.tb_crc_bits == 24 else "CRC16"))
        es_decode = es_decoder(cfg.ldpc_decoder)
        hards, oks, its = [], [], []
        for part in parts:
            cg = part.shape[1]
            h_g, _, ok_g, it_g = es_decode(
                part.reshape(b * cg, -1), seg.base_graph, z, crc_cb, kp,
                nof_iterations=cfg.nof_ldpc_iterations)
            hards.append(h_g.reshape(b, cg, -1))
            oks.append(ok_g.reshape(b, cg))
            its.append(it_g.reshape(b, cg))
        hard = hards[0] if len(hards) == 1 else jnp.concatenate(hards, 1)
        cb_ok = oks[0] if len(oks) == 1 else jnp.concatenate(oks, 1)
        ldpc_iters = its[0] if len(its) == 1 else jnp.concatenate(its, 1)
    else:
        hards = []
        for part in parts:
            cg = part.shape[1]
            h_g, _ = ldpc_decode(part.reshape(b * cg, -1), seg.base_graph, z,
                                 nof_iterations=cfg.nof_ldpc_iterations)
            hards.append(h_g.reshape(b, cg, -1))
        hard = hards[0] if len(hards) == 1 else jnp.concatenate(hards, 1)
        cb_ok = None
        ldpc_iters = jnp.full((b, c), cfg.nof_ldpc_iterations, jnp.int32)

    payload_bits = hard[:, :, :kp]
    if seg.cb_crc_bits:
        if cb_ok is None:
            cb_ok = crc_check_device(payload_bits, "CRC24B")
        payload3 = payload_bits[:, :, : kp - seg.cb_crc_bits]
    else:
        if cb_ok is None:
            cb_ok = jnp.ones((b, c), bool)
        payload3 = payload_bits
    crc_name = "CRC24A" if seg.tb_crc_bits == 24 else "CRC16"
    # TB CRC straight off the (B, C, Kpay) planes; the TB payload is
    # likewise returned per-CB ("tb_bits_cb") because the device-side
    # (B, C, Kpay) -> (B, tbs) flatten would be a relayout copy on the
    # device — `flatten_tb_bits` does it for free on fetched numpy arrays.
    tb_ok = crc_check_device_cbs(payload3, crc_name,
                                 cfg.tbs + seg.tb_crc_bits)
    return {
        "tb_crc_ok": tb_ok,
        "cb_crc_ok": cb_ok,
        "tb_bits_cb": payload3,
        "ldpc_iterations": ldpc_iters,
        "harq_soft": soft,
    }


def build_pusch_phase_b(cfg: PuschRxConfig, nof_csi_part2_bits: int):
    """Phase B of the CSI part1->part2 protocol, one program per part-2 size
    bucket: codeword LLRs from phase A (`decode_sch=False`) -> CSI part 2
    decode + SCH rate recovery (+HARQ combining) + LDPC decode + CRCs.

    Returns jitted fn(llr (B, G) int8, harq_buffer=None, csi2_fix=None):
    `csi2_fix` is the (B, E_csi2) placeholder fix-sign input in dynamic mode
    (rnti/n_id ride as values); baked from cfg's scrambling otherwise.
    reference: pusch_processor_impl.cpp:40-92 (csi-part1-feedback),
    ulsch_demultiplex_impl.cpp:241 (set_csi_part2).
    """
    qm = bits_per_symbol(cfg.modulation)
    seg = cfg.segmentation
    z = seg.lifting_size
    plan, info = cfg.demux_plan(nof_csi_part2_bits)
    es = cfg.cb_rate_match_sizes(info.nof_ul_sch_bits)
    c = seg.nof_cb
    offsets = np.concatenate([[0], np.cumsum(es)]).astype(int)
    groups: dict[int, list[int]] = {}
    for j in range(c):
        groups.setdefault(int(es[j]), []).append(j)
    if not cfg.dynamic_params and nof_csi_part2_bits:
        from ..ops.ulsch_demux import placeholder_fix_signs

        scr_bits = prg_mod.gold_sequence_bits(cfg.scrambling_cinit(),
                                              cfg.nof_codeword_bits)
        csi2_fix_static = placeholder_fix_signs(
            plan.csi2_bit_idx, nof_csi_part2_bits, qm, scr_bits)

    @jax.jit
    def phase_b(llr, harq_buffer=None, csi2_fix=None):
        b = llr.shape[0]
        out = {}
        if nof_csi_part2_bits:
            csi2_llr = llr[:, jnp.asarray(plan.csi2_bit_idx)].astype(jnp.int32)
            fix = (csi2_fix.astype(jnp.int32) if cfg.dynamic_params
                   else jnp.asarray(csi2_fix_static, jnp.int32))
            out["csi2_bits"], out["csi2_metric"] = decode_uci_field(
                csi2_llr * fix, nof_csi_part2_bits, qm)
        sch_llr = llr[:, jnp.asarray(plan.sch_bit_idx)]
        parts = []
        for e_val, js in groups.items():
            assert js == list(range(js[0], js[-1] + 1)), "E groups not contiguous"
            cb_llr = sch_llr[:, offsets[js[0]]:offsets[js[-1] + 1]]
            cb_llr = cb_llr.reshape(b, len(js), e_val)
            parts.append(rm.rate_dematch(cb_llr, seg.base_graph, z,
                                         seg.nof_filler_bits_per_cb, cfg.rv,
                                         e_val, qm))
        out.update(_decode_sch_groups(
            cfg, parts, [(js[0], js[-1] + 1) for _, js in groups.items()],
            harq_buffer))
        return out

    return phase_b


@functools.lru_cache(maxsize=None)
def cached_pusch_phase_b(cfg: PuschRxConfig, nof_csi_part2_bits: int):
    return build_pusch_phase_b(cfg, nof_csi_part2_bits)


def build_pusch_rx_from_grid(cfg: PuschRxConfig):
    """Jitted fn: grid (B, P, nsym, nsubc_alloc, 2)[, harq_buffer] -> result dict.

    The grid covers exactly the PUSCH allocation (nof_rb RBs, all its symbols).
    """
    seg = cfg.segmentation
    qm = bits_per_symbol(cfg.modulation)
    plan, info = cfg.demux_plan()
    es = cfg.cb_rate_match_sizes(info.nof_ul_sch_bits)
    c = seg.nof_cb
    z = seg.lifting_size
    offsets = np.concatenate([[0], np.cumsum(es)]).astype(int)

    hopping = cfg.hop_symbol is not None
    if hopping:
        assert cfg.second_hop_prb is not None, "hop_symbol needs second_hop_prb"
        assert cfg.nof_layers == 1, "frequency hopping supported for 1 layer"
    if not cfg.decode_sch:
        assert cfg.nof_csi_part1_bits > 0 and cfg.nof_csi_part2_bits == 0, \
            "decode_sch=False is phase A of the CSI protocol (csi1>0, csi2=0)"
    if cfg.dynamic_params:
        # UCI-on-PUSCH, hopping and DM-RS type 2 are all dynamic-compatible:
        # the Section 6.2.7 placement plan and the hop symbol split depend
        # only on SHAPE (payload sizes, allocation, hop symbol); the
        # rnti/n_id/slot-derived values (per-hop DM-RS references,
        # descrambling signs, placeholder fix signs) arrive as runtime
        # inputs, so per-UE churn reuses one compiled program
        # (reference analog: fapi_to_phy_translator.cpp:290-351).
        pass

    def _hop_of(sym_abs: int) -> int:
        return 1 if hopping and sym_abs >= cfg.hop_symbol else 0

    def _prb_start(sym_abs: int) -> int:
        return cfg.second_hop_prb if _hop_of(sym_abs) else cfg.rb_start

    dmrs_type2 = cfg.dmrs_config_type == 2
    if dmrs_type2:
        assert not hopping, "DM-RS type 2 supports the non-hopping path"
        from ..ops.dmrs import dmrs_type2_sequence

        ref = np.stack([
            dmrs_type2_sequence(cfg.slot, cfg.start_symbol + s, cfg.n_id,
                                cfg.nof_rb, prb_start=cfg.rb_start)
            for s in cfg.dmrs_symbols
        ])
    else:
        ref = np.stack([
            dmrs_type1_sequence(cfg.slot, cfg.start_symbol + s, cfg.n_id, cfg.nof_rb,
                                prb_start=_prb_start(cfg.start_symbol + s))
            for s in cfg.dmrs_symbols
        ])
    ref_pair = np.stack([ref.real, ref.imag], axis=-1).astype(np.float32)

    nof_hops = 2 if hopping else 1
    #: Per hop: indices into the DM-RS symbol axis / the data symbol axis.
    dmrs_hop_sel = [
        [i for i, s in enumerate(cfg.dmrs_symbols)
         if _hop_of(cfg.start_symbol + int(s)) == k]
        for k in range(nof_hops)
    ]
    data_hop_count = [
        sum(1 for s in cfg.data_symbols if _hop_of(cfg.start_symbol + int(s)) == k)
        for k in range(nof_hops)
    ]
    if hopping:
        assert all(dmrs_hop_sel[k] for k in range(nof_hops)), \
            "each hop needs at least one DM-RS symbol"
    if dmrs_type2:
        from ..ops.dmrs import dmrs_type2_subcarriers

        pil_subc = dmrs_type2_subcarriers(cfg.nof_rb)
        comb_delta, cdm_stride = 2, 6   # group delta / pair-center spacing
    else:
        pil_subc = (2 * np.arange(6 * cfg.nof_rb)).astype(np.int32)
        comb_delta, cdm_stride = 1, 4
    descr_signs = 1 - 2 * prg_mod.gold_sequence_bits(
        cfg.scrambling_cinit(), cfg.nof_codeword_bits
    ).astype(np.int32)

    data_syms = np.asarray(cfg.data_symbols, dtype=np.int32)
    dmrs_syms = np.asarray(cfg.dmrs_symbols, dtype=np.int32)

    epochs = cfg.symbol_epochs_s()
    dmrs_epochs = tuple(epochs[cfg.start_symbol + int(s)] for s in cfg.dmrs_symbols)
    data_epochs = np.asarray(
        [epochs[cfg.start_symbol + int(s)] for s in cfg.data_symbols], np.float32)
    all_epochs = np.asarray(
        [epochs[cfg.start_symbol + s] for s in range(cfg.nof_ofdm_symbols)],
        np.float32)

    nlayers = cfg.nof_layers

    from ..ops.ulsch_demux import placeholder_fix_signs

    scr_bits = prg_mod.gold_sequence_bits(cfg.scrambling_cinit(), cfg.nof_codeword_bits)
    ack_fix = placeholder_fix_signs(plan.ack_bit_idx, cfg.nof_harq_ack_bits, qm, scr_bits)
    csi1_fix = placeholder_fix_signs(plan.csi1_bit_idx, cfg.nof_csi_part1_bits, qm, scr_bits)
    csi2_fix = placeholder_fix_signs(plan.csi2_bit_idx, cfg.nof_csi_part2_bits, qm, scr_bits)

    weights_fn = {"mmse": mmse_weights, "zf": zf_weights}[cfg.equalizer]

    @jax.jit
    def rx(grid, harq_buffer=None, ref_dmrs=None, dyn_signs=None,
           dyn_uci_fix=None):
        if cfg.dynamic_params:
            assert ref_dmrs is not None and dyn_signs is not None, \
                "dynamic_params programs take (grid, harq, ref_dmrs, dyn_signs)"
        rx_pilots = grid[:, :, dmrs_syms][:, :, :, pil_subc, :].astype(jnp.float32)
        b = grid.shape[0]
        nre = cfg.nof_data_re
        # Data REs stay in the grid's native ports-leading layout; the
        # (B, P, T, S) -> (B, T, S, P) permutation folds into the equalizer
        # einsum instead of materializing a transposed copy.  Non-hopping
        # paths equalize ALL slot symbols (the estimate is slot-constant) and
        # gather the data symbols from the ~5x smaller equalized output
        # instead of from the raw multi-port grid.
        grid_f = grid.astype(jnp.float32)
        if hopping:
            data = grid_f[:, :, data_syms]  # (B, P, nsym_d, nsubc, 2)

        # Equalizer weights are computed ONCE per subcarrier (the estimate is
        # slot-constant) and applied across the data symbols; the CFO
        # correction commutes to a per-symbol phase rotation of the outputs
        # (h' = h e^{j a} => W(h') y = e^{-j a} W(h) y, same post-eq noise).
        if nlayers == 1 and not dmrs_type2:
            # One estimate per hop (hop = the whole allocation when not
            # hopping); per-hop noise/TA/CFO are then averaged
            # (reference: port_channel_estimator_average_impl.cpp:238-330).
            eq_hops, nv_hops, noise_hops, ta_hops, cfo_hops = [], [], [], [], []
            sym_off = 0
            for k in range(nof_hops):
                sel = np.asarray(dmrs_hop_sel[k], np.int32)
                epochs_k = tuple(dmrs_epochs[i] for i in dmrs_hop_sel[k])
                if cfg.dynamic_params:
                    ref_k = ref_dmrs[:, sel]  # (B, nsel, npil, 2) broadcasts
                else:
                    ref_k = jnp.asarray(ref_pair[dmrs_hop_sel[k]])
                est = jax.vmap(
                    lambda g, r=ref_k, e=epochs_k: estimate_channel_hop(
                        g, r, cfg.nof_rb, 2, cfg.scs_hz, e),
                    in_axes=1, out_axes=0,
                )(rx_pilots[:, :, sel])
                ce = est["ce_pair"]  # (P, B, nsubc, 2)
                h_sub = jnp.transpose(ce, (1, 2, 0, 3))[..., None, :]  # (B, S, P, 1, 2)
                nvar_port = jnp.transpose(est["noise_var"], (1, 0))  # (B, P)
                w_k, nv_k = weights_fn(h_sub, nvar_port)  # (B,S,1,P,2), (B,S,1)
                if hopping:
                    y_k = data[:, :, sym_off:sym_off + data_hop_count[k]]
                    eq_hops.append(apply_weights_ports_first(w_k, y_k))
                    nv_hops.append(jnp.broadcast_to(
                        nv_k[:, None], (b, data_hop_count[k], cfg.nof_subc, 1)))
                else:
                    w_full = w_k  # applied after CFO is known (fused rotation)
                    nv_struct = nv_k[:, None]  # (B, 1, S, 1): lazy over T
                sym_off += data_hop_count[k]
                noise_hops.append(est["noise_var"])  # (P, B)
                ta_hops.append(est["time_alignment_s"])
                if len(epochs_k) >= 2:
                    cfo_hops.append(est["cfo_hz"])
            if hopping:
                eq = jnp.concatenate(eq_hops, axis=1)
                eq_nvar = (nv_hops[0] if nof_hops == 1
                           else jnp.concatenate(nv_hops, axis=1))
            noise = sum(noise_hops) / nof_hops
            ta = sum(ta_hops) / nof_hops
            cfo_b = (jnp.mean(sum(cfo_hops) / len(cfo_hops), axis=0)
                     if (cfg.compensate_cfo and cfo_hops) else None)
        else:
            # Type-1 CDM: despread the fd-OCC over adjacent pilot pairs to split
            # the per-layer least-squares estimates, then smooth/interpolate each
            # at stride 4 (reference: dmrs_pusch_estimator_impl.cpp layer CDM).
            # Layers {0,1} ride CDM group 0 (even subcarriers, delta=0) and
            # layers {2,3} CDM group 1 (odd subcarriers, delta=1) with the
            # same fd-OCC pair, per TS 38.211 Table 6.4.1.1.3-1 ports
            # 0-3 (reference: dmrs_pusch_estimator_impl.cpp:43-53).
            from ..utils.cplx import to_cplx, from_cplx

            if cfg.dynamic_params:
                ref_c = to_cplx(ref_dmrs)[:, None]  # (B, 1, ndmrs, npil)
            else:
                ref_c = jnp.asarray(ref)[None, None]  # (1, 1, ndmrs, npil)
            layer_lse = []
            for comb in range((nlayers + 1) // 2):
                if comb == 0:
                    yp = to_cplx(rx_pilots)  # (B, P, S, npil)
                else:
                    yp = to_cplx(grid[:, :, dmrs_syms][
                        :, :, :, pil_subc + comb * comb_delta, :
                    ].astype(jnp.float32))
                lse = yp * jnp.conj(ref_c)
                pairs = lse.reshape(lse.shape[:-1] + (lse.shape[-1] // 2, 2))
                layer_lse.append(pairs.mean(-1))
                if 2 * comb + 1 < nlayers:
                    layer_lse.append((pairs[..., 0] - pairs[..., 1]) * 0.5)
            despread = jnp.stack(layer_lse, axis=0)  # (L, B, P, S, npil/2)
            ones = jnp.stack(
                [jnp.ones_like(despread[0].real), jnp.zeros_like(despread[0].real)], -1
            )
            despread_pair = from_cplx(despread)

            def est_layer_port(g):
                return estimate_channel_hop(g, ones[0, 0], cfg.nof_rb,
                                            cdm_stride, cfg.scs_hz,
                                            dmrs_epochs)

            # vmap over layers (axis 0) and rx ports (axis 1 after the outer
            # vmap strips L): per-(layer, port) estimates with the DM-RS
            # symbol axis intact inside the estimator.
            est = jax.vmap(
                jax.vmap(est_layer_port, in_axes=1, out_axes=0), in_axes=0, out_axes=0
            )(despread_pair)
            ce = est["ce_pair"]  # (L, P, B, nsubc, 2)
            noise = jnp.mean(est["noise_var"], axis=0)  # (P, B)
            ta = est["time_alignment_s"][0]

            h_sub = jnp.transpose(ce, (2, 3, 1, 0, 4))  # (B, S, P, L, 2)
            nvar_port = jnp.transpose(noise, (1, 0))  # (B, P)
            w_full, nv = weights_fn(h_sub, nvar_port)  # (B,S,L,P,2), (B,S,L)
            # Slot-constant noise broadcasts LAZILY over the symbol axis
            # instead of materializing the (B, T, S, L) broadcast.
            nv_struct = nv[:, None]  # (B, 1, S, L)
            cfo_b = (jnp.mean(est["cfo_hz"], axis=(0, 1))
                     if (cfg.compensate_cfo and len(dmrs_epochs) >= 2) else None)

        if not hopping:
            # Equalize every slot symbol in the grid's native layout with the
            # CFO derotation conj(e^{j 2 pi t cfo}) fused into the same pass,
            # then gather the data symbols from the equalized output.
            rot_all = None
            if cfo_b is not None:
                ang = (2.0 * np.pi) * cfo_b[:, None] * jnp.asarray(all_epochs)[None, :]
                rot_all = jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1)
            eq = apply_weights_ports_first(w_full, grid_f, rot_all)[:, data_syms]
        elif cfo_b is not None:
            # Hopping path: post-hoc derotation of the concatenated hops.
            ang = (2.0 * np.pi) * cfo_b[:, None] * jnp.asarray(data_epochs)[None, :]
            cr = jnp.cos(ang)[:, :, None, None]
            ci = jnp.sin(ang)[:, :, None, None]
            er, ei = eq[..., 0], eq[..., 1]
            eq = jnp.stack([er * cr + ei * ci, ei * cr - er * ci], axis=-1)

        # Layer demap: d(L*i + l) = x_l(i), REs symbol-major.  Non-hopping
        # paths keep eq in its (B, T, S, L, 2) structure through the demap so
        # the slot-constant noise variance broadcasts lazily; the flat
        # (B, nre*L) noise is only materialized where a gather-indexed
        # consumer (UCI placement) needs it.
        eq_struct = eq
        eq = eq_struct.reshape(b, nre * nlayers, 2)
        if hopping:
            eq_nvar = eq_nvar.reshape(b, nre * nlayers)
        else:
            eq_nvar = None  # built on demand (UCI path)

        def eq_nvar_flat():
            if eq_nvar is not None:
                return eq_nvar
            return jnp.broadcast_to(
                nv_struct, (b, len(data_syms), cfg.nof_subc, nlayers)
            ).reshape(b, nre * nlayers)

        # Batch codeblocks with equal rate-match size into one dematch
        # (typically <= 2 groups): CBs are a batch axis, not a loop.  The
        # groups are contiguous CB ranges (TS 38.212 assigns the smaller E to
        # the first CBs), so each group's LLRs reshape for free — no stack of
        # per-CB slices, no scatter.
        groups: dict[int, list[int]] = {}
        for j in range(c):
            groups.setdefault(int(es[j]), []).append(j)

        has_uci = bool(cfg.nof_harq_ack_bits or cfg.nof_csi_part1_bits
                       or cfg.nof_csi_part2_bits)
        uci_out = {}
        if not has_uci:
            # Bit-major fast path (no UCI => SCH placement is the identity):
            # demap emits per-bit planes (B, Qm, nre*L), which IS the
            # rate-dematcher's deinterleaved order — the Section 5.4.2.2
            # deinterleave and the SCH gather both vanish.
            # Flat RE axis for the planes: int8 arrays need a large minor
            # dimension (a structured (B,T,S,L) int8 layout relayouts badly).
            llr_bm = soft_demap(eq, eq_nvar_flat(), cfg.modulation,
                                bit_major=True)
            if cfg.dynamic_params:
                signs_bm = jnp.transpose(
                    dyn_signs.reshape(b, nre * nlayers, qm), (0, 2, 1))
            else:
                signs_bm = jnp.asarray(
                    descr_signs.reshape(nre * nlayers, qm).T)[None]
            llr_bm = jnp.clip(llr_bm.astype(jnp.int32) * signs_bm.astype(jnp.int32),
                              -127, 127).astype(jnp.int8)
            ack_bits = jnp.zeros((b, 0), jnp.uint8)
            ack_metric = jnp.zeros((b,), jnp.float32)
            parts = []
            for e_val, js in groups.items():
                assert js == list(range(js[0], js[-1] + 1)), "E groups not contiguous"
                width = e_val // qm
                re0 = offsets[js[0]] // qm
                x4 = llr_bm[:, :, re0:re0 + len(js) * width]
                x4 = x4.reshape(b, qm, len(js), width)
                parts.append(rm.rate_dematch_bit_major(
                    x4, seg.base_graph, z, seg.nof_filler_bits_per_cb,
                    cfg.rv, e_val, qm))
        else:
            llr = soft_demap(eq, eq_nvar_flat(), cfg.modulation)  # (B, nre*L*qm) int8

            if cfg.dynamic_params:
                llr = llr.astype(jnp.int32) * dyn_signs.astype(jnp.int32)
            else:
                llr = llr.astype(jnp.int32) * jnp.asarray(descr_signs)[None, :]
            llr = jnp.clip(llr, -127, 127).astype(jnp.int8)

            # Placeholder fix signs: rnti/n_id-derived, so runtime inputs in
            # dynamic mode ((B, G_field) each) and baked constants otherwise.
            if cfg.dynamic_params and (cfg.nof_harq_ack_bits
                                       or cfg.nof_csi_part1_bits
                                       or cfg.nof_csi_part2_bits):
                assert dyn_uci_fix is not None, \
                    "dynamic_params with UCI takes dyn_uci_fix=(ack, csi1, csi2)"
                d_ack, d_csi1, d_csi2 = dyn_uci_fix
            else:
                d_ack = d_csi1 = d_csi2 = None
            if cfg.nof_harq_ack_bits:
                ack_llr = llr[:, jnp.asarray(plan.ack_bit_idx)].astype(jnp.int32)
                ack_llr = ack_llr * (d_ack.astype(jnp.int32) if d_ack is not None
                                     else jnp.asarray(ack_fix, jnp.int32))
                ack_bits, ack_metric = decode_uci_field(ack_llr, cfg.nof_harq_ack_bits, qm)
            else:
                ack_bits = jnp.zeros((b, 0), jnp.uint8)
                ack_metric = jnp.zeros((b,), jnp.float32)
            if len(plan.punct_bit_idx):
                # <=2-bit ACK punctures: those positions carry no SCH/CSI2 info
                # (the reference zeroes the RE after ACK extraction, before the
                # CSI part 2 and SCH demux: ulsch_demultiplex_impl.cpp:493/499).
                llr = llr.at[:, jnp.asarray(plan.punct_bit_idx)].set(0)
            if cfg.nof_csi_part1_bits:
                csi1_llr = llr[:, jnp.asarray(plan.csi1_bit_idx)].astype(jnp.int32)
                csi1_llr = csi1_llr * (d_csi1.astype(jnp.int32) if d_csi1 is not None
                                       else jnp.asarray(csi1_fix, jnp.int32))
                uci_out["csi1_bits"], uci_out["csi1_metric"] = decode_uci_field(
                    csi1_llr, cfg.nof_csi_part1_bits, qm)
            if not cfg.decode_sch:
                # Phase A of the CSI part1->part2 protocol: stop before the
                # part2/SCH demux (their placement depends on the part-2
                # size, a host decision from the decoded part 1) and hand
                # the descrambled punct-zeroed codeword LLRs to
                # `build_pusch_phase_b` (reference sizes part 2 from decoded
                # part 1 inside the processor,
                # pusch_processor_impl.cpp:40-92).
                from ..ops.evm import evm as evm_fn

                if eq_nvar is not None:
                    snr_a = jnp.mean(1.0 / jnp.maximum(eq_nvar, 1e-9), axis=-1)
                else:
                    snr_a = jnp.mean(1.0 / jnp.maximum(nv_struct[:, 0], 1e-9),
                                     axis=(-1, -2))
                return {
                    "codeword_llr": llr,
                    "harq_ack_bits": ack_bits,
                    "harq_ack_metric": ack_metric,
                    "snr_db": 10.0 * jnp.log10(jnp.maximum(snr_a, 1e-9)),
                    "evm": evm_fn(eq, cfg.modulation),
                    "ta_s": jnp.mean(ta, axis=0),
                    **uci_out,
                }
            if cfg.nof_csi_part2_bits:
                csi2_llr = llr[:, jnp.asarray(plan.csi2_bit_idx)].astype(jnp.int32)
                csi2_llr = csi2_llr * (d_csi2.astype(jnp.int32) if d_csi2 is not None
                                       else jnp.asarray(csi2_fix, jnp.int32))
                uci_out["csi2_bits"], uci_out["csi2_metric"] = decode_uci_field(
                    csi2_llr, cfg.nof_csi_part2_bits, qm)
            sch_llr = llr[:, jnp.asarray(plan.sch_bit_idx)]

            parts = []
            for e_val, js in groups.items():
                assert js == list(range(js[0], js[-1] + 1)), "E groups not contiguous"
                cb_llr = sch_llr[:, offsets[js[0]]:offsets[js[-1] + 1]]
                cb_llr = cb_llr.reshape(b, len(js), e_val)
                parts.append(rm.rate_dematch(cb_llr, seg.base_graph, z,
                                             seg.nof_filler_bits_per_cb, cfg.rv,
                                             e_val, qm))
        sch_out = _decode_sch_groups(
            cfg, parts, [(js[0], js[-1] + 1) for _, js in groups.items()],
            harq_buffer)

        if eq_nvar is not None:
            snr = jnp.mean(1.0 / jnp.maximum(eq_nvar, 1e-9), axis=-1)
        else:
            snr = jnp.mean(1.0 / jnp.maximum(nv_struct[:, 0], 1e-9),
                           axis=(-1, -2))
        snr_db = 10.0 * jnp.log10(jnp.maximum(snr, 1e-9))

        # channel_state_information: EVM over the equalized symbols
        # (reference reports SNR+EVM+TA per PUSCH result,
        # lib/phy/upper/channel_processors/pusch/pusch_processor_result_notifier.h).
        from ..ops.evm import evm as evm_fn

        evm_val = evm_fn(eq, cfg.modulation)

        return {
            "evm": evm_val,
            "snr_db": snr_db,
            "ta_s": jnp.mean(ta, axis=0),
            "harq_ack_bits": ack_bits,
            "harq_ack_metric": ack_metric,
            **sch_out,
            **uci_out,
        }

    return rx


def build_pusch_rx_slot(cfg: PuschRxConfig):
    """Jitted fn: samples (B, nports, nsamples, 2) -> result dict (demod included).

    Convenience wrapper for loopback tests where the allocation spans the
    whole (small) carrier.
    """
    from_grid = build_pusch_rx_from_grid(cfg)

    @jax.jit
    def rx(samples_pair, harq_buffer=None):
        grid = ofdm_mod.ofdm_demodulate(
            samples_pair, cfg.nof_subc, cfg.dft_size, cfg.numerology,
            cfg.slot % (1 << cfg.numerology),
            out_dtype="bf16" if cfg.grid_bf16 else "f32",
        )
        return from_grid(grid, harq_buffer)

    return rx


@functools.lru_cache(maxsize=None)
def cached_pusch_rx(cfg: PuschRxConfig):
    return build_pusch_rx_slot(cfg)


@functools.lru_cache(maxsize=None)
def cached_pusch_rx_from_grid(cfg: PuschRxConfig):
    return build_pusch_rx_from_grid(cfg)
