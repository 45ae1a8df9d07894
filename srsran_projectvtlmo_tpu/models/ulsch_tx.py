"""UL-SCH transmitter matching PuschRxConfig -- the UE-side emulator.

Produces the waveform the PUSCH receiver expects: SCH codeword chain (via
models.sch_tx) multiplexed with encoded UCI per TS 38.212 Section 6.2.7
(shared placement plan from ops.ulsch_demux), DM-RS type 1 (full symbol,
2 CDM groups), OFDM modulate.  Used by loopback/BLER tests and benchmarks
(the reference exercises its PUSCH Rx the same way,
tests/integrationtests/phy/upper/channel_processors/pxsch_bler_test.cpp:332-458).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.dmrs import dmrs_type1_sequence
from ..ops import ofdm as ofdm_mod
from ..ops import prg as prg_mod
from ..ops import short_block
from ..ops.modulation import modulate
from ..ops.ulsch_demux import scramble_codeword_with_placeholders
from ..ran.modulation import bits_per_symbol
from .pusch_rx import PuschRxConfig
from .sch_tx import build_sch_codeword_tx


def _uci_field_encoder(nof_payload_bits: int, nof_enc_bits: int, qm: int):
    """Returns a traced encoder bits (B, K) -> (B, G_field) for K <= 11.

    K <= 2 gathers from the 2^K placeholder-aware codeword table; 3 <= K <= 11
    is the RM(32, K) basis matmul tiled cyclically (TS 38.212 Section 5.3.3).
    """
    if nof_payload_bits <= 2:
        table = np.stack([
            short_block.encode_host(
                np.array([(m >> (nof_payload_bits - 1 - i)) & 1
                          for i in range(nof_payload_bits)], np.uint8),
                nof_enc_bits, qm)
            for m in range(1 << nof_payload_bits)
        ])
        weights = np.array([1 << (nof_payload_bits - 1 - i)
                            for i in range(nof_payload_bits)], np.int32)

        def enc(bits):
            idx = jnp.sum(bits.astype(jnp.int32) * jnp.asarray(weights), -1)
            return jnp.take(jnp.asarray(table), idx, axis=0)

        return enc
    if nof_payload_bits <= 11:
        basis = short_block.BASIS[:nof_payload_bits].astype(np.int32)
        tile_idx = (np.arange(nof_enc_bits) % 32).astype(np.int32)

        def enc(bits):
            rm32 = jnp.matmul(bits.astype(jnp.int32), jnp.asarray(basis)) % 2
            return jnp.take(rm32, jnp.asarray(tile_idx), axis=-1).astype(jnp.uint8)

        return enc

    # K >= 12: CRC6/11 + polar (n_max=10, ibil) with optional 2-CB split —
    # every stage (CRC matmul, allocation scatter, butterfly XOR encode,
    # rate-match gather) is a static-shape device op, so long UCI payloads
    # ride the SAME jitted UE-emulator slot program as the SCH
    # (TS 38.212 Section 6.3.2).
    from ..ops import uci as uci_mod
    from ..ops.crc import crc_device
    from ..ops.polar import PolarCode, polar_encode, polar_allocate
    from ..ops.polar import rate_matching as polar_rm

    k = nof_payload_bits
    e = nof_enc_bits
    c = uci_mod.nof_uci_codeblocks(k, e)
    crc_name = "CRC11" if uci_mod.uci_crc_size(k) == 11 else "CRC6"
    k0 = k // c
    filler = k % c if c > 1 else 0
    starts = [0, k0]
    sizes = [k0, -(-k // c)] if c == 2 else [k]

    def enc(bits):
        outs = []
        for j in range(c):
            cb = bits[:, starts[j]:starts[j] + sizes[j]]
            if j == 0 and filler:
                cb = jnp.concatenate(
                    [jnp.zeros((bits.shape[0], filler), bits.dtype), cb], -1)
            payload = jnp.concatenate(
                [cb, crc_device(cb, crc_name)], axis=-1)
            code = PolarCode(K=payload.shape[-1], E=e // c, n_max=10,
                             ibil=True)
            u = polar_allocate(payload, code)
            x = polar_encode(u, code.n)
            outs.append(polar_rm.rate_match(x, code).astype(jnp.uint8))
        return jnp.concatenate(outs, axis=-1)

    return enc


def build_ulsch_tx_slot(cfg: PuschRxConfig, nof_csi_part2_bits: int | None = None):
    """Returns a jitted fn: (tb_bits (B, TBS), ack/csi1/csi2 bits) ->
    (grid_pair (B[, L], 14, nsubc, 2), samples_pair)."""
    qm = bits_per_symbol(cfg.modulation)
    plan, info = cfg.demux_plan(nof_csi_part2_bits)
    csi2_payload = (cfg.nof_csi_part2_bits
                    if nof_csi_part2_bits is None else nof_csi_part2_bits)
    sch_codeword_tx = build_sch_codeword_tx(cfg, info.nof_ul_sch_bits)
    scr_bits = prg_mod.gold_sequence_bits(cfg.scrambling_cinit(), cfg.nof_codeword_bits)
    mask_eff, force_one = scramble_codeword_with_placeholders(None, scr_bits, plan)

    encoders = {}
    for name, payload in (("csi1", cfg.nof_csi_part1_bits), ("csi2", csi2_payload),
                          ("ack", cfg.nof_harq_ack_bits)):
        if payload:
            encoders[name] = _uci_field_encoder(
                payload, len(plan.field_bit_idx(name)), qm)

    def _prb_start(sym_abs: int) -> int:
        # Intra-slot frequency hopping: the DM-RS Gold sequence is CRB-indexed,
        # so second-hop symbols draw it from the hop's PRB offset.
        if cfg.hop_symbol is not None and sym_abs >= cfg.hop_symbol:
            return cfg.second_hop_prb
        return cfg.rb_start

    if getattr(cfg, "dmrs_config_type", 1) == 2:
        from ..ops.dmrs import dmrs_type2_sequence, dmrs_type2_subcarriers

        ref = np.stack([
            dmrs_type2_sequence(cfg.slot, cfg.start_symbol + s, cfg.n_id,
                                cfg.nof_rb, prb_start=cfg.rb_start)
            for s in cfg.dmrs_symbols
        ])
        pil_subc = dmrs_type2_subcarriers(cfg.nof_rb)
        comb_delta = 2
    else:
        ref = np.stack([
            dmrs_type1_sequence(cfg.slot, cfg.start_symbol + s, cfg.n_id, cfg.nof_rb,
                                prb_start=_prb_start(cfg.start_symbol + s))
            for s in cfg.dmrs_symbols
        ])
        pil_subc = (2 * np.arange(6 * cfg.nof_rb)).astype(np.int32)
        comb_delta = 1
    data_syms = np.asarray(cfg.data_symbols, dtype=np.int32)
    dmrs_syms = np.asarray(cfg.dmrs_symbols, dtype=np.int32)

    nlayers = cfg.nof_layers
    # Type-1 CDM: fd-OCC (+,+)/(+,-) over adjacent pilot pairs within each
    # CDM group; layers {0,1} on group 0 (even subcarriers, delta=0), layers
    # {2,3} on group 1 (odd subcarriers, delta=1) — TS 38.211 Table
    # 6.4.1.1.3-1 ports 0-3 (reference: dmrs_pusch_estimator_impl.cpp:43-53).
    occ = np.ones((nlayers, ref.shape[-1]), np.float32)
    for l in range(1, nlayers, 2):
        occ[l, 1::2] = -1.0
    layer_pil_subc = np.stack(
        [pil_subc + (l // 2) * comb_delta for l in range(nlayers)])

    @jax.jit
    def tx(tb_bits, ack_bits=None, csi1_bits=None, csi2_bits=None):
        b = tb_bits.shape[0]
        cw = jnp.zeros((b, cfg.nof_codeword_bits), jnp.uint8)
        cw = cw.at[:, jnp.asarray(plan.sch_bit_idx)].set(sch_codeword_tx(tb_bits))
        # ACK scattered last: <=2-bit ACK punctures SCH/CSI2 positions.
        for name, bits in (("csi1", csi1_bits), ("csi2", csi2_bits), ("ack", ack_bits)):
            if name in encoders:
                assert bits is not None, f"{name} payload bits required"
                cw = cw.at[:, jnp.asarray(plan.field_bit_idx(name))].set(
                    encoders[name](bits))
        tx_bits = jnp.where(jnp.asarray(force_one), jnp.uint8(1),
                            cw ^ jnp.asarray(mask_eff)[None, :])
        syms = modulate(tx_bits, cfg.modulation)
        if nlayers == 1:
            layer_syms = syms[:, None, :]
        else:
            from ..ops.precoding import layer_map

            layer_syms = layer_map(syms, nlayers)  # (B, L, G/L)
        data_grid = layer_syms.reshape(b, nlayers, len(cfg.data_symbols), cfg.nof_subc)

        grid = jnp.zeros((b, nlayers, cfg.nof_ofdm_symbols, cfg.nof_subc), jnp.complex64)
        grid = grid.at[:, :, data_syms, :].set(data_grid)
        pil = jnp.zeros((nlayers, len(cfg.dmrs_symbols), cfg.nof_subc), jnp.complex64)
        for l in range(nlayers):
            # Scalar + slice + array indexing moves the advanced axis first:
            # the indexed view is (npil, ndmrs), hence the transpose.
            pil = pil.at[l, :, jnp.asarray(layer_pil_subc[l])].set(
                (jnp.asarray(ref) * jnp.asarray(occ[l])[None, :]).T)
        grid = grid.at[:, :, dmrs_syms, :].set(
            jnp.broadcast_to(pil[None], (b,) + pil.shape)
        )

        grid_pair = jnp.stack([jnp.real(grid), jnp.imag(grid)], -1).astype(jnp.float32)
        samples = ofdm_mod.ofdm_modulate(
            grid_pair, cfg.dft_size, cfg.numerology, cfg.slot % (1 << cfg.numerology)
        )
        if nlayers == 1:
            return grid_pair[:, 0], samples[:, 0]
        return grid_pair, samples

    return tx


@functools.lru_cache(maxsize=None)
def cached_ulsch_tx(cfg: PuschRxConfig):
    return build_ulsch_tx_slot(cfg)
