"""Upper-PHY orchestration tests: DL slot assembly, UL slot processing, HARQ pool."""

import numpy as np
import pytest

import jax.numpy as jnp

from srsran_projectvtlmo_tpu.models.pusch_rx import flatten_tb_bits
from srsran_projectvtlmo_tpu.fapi.pdus import (
    DlTtiRequest, UlTtiRequest, TxDataRequest, SsbPdu, PdcchPdu, PdschPdu,
    PuschPdu, PucchPdu, PrachPdu, UciIndication, CrcIndication, RxDataIndication,
    RachIndication,
)
from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig, UpperPhy
from srsran_projectvtlmo_tpu.phy.harq import RxBufferPool
from srsran_projectvtlmo_tpu.models.pdsch_tx import PdschTxConfig
from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig, cached_pusch_rx_from_grid
from srsran_projectvtlmo_tpu.models.ulsch_tx import build_ulsch_tx_slot
from srsran_projectvtlmo_tpu.ran.modulation import Modulation
from srsran_projectvtlmo_tpu.ops import ofdm
from srsran_projectvtlmo_tpu.utils.cplx import np_to_pair

CELL = CellConfig(nof_rb=52, dft_size=1024, numerology=1, phys_cell_id=101)


class TestDlSlot:
    def test_dl_slot_assembly_and_pdsch_decodable(self):
        phy = UpperPhy(CELL)
        pdsch = PdschPdu(rnti=0x4601, rb_start=20, rb_size=12, modulation=Modulation.QAM16,
                         target_code_rate=0.5, start_symbol=4, nof_symbols=10,
                         dmrs_symbols=(6,), n_id=7)
        cfg = PdschTxConfig(nof_rb=12, modulation=Modulation.QAM16, target_code_rate=0.5,
                            nof_ofdm_symbols=10, dmrs_symbols=(2,), rnti=0x4601, n_id=7,
                            dft_size=CELL.dft_size, numerology=1, slot=3)
        rng = np.random.default_rng(0)
        tb = rng.integers(0, 2, cfg.tbs).astype(np.uint8)
        req = DlTtiRequest(
            slot=3,
            ssb=(SsbPdu(phys_cell_id=101, ssb_block_index=0, sfn=1, half_radio_frame=False),),
            pdcch=(PdcchPdu(rnti=0x4601, nof_dci_bits=40, aggregation_level=2,
                            cce_index=0, start_symbol=1, n_id=101, n_rnti=0x4601),),
            pdsch=(pdsch,),
        )
        grid, samples = phy.process_dl_slot(req, TxDataRequest(slot=3, tb_bits=[tb]))
        assert grid.shape == (14, CELL.nof_subc)
        assert samples.shape == (ofdm.slot_sample_count(CELL.dft_size, 1, 1), 2)

        # SSB occupies symbols 0..3 at the configured offset.
        assert np.abs(grid[0, 56:183]).min() > 0.5

        # The PDSCH allocation decodes through the PUSCH-equivalent Rx chain
        # (same DM-RS + SCH structure) with a clean channel.
        # DM-RS placed at absolute symbol 6 = relative 2.
        rx_cfg = PuschRxConfig(
            nof_rb=12, modulation=Modulation.QAM16, target_code_rate=0.5,
            nof_ofdm_symbols=10, dmrs_symbols=(2,), rnti=0x4601, n_id=7,
            start_symbol=4, rb_start=20,
            nof_rx_ports=1, dft_size=CELL.dft_size, numerology=1, slot=3,
        )
        sub = grid[4:14, 20 * 12:32 * 12]
        pair = np_to_pair(sub)[None, None]
        out = cached_pusch_rx_from_grid(rx_cfg)(jnp.asarray(pair))
        assert bool(np.asarray(out["tb_crc_ok"])[0])
        np.testing.assert_array_equal(
            flatten_tb_bits(np.asarray(out["tb_bits_cb"]), rx_cfg.tbs)[0], tb)

    def test_dmrs_sequence_offset_matches(self):
        """PDSCH DM-RS with prb_start offset must match what a prb-offset
        receiver would regenerate (sequence indexed from CRB0)."""
        phy = UpperPhy(CELL)
        pdu = PdschPdu(rnti=1, rb_start=10, rb_size=4, modulation=Modulation.QPSK,
                       target_code_rate=0.3, start_symbol=0, nof_symbols=14,
                       dmrs_symbols=(2,), n_id=3)
        grid, _ = phy.process_dl_slot(DlTtiRequest(slot=0, pdsch=(pdu,)), None)
        from srsran_projectvtlmo_tpu.ops.dmrs import dmrs_type1_sequence
        ref = dmrs_type1_sequence(0, 2, 3, 4, prb_start=10)
        got = grid[2, 120:168][0::2]
        # bf16 grid storage (CellConfig default): compare at bf16 epsilon.
        np.testing.assert_allclose(got, ref, atol=5e-3)


class TestUlSlot:
    def test_pusch_and_pucch_and_prach(self):
        phy = UpperPhy(CELL)
        # Build a PUSCH waveform occupying rb 8..8+16 of the carrier.
        rx_like = PuschRxConfig(nof_rb=16, modulation=Modulation.QAM16, target_code_rate=0.5,
                                rnti=0x17, n_id=5, rb_start=8, nof_rx_ports=1,
                                dft_size=CELL.dft_size, numerology=1, slot=2,
                                dmrs_symbols=(2,))
        tx = build_ulsch_tx_slot(rx_like)
        rng = np.random.default_rng(1)
        tb = rng.integers(0, 2, rx_like.tbs).astype(np.uint8)
        alloc_grid_pair, _ = tx(jnp.asarray(tb[None]))
        alloc_grid = np.asarray(alloc_grid_pair)[0]
        carrier = np.zeros((14, CELL.nof_subc), np.complex64)
        carrier[:, 8 * 12:24 * 12] = alloc_grid[..., 0] + 1j * alloc_grid[..., 1]

        # PUCCH F0 at PRB 50, symbols 12-13, bits (1, 0).
        from srsran_projectvtlmo_tpu.phy import pucch as pucch_mod
        from srsran_projectvtlmo_tpu.ops.low_papr import low_papr_sequence, pucch_group_sequence
        u, v = pucch_group_sequence(9)
        for s in range(2):
            ncs = pucch_mod._cyclic_shift_hopping(9, 2, 12 + s)
            alpha = 2 * np.pi * ((3 + 9 + ncs) % 12) / 12  # bits (1,0) -> mcs 9
            carrier[12 + s, 50 * 12:51 * 12] = low_papr_sequence(u, v, alpha, 12)

        noise = 0.01 * (rng.normal(size=carrier.shape) + 1j * rng.normal(size=carrier.shape))
        samples = ofdm.ofdm_modulate(jnp.asarray(np_to_pair(carrier + noise)),
                                     CELL.dft_size, 1, 0)
        samples = np.asarray(samples)[None]  # 1 rx port

        # PRACH occasion: preamble 11 with no delay.
        from srsran_projectvtlmo_tpu.ops import prach as prach_mod
        pcfg = prach_mod.PrachDetectorConfig(sequence_length=839, root_sequence_index=0,
                                             zero_correlation_zone=11)
        prach_freq = prach_mod.prach_generate(pcfg, 11)
        prach_pair = np.stack([prach_freq.real, prach_freq.imag], -1).astype(np.float32)

        req = UlTtiRequest(
            slot=2,
            pusch=(PuschPdu(rnti=0x17, rb_start=8, rb_size=16, modulation=Modulation.QAM16,
                            target_code_rate=0.5, n_id=5, dmrs_symbols=(2,)),),
            pucch=(PucchPdu(format=0, rnti=0x99, prb_start=50, nof_prb=1, start_symbol=12,
                            nof_symbols=2, initial_cyclic_shift=3, nof_harq_bits=2, n_id=9),),
            prach=(PrachPdu(root_sequence_index=0, zero_correlation_zone=11),),
        )
        inds = phy.process_ul_slot(req, samples, prach_samples=prach_pair)

        crc = [i for i in inds if isinstance(i, CrcIndication)]
        rxd = [i for i in inds if isinstance(i, RxDataIndication)]
        ucis = [i for i in inds if isinstance(i, UciIndication)]
        rach = [i for i in inds if isinstance(i, RachIndication)]
        assert crc and crc[0].tb_crc_ok
        np.testing.assert_array_equal(rxd[0].tb_bits, tb)
        assert ucis and ucis[0].valid
        np.testing.assert_array_equal(ucis[0].harq_bits, [1, 0])
        assert rach and rach[0].preambles
        assert max(rach[0].preambles, key=lambda d: d[2])[0] == 11


class TestHarqPool:
    def test_reserve_release_expire(self):
        pool = RxBufferPool(nof_buffers=2, max_codeblocks=2, max_cb_size=128, expiry_slots=10)
        a = pool.reserve(0, rnti=1, harq_id=0, nof_cb=2, new_data=True)
        b = pool.reserve(0, rnti=2, harq_id=0, nof_cb=2, new_data=True)
        assert a is not None and b is not None and a != b
        assert pool.reserve(0, rnti=3, harq_id=0, nof_cb=2, new_data=True) is None
        # Same key re-acquires the same buffer.
        assert pool.reserve(1, rnti=1, harq_id=0, nof_cb=2, new_data=False) == a
        pool.release(1, 0)
        assert pool.reserve(2, rnti=3, harq_id=0, nof_cb=2, new_data=True) is not None
        # Expiry frees rnti=2's buffer.
        pool.run_slot(100)
        assert pool.nof_reserved == 0

    def test_soft_combining_gain(self):
        """Two half-strength noisy copies combine to decode where one fails."""
        from srsran_projectvtlmo_tpu.ops.ldpc.encode import ldpc_encode
        from srsran_projectvtlmo_tpu.ops.ldpc.decode import ldpc_decode
        from srsran_projectvtlmo_tpu.ops.ldpc import rate_matching as rm
        from srsran_projectvtlmo_tpu.ran.ldpc_params import BaseGraph

        bg, z = BaseGraph.BG1, 52
        rng = np.random.default_rng(3)
        info = rng.integers(0, 2, (1, 22 * z)).astype(np.uint8)
        cw = np.asarray(ldpc_encode(jnp.asarray(info), bg, z))[:, 2 * z:]
        x = 1 - 2 * cw.astype(np.float64)
        sigma = 1.0
        pool = RxBufferPool(nof_buffers=1, max_codeblocks=1, max_cb_size=66 * z)

        def llr_of(seed):
            y = x + np.random.default_rng(seed).normal(0, sigma, x.shape)
            return np.clip(np.round(3 * y), -120, 120).astype(np.int8)

        idx = pool.reserve(0, rnti=1, harq_id=0, nof_cb=1, new_data=True)
        single_fail = 0
        combined = pool.combined(idx, 1, 66 * z, jnp.asarray(llr_of(10)))
        hard1, _ = ldpc_decode(jnp.asarray(llr_of(10)), bg, z, nof_iterations=8)
        combined = pool.combined(idx, 1, 66 * z, jnp.asarray(llr_of(11)))
        hard2, _ = ldpc_decode(combined, bg, z, nof_iterations=8)
        e1 = (np.asarray(hard1) != info).sum()
        e2 = (np.asarray(hard2) != info).sum()
        assert e2 == 0, f"combined decode failed ({e2} errors)"
        assert e1 > 0, "single transmission unexpectedly decoded (weak test)"


def _embed_pusch(tx_cfg, tb, carrier_subc, dft_size, ack=None, noise_seed=9):
    """TX one PUSCH allocation and return single-port carrier samples."""
    tx = build_ulsch_tx_slot(tx_cfg)
    kw = {"ack_bits": jnp.asarray(ack)} if ack is not None else {}
    alloc_grid_pair, _ = tx(jnp.asarray(tb[None]), **kw)
    alloc_grid = np.asarray(alloc_grid_pair)[0]
    carrier = np.zeros((14, carrier_subc), np.complex64)
    k0 = tx_cfg.rb_start * 12
    carrier[:, k0:k0 + tx_cfg.nof_rb * 12] = (alloc_grid[..., 0]
                                              + 1j * alloc_grid[..., 1])
    rng = np.random.default_rng(noise_seed)
    carrier += 0.005 * (rng.normal(size=carrier.shape)
                        + 1j * rng.normal(size=carrier.shape))
    samples = ofdm.ofdm_modulate(jnp.asarray(np_to_pair(carrier)),
                                 dft_size, 1, 0)
    return np.asarray(samples)[None]


class TestDynamicUciPusch:
    def test_ue_churn_with_ack_compiles_once(self):
        """ACK-on-PUSCH rides the dynamic-params program: a churning UE set
        (rnti/n_id/slot) with 2-bit ACK builds exactly ONE rx program
        (reference analog: per-slot PDU churn,
        fapi_to_phy_translator.cpp:290-351)."""
        phy = UpperPhy(CELL)
        cached_pusch_rx_from_grid.cache_clear()
        rng = np.random.default_rng(3)
        for i, (rnti, n_id, slot) in enumerate(
                [(0x17, 5, 2), (0x23, 7, 4), (0x31, 11, 6)]):
            ack = np.array([[i & 1, 1]], np.uint8)
            tx_cfg = PuschRxConfig(
                nof_rb=16, modulation=Modulation.QAM16, target_code_rate=0.5,
                rnti=rnti, n_id=n_id, rb_start=8, nof_rx_ports=1,
                dft_size=CELL.dft_size, numerology=1, slot=slot,
                dmrs_symbols=(2,), nof_harq_ack_bits=2)
            tb = rng.integers(0, 2, tx_cfg.tbs).astype(np.uint8)
            samples = _embed_pusch(tx_cfg, tb, CELL.nof_subc, CELL.dft_size,
                                   ack=ack)
            req = UlTtiRequest(slot=slot, pusch=(PuschPdu(
                rnti=rnti, rb_start=8, rb_size=16, modulation=Modulation.QAM16,
                target_code_rate=0.5, n_id=n_id, dmrs_symbols=(2,),
                nof_harq_ack_bits=2),))
            inds = phy.process_ul_slot(req, samples)
            crc = [x for x in inds if isinstance(x, CrcIndication)]
            ucis = [x for x in inds if isinstance(x, UciIndication)]
            rxd = [x for x in inds if isinstance(x, RxDataIndication)]
            assert crc[0].tb_crc_ok, f"UE {i} SCH decode failed"
            np.testing.assert_array_equal(rxd[0].tb_bits, tb)
            assert ucis and ucis[0].valid
            np.testing.assert_array_equal(ucis[0].harq_bits, ack[0])
        info = cached_pusch_rx_from_grid.cache_info()
        assert info.misses == 1, f"expected 1 compiled program, got {info}"


class TestExpertPhyPlumbing:
    def test_decoder_choice_reaches_the_pusch_program(self):
        from srsran_projectvtlmo_tpu.phy.upper_phy import ExpertPhyConfig

        pdu = PuschPdu(rnti=0x44, rb_start=0, rb_size=4,
                       modulation=Modulation.QPSK, target_code_rate=0.3,
                       n_id=3, dmrs_symbols=(2,))
        for choice in (None, "xla", "cuda"):
            phy = UpperPhy(CELL, ExpertPhyConfig(ldpc_decoder=choice,
                                                 pusch_decoder_max_iterations=4))
            cfg = phy._pusch_rx_cfg(1, pdu, nof_csi2=0, two_phase=False)
            assert cfg.ldpc_decoder == choice
            assert cfg.nof_ldpc_iterations == 4

    def test_auto_selection_is_platform_dependent(self):
        """The one selection point: XLA on the CPU, and the CUDA kernel
        refused there instead of silently replaced."""
        from srsran_projectvtlmo_tpu.ops.ldpc.select import select_es_decoder
        from srsran_projectvtlmo_tpu.phy.upper_phy import ExpertPhyConfig
        import jax

        assert jax.devices()[0].platform == "cpu"
        assert select_es_decoder(None) == "xla"
        assert select_es_decoder("xla") == "xla"
        with pytest.raises(ValueError, match="needs a GPU"):
            select_es_decoder("cuda")
        rng = np.random.default_rng(5)
        tx_cfg = PuschRxConfig(
            nof_rb=4, modulation=Modulation.QPSK, target_code_rate=0.3,
            rnti=0x44, n_id=3, rb_start=0, nof_rx_ports=1,
            dft_size=CELL.dft_size, numerology=1, slot=1, dmrs_symbols=(2,))
        tb = rng.integers(0, 2, tx_cfg.tbs).astype(np.uint8)
        samples = _embed_pusch(tx_cfg, tb, CELL.nof_subc, CELL.dft_size)
        req = UlTtiRequest(slot=1, pusch=(PuschPdu(
            rnti=0x44, rb_start=0, rb_size=4, modulation=Modulation.QPSK,
            target_code_rate=0.3, n_id=3, dmrs_symbols=(2,)),))
        phy = UpperPhy(CELL, ExpertPhyConfig(ldpc_decoder="cuda"))
        with pytest.raises(ValueError, match="needs a GPU"):
            phy.process_ul_slot(req, samples)


def test_four_layer_pusch_through_upper_phy():
    """The dynamic-params dispatch handles the full 4-layer port set
    (CDM groups 0 and 1) end to end."""
    cell4 = CellConfig(nof_rb=24, dft_size=512, numerology=1,
                       nof_rx_ports=4, phys_cell_id=3)
    phy = UpperPhy(cell4)
    rng = np.random.default_rng(7)
    tx_cfg = PuschRxConfig(
        nof_rb=16, modulation=Modulation.QPSK, target_code_rate=0.3,
        nof_layers=4, nof_rx_ports=4, rnti=0x31, n_id=3, rb_start=4,
        dft_size=cell4.dft_size, numerology=1, slot=3, dmrs_symbols=(2,),
        nof_ldpc_iterations=8)
    tx = build_ulsch_tx_slot(tx_cfg)
    tb = rng.integers(0, 2, tx_cfg.tbs).astype(np.uint8)
    grid_pair, _ = tx(jnp.asarray(tb[None]))
    from srsran_projectvtlmo_tpu.utils.cplx import pair_to_np

    lg = pair_to_np(np.asarray(grid_pair))[0]  # (4, 14, nsubc_alloc)
    mix = (np.eye(4) + 0.1 * np.ones((4, 4))).astype(np.complex64)
    carrier = np.zeros((4, 14, cell4.nof_subc), np.complex64)
    carrier[:, :, 4 * 12:20 * 12] = np.einsum("pl,lsk->psk", mix, lg)
    carrier += 0.002 * (rng.normal(size=carrier.shape)
                        + 1j * rng.normal(size=carrier.shape))
    samples = np.asarray(ofdm.ofdm_modulate(
        jnp.asarray(np_to_pair(carrier)), cell4.dft_size, 1, 1))
    req = UlTtiRequest(slot=3, pusch=(PuschPdu(
        rnti=0x31, rb_start=4, rb_size=16, modulation=Modulation.QPSK,
        target_code_rate=0.3, nof_layers=4, n_id=3, dmrs_symbols=(2,)),))
    inds = phy.process_ul_slot(req, samples, validate=False)
    crc = [x for x in inds if isinstance(x, CrcIndication)][0]
    rxd = [x for x in inds if isinstance(x, RxDataIndication)][0]
    assert crc.tb_crc_ok, "4-layer UpperPhy decode failed"
    np.testing.assert_array_equal(rxd.tb_bits, tb)


def _carrier_fapi_samples(tx_cfg, alloc_grid_pair, slot, second_hop=None,
                          noise=0.004, seed=5):
    """Embed a (14, nsub, 2) TX allocation grid into the CELL carrier
    (hop-aware per-symbol PRB placement) and OFDM-modulate one port."""
    g = alloc_grid_pair[..., 0] + 1j * alloc_grid_pair[..., 1]
    carrier = np.zeros((14, CELL.nof_subc), np.complex64)
    k0 = tx_cfg.rb_start * 12
    w = tx_cfg.nof_rb * 12
    for s in range(14):
        k = k0
        if second_hop is not None and s >= tx_cfg.hop_symbol:
            k = second_hop * 12
        carrier[s, k:k + w] = g[s]
    rng = np.random.default_rng(seed)
    carrier += noise * (rng.normal(size=carrier.shape)
                        + 1j * rng.normal(size=carrier.shape))
    samples = ofdm.ofdm_modulate(jnp.asarray(np_to_pair(carrier)),
                                 CELL.dft_size, 1, slot % 2)
    return np.asarray(samples)[None]


class TestFullFapiPuschSurface:
    """Round-5 FAPI surface: CSI-on-PUSCH (two-phase part1->part2), intra-slot
    frequency hopping and DM-RS type 2 all reachable through PuschPdu
    (reference: pusch_processor_impl.cpp:40-92 csi-part1-feedback,
    fapi_to_phy_translator.cpp:290-351 PDU translation)."""

    def _tx_cfg(self, rnti, n_id, slot, **kw):
        kw.setdefault("dmrs_symbols", (2, 11))
        return PuschRxConfig(
            nof_rb=16, modulation=Modulation.QAM16, target_code_rate=0.5,
            rnti=rnti, n_id=n_id, rb_start=8, nof_rx_ports=1,
            dft_size=CELL.dft_size, numerology=1, slot=slot, **kw)

    def test_csi_two_phase_through_fapi_compiles_once(self):
        """gnb_sim-style loop decodes SCH+ACK+CSI1+CSI2 on one PDU across a
        churning UE set: ONE phase-A program; one phase-B program per
        part2-size bucket actually hit."""
        from srsran_projectvtlmo_tpu.models.pusch_rx import cached_pusch_phase_b

        phy = UpperPhy(CELL)
        cached_pusch_rx_from_grid.cache_clear()
        cached_pusch_phase_b.cache_clear()
        p2map = (4, 6, 8, 10)
        rng = np.random.default_rng(11)
        sizes_seen = set()
        for i, (rnti, n_id, slot, csi1_val) in enumerate(
                [(0x17, 5, 2, 2), (0x23, 7, 4, 2), (0x31, 11, 6, 1)]):
            csi2_size = p2map[csi1_val]
            sizes_seen.add(csi2_size)
            ack = rng.integers(0, 2, (1, 1)).astype(np.uint8)
            csi1 = np.array([[csi1_val >> 1, csi1_val & 1]], np.uint8)
            csi2 = rng.integers(0, 2, (1, csi2_size)).astype(np.uint8)
            tx_cfg = self._tx_cfg(rnti, n_id, slot, nof_harq_ack_bits=1,
                                  nof_csi_part1_bits=2)
            tb = rng.integers(0, 2, tx_cfg.tbs).astype(np.uint8)
            tx = build_ulsch_tx_slot(tx_cfg, nof_csi_part2_bits=csi2_size)
            alloc, _ = tx(jnp.asarray(tb[None]), ack_bits=jnp.asarray(ack),
                          csi1_bits=jnp.asarray(csi1),
                          csi2_bits=jnp.asarray(csi2))
            samples = _carrier_fapi_samples(tx_cfg, np.asarray(alloc)[0], slot)
            req = UlTtiRequest(slot=slot, pusch=(PuschPdu(
                rnti=rnti, rb_start=8, rb_size=16,
                modulation=Modulation.QAM16, target_code_rate=0.5,
                n_id=n_id, dmrs_symbols=(2, 11), nof_harq_ack_bits=1,
                nof_csi_part1_bits=2, part2_size_map=p2map),))
            inds = phy.process_ul_slot(req, samples)
            crc = [x for x in inds if isinstance(x, CrcIndication)][0]
            rxd = [x for x in inds if isinstance(x, RxDataIndication)][0]
            uci = [x for x in inds if isinstance(x, UciIndication)][0]
            assert crc.tb_crc_ok, f"UE {i} SCH decode failed"
            np.testing.assert_array_equal(rxd.tb_bits, tb)
            assert uci.valid
            np.testing.assert_array_equal(uci.harq_bits, ack[0])
            assert uci.csi1_valid
            np.testing.assert_array_equal(uci.csi1_bits, csi1[0])
            assert uci.csi2_valid
            np.testing.assert_array_equal(uci.csi2_bits, csi2[0])
        assert cached_pusch_rx_from_grid.cache_info().misses == 1, \
            cached_pusch_rx_from_grid.cache_info()
        assert cached_pusch_phase_b.cache_info().misses == len(sizes_seen), \
            cached_pusch_phase_b.cache_info()

    def test_constant_part2_map_single_pass(self):
        """A CONSTANT part2 map needs no host decision point: SCH+CSI1+CSI2
        decode in the one fused program (no phase-B program built)."""
        from srsran_projectvtlmo_tpu.models.pusch_rx import cached_pusch_phase_b

        phy = UpperPhy(CELL)
        cached_pusch_rx_from_grid.cache_clear()
        cached_pusch_phase_b.cache_clear()
        rng = np.random.default_rng(13)
        slot, rnti, n_id = 4, 0x51, 3
        csi1 = np.array([[1, 1]], np.uint8)
        csi2 = rng.integers(0, 2, (1, 6)).astype(np.uint8)
        tx_cfg = self._tx_cfg(rnti, n_id, slot, nof_csi_part1_bits=2,
                              nof_csi_part2_bits=6)
        tb = rng.integers(0, 2, tx_cfg.tbs).astype(np.uint8)
        tx = build_ulsch_tx_slot(tx_cfg)
        alloc, _ = tx(jnp.asarray(tb[None]), csi1_bits=jnp.asarray(csi1),
                      csi2_bits=jnp.asarray(csi2))
        samples = _carrier_fapi_samples(tx_cfg, np.asarray(alloc)[0], slot)
        req = UlTtiRequest(slot=slot, pusch=(PuschPdu(
            rnti=rnti, rb_start=8, rb_size=16, modulation=Modulation.QAM16,
            target_code_rate=0.5, n_id=n_id, dmrs_symbols=(2, 11),
            nof_csi_part1_bits=2, part2_size_map=(6, 6, 6, 6)),))
        inds = phy.process_ul_slot(req, samples)
        crc = [x for x in inds if isinstance(x, CrcIndication)][0]
        uci = [x for x in inds if isinstance(x, UciIndication)][0]
        assert crc.tb_crc_ok
        np.testing.assert_array_equal(uci.csi1_bits, csi1[0])
        np.testing.assert_array_equal(uci.csi2_bits, csi2[0])
        assert uci.csi1_valid and uci.csi2_valid
        assert cached_pusch_rx_from_grid.cache_info().misses == 1
        assert cached_pusch_phase_b.cache_info().misses == 0

    def test_hopping_through_fapi_hop_prb_is_a_value(self):
        """Intra-slot frequency hopping through the PDU API; two UEs with
        DIFFERENT second-hop PRBs share one compiled program (the hop PRB is
        normalized out of the compile key)."""
        phy = UpperPhy(CELL)
        cached_pusch_rx_from_grid.cache_clear()
        rng = np.random.default_rng(17)
        for i, (rnti, n_id, slot, hop_prb) in enumerate(
                [(0x61, 2, 2, 30), (0x62, 6, 4, 25)]):
            tx_cfg = self._tx_cfg(rnti, n_id, slot, dmrs_symbols=(2, 9),
                                  hop_symbol=7, second_hop_prb=hop_prb)
            tb = rng.integers(0, 2, tx_cfg.tbs).astype(np.uint8)
            tx = build_ulsch_tx_slot(tx_cfg)
            alloc, _ = tx(jnp.asarray(tb[None]))
            samples = _carrier_fapi_samples(tx_cfg, np.asarray(alloc)[0],
                                            slot, second_hop=hop_prb)
            req = UlTtiRequest(slot=slot, pusch=(PuschPdu(
                rnti=rnti, rb_start=8, rb_size=16,
                modulation=Modulation.QAM16, target_code_rate=0.5,
                n_id=n_id, dmrs_symbols=(2, 9), hop_symbol=7,
                second_hop_prb=hop_prb),))
            inds = phy.process_ul_slot(req, samples)
            crc = [x for x in inds if isinstance(x, CrcIndication)][0]
            rxd = [x for x in inds if isinstance(x, RxDataIndication)][0]
            assert crc.tb_crc_ok, f"hopping UE {i} decode failed"
            np.testing.assert_array_equal(rxd.tb_bits, tb)
        assert cached_pusch_rx_from_grid.cache_info().misses == 1, \
            cached_pusch_rx_from_grid.cache_info()

    def test_dmrs_type2_through_fapi(self):
        phy = UpperPhy(CELL)
        rng = np.random.default_rng(19)
        slot, rnti, n_id = 6, 0x71, 8
        tx_cfg = self._tx_cfg(rnti, n_id, slot, dmrs_config_type=2)
        tb = rng.integers(0, 2, tx_cfg.tbs).astype(np.uint8)
        tx = build_ulsch_tx_slot(tx_cfg)
        alloc, _ = tx(jnp.asarray(tb[None]))
        samples = _carrier_fapi_samples(tx_cfg, np.asarray(alloc)[0], slot)
        req = UlTtiRequest(slot=slot, pusch=(PuschPdu(
            rnti=rnti, rb_start=8, rb_size=16, modulation=Modulation.QAM16,
            target_code_rate=0.5, n_id=n_id, dmrs_symbols=(2, 11),
            dmrs_config_type=2),))
        inds = phy.process_ul_slot(req, samples)
        crc = [x for x in inds if isinstance(x, CrcIndication)][0]
        rxd = [x for x in inds if isinstance(x, RxDataIndication)][0]
        assert crc.tb_crc_ok, "DM-RS type-2 decode through FAPI failed"
        np.testing.assert_array_equal(rxd.tb_bits, tb)

    def test_fapi_validators_cover_new_fields(self):
        from srsran_projectvtlmo_tpu.fapi import validators as v

        def req(**kw):
            return UlTtiRequest(slot=0, pusch=(PuschPdu(
                rnti=0x10, rb_start=0, rb_size=8,
                modulation=Modulation.QAM16, target_code_rate=0.5, **kw),))

        assert v.validate_ul_tti_request(req(
            nof_csi_part1_bits=2, part2_size_map=(0, 4, 6, 8))).ok
        # Map length must be 2**csi1.
        assert not v.validate_ul_tti_request(req(
            nof_csi_part1_bits=2, part2_size_map=(4, 6))).ok
        # Map mode caps csi1 at 11 bits.
        assert not v.validate_ul_tti_request(req(
            nof_csi_part1_bits=12, part2_size_map=tuple([4] * 4096))).ok
        # Hopping needs the second-hop PRB, a hop symbol inside the span
        # and one DM-RS symbol per hop.
        assert not v.validate_ul_tti_request(req(hop_symbol=7)).ok
        assert not v.validate_ul_tti_request(req(
            hop_symbol=14, second_hop_prb=10)).ok
        assert not v.validate_ul_tti_request(req(
            hop_symbol=7, second_hop_prb=10, dmrs_symbols=(2, 3))).ok
        assert v.validate_ul_tti_request(req(
            hop_symbol=7, second_hop_prb=10, dmrs_symbols=(2, 9))).ok
        assert not v.validate_ul_tti_request(req(dmrs_config_type=3)).ok
        assert v.validate_ul_tti_request(req(dmrs_config_type=2)).ok
