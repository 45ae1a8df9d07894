"""Device-side DL slot assembly: precoding, interleaved PDCCH, CSI-RS, SRS."""

import numpy as np
import pytest

import jax.numpy as jnp

from srsran_projectvtlmo_tpu.fapi.pdus import (
    DlTtiRequest, UlTtiRequest, TxDataRequest, PdschPdu, PdcchPdu, CsiRsPdu,
    SrsPdu, SrsIndication,
)
from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig, UpperPhy
from srsran_projectvtlmo_tpu.ran.modulation import Modulation

# Oracle tests below compare assembled REs against float32 numpy oracles at
# 1e-6-scale tolerances: pin float32 grid storage (the default bf16 storage
# path is covered by tests/test_bf16_grid.py::test_dl_bf16_grid_parity).
CELL4 = CellConfig(nof_rb=52, dft_size=1024, numerology=1, phys_cell_id=1,
                   nof_tx_ports=4, nof_rx_ports=4, grid_bf16=False)


class TestPrecodedPdsch:
    @pytest.mark.slow
    def test_4port_2layer_precoding_matches_oracle(self):
        """The device gather-plan grid equals a numpy per-RE oracle."""
        phy = UpperPhy(CELL4)
        w = np.array([[0.5 + 0.1j, 0.2 - 0.3j],
                      [0.1 - 0.5j, 0.4 + 0.2j],
                      [-0.3 + 0.2j, 0.1 + 0.1j],
                      [0.2 + 0.4j, -0.2 + 0.3j]], np.complex64)
        prec = tuple(tuple((float(c.real), float(c.imag)) for c in row) for row in w)
        pdu = PdschPdu(rnti=0x44, rb_start=4, rb_size=16, modulation=Modulation.QAM16,
                       target_code_rate=0.5, nof_layers=2, start_symbol=1,
                       nof_symbols=12, dmrs_symbols=(3,), n_id=7, precoding=prec)
        from srsran_projectvtlmo_tpu.phy.dl_slot import get_dl_slot_program
        program = get_dl_slot_program(DlTtiRequest(slot=2, pdsch=(pdu,)), CELL4)
        cfg = program.pdsch_cfgs[0]
        rng = np.random.default_rng(0)
        tb = rng.integers(0, 2, cfg.tbs).astype(np.uint8)
        grid, _ = phy.process_dl_slot(
            DlTtiRequest(slot=2, pdsch=(pdu,)), TxDataRequest(slot=2, tb_bits=[tb]))
        assert grid.shape == (4, 14, CELL4.nof_subc)

        # Oracle: layer symbols from the sch chain, precoded per RE in numpy.
        # program.pdsch_cfgs are shape-normalized (rnti/n_id/rv are runtime
        # values); restore the PDU's values for the oracle chain.
        import dataclasses
        from srsran_projectvtlmo_tpu.models.sch_tx import build_sch_symbols_tx
        from srsran_projectvtlmo_tpu.ops.dmrs import dmrs_type1_sequence
        cfg_val = dataclasses.replace(cfg, rnti=pdu.rnti, n_id=pdu.n_id,
                                      rv=pdu.rv)
        syms = np.asarray(build_sch_symbols_tx(cfg_val)(jnp.asarray(tb[None])))[0]
        layers = syms.reshape(-1, 2).T  # (L, M)
        ports = w @ layers  # (P, M)
        k0 = pdu.rb_start * 12
        oracle = np.zeros((4, 14, CELL4.nof_subc), np.complex64)
        m = 0
        for s in range(pdu.nof_symbols):
            sym = pdu.start_symbol + s
            if sym in pdu.dmrs_symbols:
                continue
            oracle[:, sym, k0:k0 + cfg.nof_subc] = ports[:, m:m + cfg.nof_subc]
            m += cfg.nof_subc
        # DM-RS: layers 0/1 on CDM group 0 (even subc) with fd-OCC.
        ref = dmrs_type1_sequence(2, 3, 7, 16, prb_start=4)
        occ0 = np.ones(len(ref), np.complex64)
        occ1 = np.ones(len(ref), np.complex64)
        occ1[1::2] = -1
        pil_ports = np.einsum("pl,ln->pn", w,
                              np.stack([ref * occ0, ref * occ1]))
        oracle[:, 3, k0 + 0:k0 + cfg.nof_subc:2] = pil_ports
        np.testing.assert_allclose(grid, oracle, atol=2e-5)

    def test_1port_4layer_rejected_shape(self):
        """Precoding shape mismatch raises."""
        w_bad = ((1.0, 0.0),)  # wrong structure
        pdu = PdschPdu(rnti=1, rb_start=0, rb_size=4, modulation=Modulation.QPSK,
                       target_code_rate=0.3, nof_layers=2, start_symbol=0,
                       nof_symbols=14, dmrs_symbols=(2,), precoding=(w_bad,))
        phy = UpperPhy(CELL4)
        with pytest.raises(AssertionError):
            phy.process_dl_slot(DlTtiRequest(slot=0, pdsch=(pdu,)), None)


class TestInterleavedPdcch:
    def test_interleaved_mapping_formula(self):
        """Interleaved CCE-to-REG matches the TS 38.211 formula by hand."""
        from srsran_projectvtlmo_tpu.ran.pdcch_mapping import cce_to_reg_interleaved
        # N_rb=48, 1 symbol, L=6, R=2, shift=0: N_reg=48, C=4.
        regs = cce_to_reg_interleaved(48, 1, 6, 2, 0, 1, 0)
        # CCE 0 -> bundle x=0: r=0, c=0 -> f = 0 -> REGs 0..5.
        assert regs == [0, 1, 2, 3, 4, 5]
        regs = cce_to_reg_interleaved(48, 1, 6, 2, 0, 1, 1)
        # CCE 1 -> bundle x=1: r=1, c=0 -> f = 1*4+0 = 4 -> REGs 24..29.
        assert regs == [24, 25, 26, 27, 28, 29]
        # Shift moves the destination cyclically.
        regs = cce_to_reg_interleaved(48, 1, 6, 2, 3, 1, 1)
        assert regs == [42, 43, 44, 45, 46, 47]

    def test_interleaved_pdcch_decodes(self):
        """A candidate mapped interleaved decodes from its own grid REs."""
        phy = UpperPhy(CELL4)
        pdu = PdcchPdu(rnti=0x77, nof_dci_bits=32, aggregation_level=2,
                       cce_index=1, start_symbol=0, n_id=1, n_rnti=0x77,
                       coreset_rb_start=0, coreset_nof_rb=48,
                       interleaved=True, reg_bundle_size=6, interleaver_size=2,
                       shift_index=5)
        rng = np.random.default_rng(1)
        payload = rng.integers(0, 2, 32).astype(np.uint8)
        object.__setattr__(pdu, "payload", tuple(payload))  # test hook
        # frozen dataclass: use a dict carrying payload via attribute
        req = DlTtiRequest(slot=1, pdcch=(pdu,))
        grid, _ = phy.process_dl_slot(req, None)
        g0 = grid[0] if grid.ndim == 3 else grid

        from srsran_projectvtlmo_tpu.phy.dl_slot import _pdcch_plan
        prbs, data_idx, dmrs_idx = _pdcch_plan(pdu, CELL4)
        # Interleaving scatters the bundles: NOT the contiguous non-interleaved
        # PRB set [6*cce, 6*(cce+al)).
        assert sorted(prbs) != list(range(6 * pdu.cce_index,
                                          6 * (pdu.cce_index + pdu.aggregation_level)))
        re = g0.reshape(-1)[data_idx]
        assert np.abs(re).min() > 0.1  # all data REs populated
        # Blind-decode the candidate from the extracted REs (clean channel).
        from srsran_projectvtlmo_tpu.phy import pdcch as pdcch_mod
        cand = pdcch_mod.PdcchCandidateConfig(
            nof_dci_bits=32, aggregation_level=2, rnti=0x77, n_id=1, n_rnti=0x77)
        pair = np.stack([re.real, re.imag], -1).astype(np.float32)[None]
        nv = np.full((1, len(re)), 0.01, np.float32)
        bits, ok = pdcch_mod.pdcch_blind_decode(jnp.asarray(pair), jnp.asarray(nv), cand)
        assert bool(np.asarray(ok)[0])
        np.testing.assert_array_equal(np.asarray(bits)[0], payload)


class TestCsiRs:
    def test_csi_rs_mapped_into_grid(self):
        phy = UpperPhy(CELL4)
        pdu = CsiRsPdu(nof_rb=52, prb_start=0, symbol=5, subcarrier_offset=3,
                       scrambling_id=41)
        grid, _ = phy.process_dl_slot(DlTtiRequest(slot=6, csi_rs=(pdu,)), None)
        g0 = grid[0] if grid.ndim == 3 else grid
        from srsran_projectvtlmo_tpu.ops.csi_rs import CsiRsConfig, csi_rs_sequence
        seq = csi_rs_sequence(CsiRsConfig(nof_rb=52, prb_start=0, symbol=5,
                                          subcarrier_offset=3, scrambling_id=41,
                                          slot=6))
        np.testing.assert_allclose(g0[5, 3::12], seq, atol=1e-6)
        # Nothing else on that symbol.
        mask = np.ones(CELL4.nof_subc, bool)
        mask[3::12] = False
        assert np.abs(g0[5, mask]).max() == 0


class TestSrsEndToEnd:
    def test_srs_pdu_roundtrip(self):
        """An SRS occasion in the UL slot yields a channel/TA indication."""
        from srsran_projectvtlmo_tpu.ops import srs as srs_mod
        from srsran_projectvtlmo_tpu.ops import ofdm
        from srsran_projectvtlmo_tpu.utils.cplx import np_to_pair

        cell = CellConfig(nof_rb=24, dft_size=512, numerology=1, nof_rx_ports=2)
        phy = UpperPhy(cell)
        pdu = SrsPdu(rnti=0x31, nof_rb=24, comb_size=2, comb_offset=0,
                     start_symbol=13, nof_symbols=1, sequence_id=17,
                     cyclic_shift=0)
        scfg = srs_mod.SrsConfig(nof_rb=24, comb_size=2, comb_offset=0,
                                 start_symbol=13, nof_symbols=1,
                                 sequence_id=17, cyclic_shift=0)
        seq = srs_mod.srs_sequence(scfg)
        sub = srs_mod.srs_subcarriers(scfg)
        carrier = np.zeros((2, 14, cell.nof_subc), np.complex64)
        h = np.array([0.8 - 0.3j, -0.2 + 0.9j], np.complex64)
        rng = np.random.default_rng(0)
        for p in range(2):
            carrier[p, 13, sub] = h[p] * seq
        carrier += 0.005 * (rng.normal(size=carrier.shape)
                            + 1j * rng.normal(size=carrier.shape))
        samples = np.asarray(ofdm.ofdm_modulate(
            jnp.asarray(np_to_pair(carrier)), cell.dft_size, 1, 0))
        inds = phy.process_ul_slot(
            UlTtiRequest(slot=0, srs=(pdu,)), samples)
        srs_inds = [i for i in inds if isinstance(i, SrsIndication)]
        assert len(srs_inds) == 1
        ind = srs_inds[0]
        assert ind.rnti == 0x31
        assert ind.channel.shape[0] == 2
        # Wideband estimate close to the injected flat channel.
        est = ind.channel.mean(axis=-1)
        np.testing.assert_allclose(est, h, atol=0.05)
        assert abs(ind.time_alignment_s) < 2e-7


class TestDlDynamicValues:
    """Per-UE values (rnti/n_id/rv/precoding) are runtime inputs: a changing
    UE set never recompiles the DL slot program (reference analog: per-slot PDU churn is the normal case,
    lib/fapi_adaptor/phy/fapi_to_phy_translator.cpp:290-351)."""

    def _pdu(self, rnti, rv=0, prec=None):
        return PdschPdu(rnti=rnti, rb_start=0, rb_size=8,
                        modulation=Modulation.QPSK, target_code_rate=0.4,
                        nof_layers=1, start_symbol=1, nof_symbols=12,
                        dmrs_symbols=(3,), n_id=3, rv=rv, precoding=prec)

    def test_changing_ue_set_compiles_once(self):
        from srsran_projectvtlmo_tpu.phy.dl_slot import get_dl_slot_program

        cell = CellConfig(nof_rb=24, dft_size=512, numerology=1,
                          nof_tx_ports=1, nof_rx_ports=1)
        phy = UpperPhy(cell)
        rng = np.random.default_rng(1)

        programs = set()
        grids = []
        for slot, (rnti, rv) in enumerate([(0x10, 0), (0x22, 0), (0x10, 2),
                                           (0x31, 0), (0x44, 3)]):
            pdu = self._pdu(rnti, rv)
            req = DlTtiRequest(slot=0, pdsch=(pdu,))
            program = get_dl_slot_program(req, cell)
            programs.add(id(program))
            cfg = program.pdsch_cfgs[0]
            tb = rng.integers(0, 2, cfg.tbs).astype(np.uint8)
            grid, _ = phy.process_dl_slot(req, TxDataRequest(slot=0, tb_bits=[tb]))
            grids.append(grid)
        # ONE program object for all five UE/rv combinations, and the jit
        # cache underneath compiled exactly once.
        assert len(programs) == 1
        program = get_dl_slot_program(
            DlTtiRequest(slot=0, pdsch=(self._pdu(0x99, 1),)), cell)
        assert program._compiled._cache_size() == 1
        # Different rnti/rv genuinely change the transmitted grid.
        assert not np.allclose(grids[0], grids[1])
        assert not np.allclose(grids[0], grids[2])

    def test_rv_values_decode_against_oracle(self):
        """rv as a runtime input is not just cached - it selects the right
        circular-buffer window (grid equals the static-rv oracle chain)."""
        import dataclasses
        from srsran_projectvtlmo_tpu.phy.dl_slot import get_dl_slot_program
        from srsran_projectvtlmo_tpu.models.sch_tx import build_sch_symbols_tx

        cell = CellConfig(nof_rb=24, dft_size=512, numerology=1,
                          nof_tx_ports=1, nof_rx_ports=1, grid_bf16=False)
        phy = UpperPhy(cell)
        rng = np.random.default_rng(2)
        for rv in (0, 2):
            pdu = self._pdu(0x77, rv)
            req = DlTtiRequest(slot=0, pdsch=(pdu,))
            program = get_dl_slot_program(req, cell)
            cfg = program.pdsch_cfgs[0]
            tb = rng.integers(0, 2, cfg.tbs).astype(np.uint8)
            grid, _ = phy.process_dl_slot(req, TxDataRequest(slot=0, tb_bits=[tb]))
            cfg_val = dataclasses.replace(cfg, rnti=pdu.rnti, n_id=pdu.n_id,
                                          rv=rv)
            syms = np.asarray(build_sch_symbols_tx(cfg_val)(
                jnp.asarray(tb[None])))[0]
            k0 = pdu.rb_start * 12
            m = 0
            for s in range(pdu.nof_symbols):
                sym = pdu.start_symbol + s
                if sym in pdu.dmrs_symbols:
                    continue
                np.testing.assert_allclose(
                    grid[sym, k0:k0 + cfg.nof_subc],
                    syms[m:m + cfg.nof_subc], atol=2e-5)
                m += cfg.nof_subc


class TestMultiPortControlChannels:
    """Precoded PDCCH/SSB beyond port 0 and the full CSI-RS row table
    (reference: resource_grid_mapper_impl.cpp,
    nzp_csi_rs_generator_impl.cpp:89-198)."""

    def test_4port_all_channels_grid_parity(self):
        from srsran_projectvtlmo_tpu.fapi.pdus import SsbPdu
        from srsran_projectvtlmo_tpu.ops.csi_rs import (
            CsiRsConfig, csi_rs_pattern)
        from srsran_projectvtlmo_tpu.phy import pdcch as pdcch_mod
        from srsran_projectvtlmo_tpu.phy import pbch as pbch_mod
        from srsran_projectvtlmo_tpu.phy.dl_slot import _pdcch_plan

        phy = UpperPhy(CELL4)
        rng = np.random.default_rng(5)
        wv = (rng.normal(size=4) + 1j * rng.normal(size=4)).astype(np.complex64) / 2
        prec_v = tuple((float(c.real), float(c.imag)) for c in wv)
        wv_ssb = (rng.normal(size=4) + 1j * rng.normal(size=4)).astype(np.complex64) / 2
        prec_ssb = tuple((float(c.real), float(c.imag)) for c in wv_ssb)

        # PDCCH at symbol 4: clear of the SSB block (symbols 0-3).
        pdcch = PdcchPdu(rnti=0x55, nof_dci_bits=24, aggregation_level=2,
                         cce_index=0, start_symbol=4, n_id=3, n_rnti=0x55,
                         coreset_nof_rb=48, precoding=prec_v)
        ssb = SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=0,
                     half_radio_frame=False, precoding=prec_ssb)
        # Row 4: 4 ports, fd-CDM2, density one.
        csi = CsiRsPdu(nof_rb=52, prb_start=0, symbol=9, row=4, k_ref=(2,),
                       density="one", scrambling_id=7)
        req = DlTtiRequest(slot=3, pdcch=(pdcch,), ssb=(ssb,), csi_rs=(csi,))
        grid, _ = phy.process_dl_slot(req, None)
        assert grid.shape == (4, 14, CELL4.nof_subc)

        # PDCCH: every port carries w_p * (candidate symbols) at its REs.
        prbs, data_idx, dmrs_idx = _pdcch_plan(pdcch, CELL4)
        syms = pdcch_mod.pdcch_modulate(
            pdcch_mod.PdcchCandidateConfig(
                nof_dci_bits=24, aggregation_level=2, rnti=0x55, n_id=3,
                n_rnti=0x55),
            np.zeros(24, np.uint8))
        for p in range(4):
            np.testing.assert_allclose(
                grid[p].reshape(-1)[data_idx], wv[p] * syms, atol=2e-6)

        # SSB block scaled by its own port vector on symbols 0-3.
        msg = pbch_mod.PbchMessage(sfn=0, ssb_idx=0, half_radio_frame=False,
                                   n_id=1, l_max=8,
                                   mib_payload=tuple([0] * 24))
        block = pbch_mod.assemble_ssb(msg)  # (4, 240)
        k0 = CELL4.ssb_subc_offset
        for p in range(4):
            np.testing.assert_allclose(
                grid[p, :4, k0:k0 + 240], wv_ssb[p] * block, atol=2e-6)

        # CSI-RS row 4: per-port CDM pattern equals the numpy oracle.
        pat = csi_rs_pattern(CsiRsConfig(
            nof_rb=52, prb_start=0, symbol=9, row=4, k_ref=(2,),
            density="one", scrambling_id=7, slot=3))
        assert len(pat) == 4
        for p, (symbols, subc, vals) in enumerate(pat):
            for si, sym in enumerate(symbols):
                np.testing.assert_allclose(grid[p, int(sym), subc], vals[si],
                                           atol=2e-6)
        # fd-CDM2: ports 0/1 share REs with opposite second-subcarrier signs.
        s0, c0, v0 = pat[0]
        s1, c1, v1 = pat[1]
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_allclose(v0[0][0::2], v1[0][0::2], atol=1e-7)
        np.testing.assert_allclose(v0[0][1::2], -v1[0][1::2], atol=1e-7)

    def test_csi_rs_row_port_counts(self):
        from srsran_projectvtlmo_tpu.ops.csi_rs import (
            CsiRsConfig, ROW_PORTS, csi_rs_pattern)

        for row in range(1, 13):
            cfg = CsiRsConfig(nof_rb=8, row=row, k_ref=(0, 2, 4, 6, 8, 10),
                              density="three" if row == 1 else "one",
                              symbol=4)
            pat = csi_rs_pattern(cfg)
            assert len(pat) == ROW_PORTS[row], row
            # All ports within a CDM group share their RE positions.
            from srsran_projectvtlmo_tpu.ops.csi_rs import ROW_CDM, _CDM_SIZE
            cs = _CDM_SIZE[ROW_CDM[row]]
            for g in range(ROW_PORTS[row] // cs):
                base = pat[g * cs]
                for j in range(1, cs):
                    np.testing.assert_array_equal(base[1], pat[g * cs + j][1])
                    np.testing.assert_array_equal(base[0], pat[g * cs + j][0])

    def test_csi_rs_density_dot5(self):
        from srsran_projectvtlmo_tpu.ops.csi_rs import (
            CsiRsConfig, csi_rs_pattern)

        pat = csi_rs_pattern(CsiRsConfig(nof_rb=10, prb_start=3, row=2,
                                         density="dot5_even",
                                         subcarrier_offset=5, symbol=6))
        _, subc, vals = pat[0]
        # Only even PRBs in [3, 13): 4, 6, 8, 10, 12.
        np.testing.assert_array_equal(subc // 12, [4, 6, 8, 10, 12])
        assert vals.shape == (1, 5)


class TestPdschReservedRe:
    """PDSCH rate matching around reserved RE patterns (CSI-RS, CORESET)
    (reference: pdsch_processor_impl.cpp:77-96 compute_nof_data_re,
    re_pattern.h)."""

    def test_inclusion_count_matches_bruteforce(self):
        from srsran_projectvtlmo_tpu.ran.re_pattern import (
            RePattern, inclusion_count, reserved_mask_window)

        rng = np.random.default_rng(3)
        pats = (
            RePattern(rb_begin=2, rb_end=20, re_mask=tuple(
                bool(b) for b in rng.integers(0, 2, 12)), symbols=(3, 7)),
            RePattern(rb_begin=10, rb_end=30, rb_stride=2, re_mask=tuple(
                bool(b) for b in rng.integers(0, 2, 12)), symbols=(7, 9)),
        )
        rb_start, nof_rb, syms = 4, 18, [2, 3, 7, 9, 11]
        # Brute force: enumerate every RE.
        count = 0
        for si, sym in enumerate(syms):
            for prb in range(rb_start, rb_start + nof_rb):
                for k in range(12):
                    hit = any(
                        sym in p.symbols and p.re_mask[k]
                        and p.rb_begin <= prb < p.rb_end
                        and (prb - p.rb_begin) % p.rb_stride == 0
                        for p in pats)
                    count += hit
        assert inclusion_count(pats, rb_start, nof_rb, syms) == count
        assert reserved_mask_window(pats, rb_start, nof_rb, syms).sum() == count

    def test_csi_rs_inside_pdsch_loopback_decode(self):
        """A slot where CSI-RS overlaps the PDSCH allocation: the PDSCH
        rate-matches around the CSI-RS REs, the CSI-RS pilots land intact,
        and the data round-trips through a PUSCH-style decode of exactly the
        free REs."""
        from srsran_projectvtlmo_tpu.ran.re_pattern import (
            csi_rs_patterns, reserved_mask_window)
        from srsran_projectvtlmo_tpu.ops.csi_rs import (
            CsiRsConfig, csi_rs_pattern)
        from srsran_projectvtlmo_tpu.phy.dl_slot import (
            get_dl_slot_program, _pdsch_cfg)

        cell = CellConfig(nof_rb=52, dft_size=1024, numerology=1,
                          phys_cell_id=1, grid_bf16=False)
        phy = UpperPhy(cell)
        slot = 3
        csi_cfg = CsiRsConfig(nof_rb=24, prb_start=4, row=1, k_ref=(1,),
                              symbol=5, density="three", scrambling_id=9,
                              slot=slot)
        reserved = csi_rs_patterns(csi_cfg)
        csi_pdu = CsiRsPdu(nof_rb=24, prb_start=4, row=1, k_ref=(1,),
                           symbol=5, density="three", scrambling_id=9)
        pdsch = PdschPdu(rnti=0x77, rb_start=4, rb_size=24,
                         modulation=Modulation.QAM16, target_code_rate=0.5,
                         start_symbol=2, nof_symbols=12, dmrs_symbols=(3,),
                         n_id=5, reserved=reserved)
        req = DlTtiRequest(slot=slot, pdsch=(pdsch,), csi_rs=(csi_pdu,))
        program = get_dl_slot_program(req, cell)
        cfg = program.pdsch_cfgs[0]
        # E shrank by exactly the reserved REs inside the allocation.
        base_re = cfg.nof_subc * len(cfg.data_symbols)
        assert cfg.nof_data_re < base_re
        rng = np.random.default_rng(7)
        tb = rng.integers(0, 2, cfg.tbs).astype(np.uint8)
        grid, _ = phy.process_dl_slot(req, TxDataRequest(slot=slot,
                                                         tb_bits=[tb]))
        # CSI-RS pilots intact at the reserved positions.
        symbols, subc, vals = csi_rs_pattern(csi_cfg)[0]
        np.testing.assert_allclose(grid[int(symbols[0]), subc], vals[0],
                                   atol=1e-6)
        # PUSCH-style decode of exactly the free REs.
        _assert_pdsch_decodes(grid, pdsch, cfg, tb)

    def test_coreset_reservation_with_pdcch(self):
        """PDSCH spanning the CORESET symbols rate-matches around the whole
        reserved RBs; the PDCCH candidate there is untouched by PDSCH data."""
        from srsran_projectvtlmo_tpu.ran.re_pattern import coreset_pattern
        from srsran_projectvtlmo_tpu.phy.dl_slot import (
            get_dl_slot_program, _pdsch_cfg)

        cell = CellConfig(nof_rb=52, dft_size=1024, numerology=1,
                          phys_cell_id=1, coreset_rb_start=0)
        phy = UpperPhy(cell)
        slot = 2
        reserved = (coreset_pattern(rb_begin=0, rb_end=24, start_symbol=0,
                                    duration=2),)
        pdsch = PdschPdu(rnti=0x31, rb_start=0, rb_size=30,
                         modulation=Modulation.QPSK, target_code_rate=0.4,
                         start_symbol=0, nof_symbols=14, dmrs_symbols=(2,),
                         n_id=3, reserved=reserved)
        pdcch = PdcchPdu(rnti=0x31, nof_dci_bits=40, aggregation_level=4,
                         cce_index=0, start_symbol=0, duration=2,
                         coreset_rb_start=0, coreset_nof_rb=24, n_id=1,
                         n_rnti=0x31)
        req = DlTtiRequest(slot=slot, pdsch=(pdsch,), pdcch=(pdcch,))
        program = get_dl_slot_program(req, cell)
        cfg = program.pdsch_cfgs[0]
        # 24 RBs x 12 REs x 2 symbols rate-matched around.
        assert cfg.nof_subc * len(cfg.data_symbols) - cfg.nof_data_re \
            == 24 * 12 * 2
        rng = np.random.default_rng(9)
        tb = rng.integers(0, 2, cfg.tbs).astype(np.uint8)
        grid, _ = phy.process_dl_slot(req, TxDataRequest(slot=slot,
                                                         tb_bits=[tb]))
        # The non-reserved remainder of the CORESET symbols carries data.
        assert np.abs(grid[0, 24 * 12:30 * 12]).min() > 0.0
        _assert_pdsch_decodes(grid, pdsch, cfg, tb)


def _assert_pdsch_decodes(grid, pdu, cfg, tb):
    """PUSCH-style decode of the free (non-reserved) PDSCH REs: demap ->
    descramble -> rate dematch -> LDPC decode -> bit equality + TB CRC."""
    from srsran_projectvtlmo_tpu.ran.re_pattern import reserved_mask_window
    from srsran_projectvtlmo_tpu.ran.modulation import bits_per_symbol
    from srsran_projectvtlmo_tpu.ops.demodulation import soft_demap
    from srsran_projectvtlmo_tpu.ops import prg as prg_mod
    from srsran_projectvtlmo_tpu.ops.ldpc import rate_matching as rm
    from srsran_projectvtlmo_tpu.ops.ldpc.decode import ldpc_decode
    from srsran_projectvtlmo_tpu.ops.crc import crc_check_device

    abs_data = [pdu.start_symbol + int(s) for s in cfg.data_symbols]
    mask = reserved_mask_window(cfg.reserved, pdu.rb_start, pdu.rb_size,
                                abs_data)
    k0 = pdu.rb_start * 12
    res = []
    for di, sym in enumerate(abs_data):
        row = grid[sym, k0:k0 + cfg.nof_subc]
        res.append(row[~mask[di]])
    syms = np.concatenate(res)
    assert len(syms) == cfg.nof_data_re
    pair = np.stack([syms.real, syms.imag], -1).astype(np.float32)[None]
    nvar = np.full((1, len(syms)), 1e-3, np.float32)
    llr = np.asarray(soft_demap(jnp.asarray(pair), jnp.asarray(nvar),
                                cfg.modulation))
    # Descramble with the PDU's identity (the program cfg is
    # shape-normalized to rnti=0; scrambling rides as a value input).
    cinit = ((pdu.rnti << 15) + pdu.n_id) & 0x7FFFFFFF
    scr = prg_mod.gold_sequence_bits(cinit, cfg.nof_codeword_bits)
    llr = np.clip(llr.astype(np.int32) * (1 - 2 * scr.astype(np.int32))[None],
                  -127, 127).astype(np.int8)
    seg = cfg.segmentation
    es = cfg.cb_rate_match_sizes()
    qm = bits_per_symbol(cfg.modulation)
    offs = np.concatenate([[0], np.cumsum(es)]).astype(int)
    softs = []
    for j in range(seg.nof_cb):
        softs.append(np.asarray(rm.rate_dematch(
            jnp.asarray(llr[:, offs[j]:offs[j + 1]])[:, None],
            seg.base_graph, seg.lifting_size, seg.nof_filler_bits_per_cb,
            pdu.rv, es[j], qm))[0, 0])
    hard, _ = ldpc_decode(jnp.asarray(np.stack(softs)), seg.base_graph,
                          seg.lifting_size, nof_iterations=6)
    hard = np.asarray(hard)
    kp = seg.nof_payload_bits_per_cb
    payload = hard[:, :kp - seg.cb_crc_bits] if seg.cb_crc_bits \
        else hard[:, :kp]
    flat = payload.reshape(-1)[:cfg.tbs + seg.tb_crc_bits]
    crc_name = "CRC24A" if seg.tb_crc_bits == 24 else "CRC16"
    assert bool(np.asarray(crc_check_device(jnp.asarray(flat[None]),
                                            crc_name))[0]), "TB CRC failed"
    np.testing.assert_array_equal(flat[:cfg.tbs], tb)
