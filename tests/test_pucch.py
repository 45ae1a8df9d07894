"""PUCCH format 0/1/2 processor tests (Tx built per TS 38.211, Rx = framework)."""

import numpy as np
import pytest

import jax.numpy as jnp

from srsran_projectvtlmo_tpu.phy import pucch
from srsran_projectvtlmo_tpu.ops.low_papr import low_papr_sequence, pucch_group_sequence
from srsran_projectvtlmo_tpu.ops import prg as prg_mod
from srsran_projectvtlmo_tpu.ops import uci as uci_mod


def cplx_pair(z):
    return np.stack([z.real, z.imag], -1).astype(np.float32)


class TestFormat0:
    @pytest.mark.parametrize("bits", [[0], [1], [0, 0], [0, 1], [1, 0], [1, 1]])
    def test_detects_bits(self, bits):
        cfg = pucch.PucchFormat0Config(
            n_id=17, slot=3, start_symbol=12, nof_symbols=2,
            initial_cyclic_shift=4, nof_harq_bits=len(bits),
        )
        mcs = {1: [0, 6], 2: [0, 3, 6, 9]}[len(bits)]
        if len(bits) == 1:
            idx = bits[0]
        else:
            idx = {(0, 0): 0, (0, 1): 1, (1, 1): 2, (1, 0): 3}[tuple(bits)]
        u, v = pucch_group_sequence(cfg.n_id)
        tx = np.empty((cfg.nof_symbols, 12), np.complex64)
        for s in range(cfg.nof_symbols):
            ncs = pucch._cyclic_shift_hopping(cfg.n_id, cfg.slot, cfg.start_symbol + s)
            alpha = 2 * np.pi * ((cfg.initial_cyclic_shift + mcs[idx] + ncs) % 12) / 12
            tx[s] = low_papr_sequence(u, v, alpha, 12)
        rng = np.random.default_rng(1)
        rx = tx * (0.8 + 0.3j) + 0.05 * (rng.normal(size=tx.shape) + 1j * rng.normal(size=tx.shape))
        got, metric, sr = pucch.detect_pucch_format0(jnp.asarray(cplx_pair(rx)[None]), cfg)
        np.testing.assert_array_equal(np.asarray(got)[0], bits)
        assert float(np.asarray(metric)[0]) > 0.5


class TestFormat1:
    @pytest.mark.parametrize("bits,occ", [([0], 0), ([1], 1), ([0, 1], 0), ([1, 0], 2)])
    def test_detects_bits(self, bits, occ):
        cfg = pucch.PucchFormat1Config(
            n_id=30, slot=1, start_symbol=0, nof_symbols=14,
            initial_cyclic_shift=3, time_domain_occ=occ, nof_harq_bits=len(bits),
        )
        seqs, (w_data,), (w_dmrs,) = pucch._f1_tables(cfg)
        if len(bits) == 1:
            d = (1 - 2 * bits[0]) / np.sqrt(2) * (1 + 1j)
        else:
            d = ((1 - 2 * bits[0]) + 1j * (1 - 2 * bits[1])) / np.sqrt(2)
        tx = np.zeros((cfg.nof_symbols, 12), np.complex64)
        i_data = 0
        i_dmrs = 0
        for s in range(cfg.nof_symbols):
            if s % 2 == 0:
                tx[s] = w_dmrs[i_dmrs] * seqs[s]
                i_dmrs += 1
            else:
                tx[s] = d * w_data[i_data] * seqs[s]
                i_data += 1
        rng = np.random.default_rng(2)
        h = 0.7 - 0.4j
        rx = tx * h + 0.05 * (rng.normal(size=tx.shape) + 1j * rng.normal(size=tx.shape))
        got, metric = pucch.detect_pucch_format1(jnp.asarray(cplx_pair(rx)[None]), cfg)
        np.testing.assert_array_equal(np.asarray(got)[0], bits)


class TestFormat2:
    @pytest.mark.parametrize("k,prb,nsym", [(4, 1, 1), (7, 2, 2), (24, 4, 2)])
    def test_roundtrip(self, k, prb, nsym):
        cfg = pucch.PucchFormat2Config(
            n_id=9, n_id0=11, rnti=0x1234, slot=2, start_symbol=12 if nsym == 2 else 13,
            nof_symbols=nsym, nof_prb=prb, nof_uci_bits=k,
        )
        rng = np.random.default_rng(k)
        msg = rng.integers(0, 2, k).astype(np.uint8)
        e = 16 * prb * nsym  # 8 data REs/PRB * QPSK
        coded = uci_mod.uci_encode(msg, e, bits_per_symbol=2)
        cinit = ((cfg.rnti << 15) + cfg.n_id) & 0x7FFFFFFF
        scr = coded ^ prg_mod.gold_sequence_bits(cinit, e)
        sym = (1 - 2 * scr[0::2].astype(np.float64)) + 1j * (1 - 2 * scr[1::2].astype(np.float64))
        sym = (sym / np.sqrt(2)).astype(np.complex64).reshape(nsym, 8 * prb)

        tx = np.zeros((nsym, 12 * prb), np.complex64)
        tx[:, pucch._f2_data_subc(prb)] = sym
        tx[:, pucch._f2_dmrs_subc(prb)] = pucch._f2_dmrs_ref(cfg)
        rng2 = np.random.default_rng(k + 1)
        h = 0.9 + 0.2j
        rx = tx * h + 0.03 * (rng2.normal(size=tx.shape) + 1j * rng2.normal(size=tx.shape))
        bits, ok = pucch.process_pucch_format2(jnp.asarray(cplx_pair(rx)[None]), cfg)
        assert bool(np.asarray(ok)[0]), f"UCI invalid for K={k}"
        np.testing.assert_array_equal(np.asarray(bits)[0], msg)


class TestMultiPort:
    """Rx-port combining: 5-D (B, P, S, N, 2) inputs; P=1 matches the 4-D
    path exactly and 4-port MRC decodes where a single port cannot."""

    def test_port_axis_identity(self):
        cfg = pucch.PucchFormat1Config(
            n_id=30, slot=1, start_symbol=0, nof_symbols=14,
            initial_cyclic_shift=3, time_domain_occ=0, nof_harq_bits=2)
        rng = np.random.default_rng(6)
        rx = (rng.normal(size=(3, 14, 12))
              + 1j * rng.normal(size=(3, 14, 12))).astype(np.complex64)
        pair = cplx_pair(rx)
        b4, m4 = pucch.detect_pucch_format1(jnp.asarray(pair), cfg)
        b5, m5 = pucch.detect_pucch_format1(jnp.asarray(pair[:, None]), cfg)
        np.testing.assert_array_equal(np.asarray(b4), np.asarray(b5))
        np.testing.assert_allclose(np.asarray(m4), np.asarray(m5), rtol=1e-6)

    def test_format2_mrc_4ports(self):
        """Independent per-port channels, heavy noise: 4-port MRC recovers
        the UCI payload."""
        k, prb, nsym = 11, 2, 2
        cfg = pucch.PucchFormat2Config(
            n_id=9, n_id0=11, rnti=0x777, slot=2, start_symbol=12,
            nof_symbols=nsym, nof_prb=prb, nof_uci_bits=k)
        rng = np.random.default_rng(7)
        msg = rng.integers(0, 2, k).astype(np.uint8)
        e = 16 * prb * nsym
        coded = uci_mod.uci_encode(msg, e, bits_per_symbol=2)
        cinit = ((cfg.rnti << 15) + cfg.n_id) & 0x7FFFFFFF
        scr = coded ^ prg_mod.gold_sequence_bits(cinit, e)
        sym = ((1 - 2 * scr[0::2].astype(np.float64))
               + 1j * (1 - 2 * scr[1::2].astype(np.float64)))
        sym = (sym / np.sqrt(2)).astype(np.complex64).reshape(nsym, 8 * prb)
        tx = np.zeros((nsym, 12 * prb), np.complex64)
        tx[:, pucch._f2_data_subc(prb)] = sym
        tx[:, pucch._f2_dmrs_subc(prb)] = pucch._f2_dmrs_ref(cfg)
        h = (rng.normal(size=4) + 1j * rng.normal(size=4)) / np.sqrt(2)
        rx = tx[None] * h[:, None, None]
        rx = rx + 0.35 * (rng.normal(size=rx.shape) + 1j * rng.normal(size=rx.shape))
        bits, ok = pucch.process_pucch_format2(
            jnp.asarray(cplx_pair(rx.astype(np.complex64))[None]), cfg)
        assert bool(np.asarray(ok)[0])
        np.testing.assert_array_equal(np.asarray(bits)[0], msg)


    def test_upper_phy_4port_cell(self):
        """End-to-end through UpperPhy: a 4-rx-port cell combines every port
        (the production path slices the device grid once, all ports)."""
        from srsran_projectvtlmo_tpu.fapi.pdus import (
            UlTtiRequest, PucchPdu, UciIndication)
        from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig, UpperPhy
        from srsran_projectvtlmo_tpu.ops import ofdm
        from srsran_projectvtlmo_tpu.utils.cplx import np_to_pair

        cell = CellConfig(nof_rb=24, dft_size=512, numerology=1, nof_rx_ports=4)
        phy = UpperPhy(cell)
        cfg = pucch.PucchFormat1Config(
            n_id=cell.phys_cell_id, slot=0, start_symbol=0, nof_symbols=14,
            initial_cyclic_shift=2, time_domain_occ=0, nof_harq_bits=2)
        seqs, (w_data,), (w_dmrs,) = pucch._f1_tables(cfg)
        d = ((1 - 2 * 1) + 1j * (1 - 2 * 1)) / np.sqrt(2)  # bits (1, 1)
        rng = np.random.default_rng(8)
        h = (rng.normal(size=4) + 1j * rng.normal(size=4)) / np.sqrt(2)
        carrier = np.zeros((4, 14, cell.nof_subc), np.complex64)
        for i, s in enumerate(range(0, 14, 2)):
            carrier[:, s, 5 * 12:6 * 12] = h[:, None] * w_dmrs[i] * seqs[s][None]
        for i, s in enumerate(range(1, 14, 2)):
            carrier[:, s, 5 * 12:6 * 12] = h[:, None] * d * w_data[i] * seqs[s][None]
        carrier += 0.05 * (rng.normal(size=carrier.shape)
                           + 1j * rng.normal(size=carrier.shape))
        samples = np.asarray(ofdm.ofdm_modulate(
            jnp.asarray(np_to_pair(carrier)), cell.dft_size, 1, 0))
        pdu = PucchPdu(format=1, rnti=0x42, prb_start=5, nof_prb=1,
                       start_symbol=0, nof_symbols=14, initial_cyclic_shift=2,
                       time_domain_occ=0, nof_harq_bits=2,
                       n_id=cell.phys_cell_id)
        inds = phy.process_ul_slot(UlTtiRequest(slot=0, pucch=(pdu,)), samples)
        uci = [i for i in inds if isinstance(i, UciIndication)]
        assert len(uci) == 1 and uci[0].valid
        np.testing.assert_array_equal(uci[0].harq_bits, [1, 1])


def test_group_hopping_varies_per_slot():
    from srsran_projectvtlmo_tpu.ops.low_papr import pucch_group_sequence
    us = {pucch_group_sequence(301, group_hopping=True, slot=s)[0] for s in range(10)}
    assert len(us) > 1  # hops across slots
    assert all(0 <= u < 30 for u in us)
    # Without hopping: deterministic.
    assert pucch_group_sequence(301)[0] == 301 % 30


class TestFormat1Hopping:
    """Intra-slot frequency hopping: per-hop OCC despread + channel estimate,
    metric averaged (reference: pucch_detector_impl.cpp:172-176)."""

    def _tx_hop(self, cfg, bits, h_per_hop, noise, rng):
        seqs, w_data_h, w_dmrs_h = pucch._f1_tables(cfg)
        if len(bits) == 1:
            d = (1 - 2 * bits[0]) / np.sqrt(2) * (1 + 1j)
        else:
            d = ((1 - 2 * bits[0]) + 1j * (1 - 2 * bits[1])) / np.sqrt(2)
        rx = np.zeros((cfg.nof_symbols, 12), np.complex64)
        for k, (a, b) in enumerate(pucch._f1_hop_ranges(cfg)):
            i_d = i_p = 0
            for s in range(a, b):
                if s % 2 == 0:
                    rx[s] = h_per_hop[k] * w_dmrs_h[k][i_p] * seqs[s]
                    i_p += 1
                else:
                    rx[s] = h_per_hop[k] * d * w_data_h[k][i_d] * seqs[s]
                    i_d += 1
        rx += noise * (rng.normal(size=rx.shape) + 1j * rng.normal(size=rx.shape))
        return rx

    @pytest.mark.parametrize("bits", [[0], [1], [1, 0]])
    def test_detects_across_hops(self, bits):
        cfg = pucch.PucchFormat1Config(
            n_id=7, slot=2, start_symbol=0, nof_symbols=14,
            initial_cyclic_shift=4, time_domain_occ=1, nof_harq_bits=len(bits),
            intra_slot_hopping=True)
        rng = np.random.default_rng(3)
        # Independent per-hop channels (the point of hopping diversity).
        h = [0.9 - 0.3j, -0.2 + 0.8j]
        rx = self._tx_hop(cfg, bits, h, 0.05, rng)
        got, metric = pucch.detect_pucch_format1(
            jnp.asarray(cplx_pair(rx)[None]), cfg)
        np.testing.assert_array_equal(np.asarray(got)[0], bits)
        assert float(np.asarray(metric)[0]) > 1.0

    def test_noise_only_below_threshold(self):
        cfg = pucch.PucchFormat1Config(
            n_id=7, slot=2, start_symbol=0, nof_symbols=14,
            initial_cyclic_shift=4, time_domain_occ=1, nof_harq_bits=1,
            intra_slot_hopping=True)
        rng = np.random.default_rng(4)
        rx = 0.3 * (rng.normal(size=(14, 12)) + 1j * rng.normal(size=(14, 12)))
        _, metric = pucch.detect_pucch_format1(
            jnp.asarray(cplx_pair(rx.astype(np.complex64))[None]), cfg)
        assert float(np.asarray(metric)[0]) < 1.0

    def test_upper_phy_hop_extraction(self):
        """End-to-end through UpperPhy: hop halves live at different PRBs."""
        from srsran_projectvtlmo_tpu.fapi.pdus import UlTtiRequest, PucchPdu, UciIndication
        from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig, UpperPhy
        from srsran_projectvtlmo_tpu.ops import ofdm
        from srsran_projectvtlmo_tpu.utils.cplx import np_to_pair

        cell = CellConfig(nof_rb=24, dft_size=512, numerology=1)
        phy = UpperPhy(cell)
        cfg = pucch.PucchFormat1Config(
            n_id=cell.phys_cell_id, slot=0, start_symbol=0, nof_symbols=14,
            initial_cyclic_shift=2, time_domain_occ=0, nof_harq_bits=1,
            intra_slot_hopping=True)
        rng = np.random.default_rng(5)
        rx = self._tx_hop(cfg, [1], [0.8 + 0.2j, 0.1 - 0.9j], 0.03, rng)
        carrier = np.zeros((14, cell.nof_subc), np.complex64)
        half = 7
        carrier[:half, 3 * 12:4 * 12] = rx[:half]
        carrier[half:, 20 * 12:21 * 12] = rx[half:]
        samples = np.asarray(ofdm.ofdm_modulate(
            jnp.asarray(np_to_pair(carrier))[None], cell.dft_size, 1, 0))
        pdu = PucchPdu(format=1, rnti=0x31, prb_start=3, nof_prb=1,
                       start_symbol=0, nof_symbols=14, initial_cyclic_shift=2,
                       time_domain_occ=0, nof_harq_bits=1,
                       n_id=cell.phys_cell_id, second_hop_prb=20)
        inds = phy.process_ul_slot(UlTtiRequest(slot=0, pucch=(pdu,)), samples)
        uci = [i for i in inds if isinstance(i, UciIndication)]
        assert len(uci) == 1 and uci[0].valid
        np.testing.assert_array_equal(uci[0].harq_bits, [1])
