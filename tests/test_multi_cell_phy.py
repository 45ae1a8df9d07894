"""Multi-cell UpperPhy over the (cell, sp) mesh: FAPI PDUs per cell, one
sharded program for same-structure PUSCH across cells with different
rnti/n_id (dynamic_params inputs)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from srsran_projectvtlmo_tpu.fapi.pdus import (
    UlTtiRequest, PuschPdu, CrcIndication, RxDataIndication,
)
from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig
from srsran_projectvtlmo_tpu.models.ulsch_tx import build_ulsch_tx_slot
from srsran_projectvtlmo_tpu.parallel.distributed import make_ran_mesh
from srsran_projectvtlmo_tpu.parallel.multi_cell_phy import MultiCellUpperPhy
from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig
from srsran_projectvtlmo_tpu.ran.modulation import Modulation


@pytest.mark.slow
def test_four_cells_distinct_rnti_one_program():
    ncell = 4
    cell = CellConfig(nof_rb=24, dft_size=512, numerology=1, nof_rx_ports=1)
    rmesh = make_ran_mesh(nof_cell_shards=4, nof_sp_shards=2)
    phy = MultiCellUpperPhy(cell, ncell, rmesh)

    rng = np.random.default_rng(0)
    slot = 3
    rntis = [0x101, 0x202, 0x303, 0x404]
    nids = [5, 17, 29, 41]
    tbs_list, samples = [], []
    pdus = []
    for c in range(ncell):
        tx_cfg = PuschRxConfig(
            nof_rb=16, modulation=Modulation.QAM16, target_code_rate=0.5,
            rnti=rntis[c], n_id=nids[c], rb_start=4, nof_rx_ports=1,
            dft_size=cell.dft_size, numerology=1, slot=slot,
            dmrs_symbols=(2,),
        )
        tx = build_ulsch_tx_slot(tx_cfg)
        tb = rng.integers(0, 2, tx_cfg.tbs).astype(np.uint8)
        tbs_list.append(tb)
        grid_pair, _ = tx(jnp.asarray(tb[None]))
        alloc = np.asarray(grid_pair)[0]  # (14, 192, 2)
        carrier = np.zeros((14, cell.nof_subc, 2), np.float32)
        carrier[:, 4 * 12:20 * 12, :] = alloc
        from srsran_projectvtlmo_tpu.ops import ofdm
        samp = np.asarray(ofdm.ofdm_modulate(
            jnp.asarray(carrier), cell.dft_size, 1, slot % 2))
        noise = 0.003 * rng.normal(size=samp.shape).astype(np.float32)
        samples.append(samp[None] + noise)  # (1 port, nsamp, 2)
        pdus.append(PuschPdu(
            rnti=rntis[c], rb_start=4, rb_size=16, modulation=Modulation.QAM16,
            target_code_rate=0.5, n_id=nids[c], dmrs_symbols=(2,)))

    requests = [UlTtiRequest(slot=slot, pusch=(pdus[c],)) for c in range(ncell)]
    out = phy.process_ul_slot(requests, np.stack(samples))

    assert len(out) == ncell
    for c in range(ncell):
        crc = [i for i in out[c] if isinstance(i, CrcIndication)]
        rxd = [i for i in out[c] if isinstance(i, RxDataIndication)]
        assert crc and crc[0].tb_crc_ok, f"cell {c} failed CRC"
        assert crc[0].rnti == rntis[c]
        np.testing.assert_array_equal(rxd[0].tb_bits, tbs_list[c])


@pytest.mark.slow
def test_heterogeneous_shapes_fall_back_per_cell():
    """Cells with different PUSCH shapes still process (per-cell path)."""
    ncell = 2
    cell = CellConfig(nof_rb=24, dft_size=512, numerology=1, nof_rx_ports=1)
    rmesh = make_ran_mesh(nof_cell_shards=2, nof_sp_shards=4)
    phy = MultiCellUpperPhy(cell, ncell, rmesh)
    rng = np.random.default_rng(1)
    slot = 0
    sizes = [8, 16]
    samples, tbs_list = [], []
    reqs = []
    for c in range(ncell):
        tx_cfg = PuschRxConfig(
            nof_rb=sizes[c], modulation=Modulation.QPSK, target_code_rate=0.4,
            rnti=0x10 + c, n_id=c, rb_start=0, nof_rx_ports=1,
            dft_size=cell.dft_size, numerology=1, slot=slot, dmrs_symbols=(2,))
        tx = build_ulsch_tx_slot(tx_cfg)
        tb = rng.integers(0, 2, tx_cfg.tbs).astype(np.uint8)
        tbs_list.append(tb)
        grid_pair, _ = tx(jnp.asarray(tb[None]))
        alloc = np.asarray(grid_pair)[0]
        carrier = np.zeros((14, cell.nof_subc, 2), np.float32)
        carrier[:, :sizes[c] * 12, :] = alloc
        from srsran_projectvtlmo_tpu.ops import ofdm
        samp = np.asarray(ofdm.ofdm_modulate(
            jnp.asarray(carrier), cell.dft_size, 1, 0))
        samples.append(samp[None])
        reqs.append(UlTtiRequest(slot=slot, pusch=(PuschPdu(
            rnti=0x10 + c, rb_start=0, rb_size=sizes[c],
            modulation=Modulation.QPSK, target_code_rate=0.4, n_id=c,
            dmrs_symbols=(2,)),)))
    out = phy.process_ul_slot(reqs, np.stack(samples))
    for c in range(ncell):
        crc = [i for i in out[c] if isinstance(i, CrcIndication)]
        assert crc and crc[0].tb_crc_ok, f"cell {c} failed CRC"
        rxd = [i for i in out[c] if isinstance(i, RxDataIndication)]
        np.testing.assert_array_equal(rxd[0].tb_bits, tbs_list[c])


def test_harq_retransmission_in_batched_path():
    """Retransmissions ride the SAME sharded batch as new data: a first tx
    too noisy to decode is soft-combined with the rv=2 retransmission and
    passes CRC, per cell, through the batched program (reference: include/srsran/phy/upper/rx_buffer_pool.h:40-106)."""
    import dataclasses
    from srsran_projectvtlmo_tpu.ops import ofdm

    ncell = 2
    cell = CellConfig(nof_rb=16, dft_size=256, numerology=1, nof_rx_ports=1)
    rmesh = make_ran_mesh(nof_cell_shards=2, nof_sp_shards=4)
    phy = MultiCellUpperPhy(cell, ncell, rmesh)

    rng = np.random.default_rng(7)
    rntis = [0x111, 0x222]
    tbs_list = []
    # High code rate so a heavily-noised rv=0 fails alone; the rv=2 combine
    # must recover it.
    base = dict(nof_rb=12, modulation=Modulation.QAM16, target_code_rate=0.75,
                rb_start=0, nof_rx_ports=1, dft_size=cell.dft_size,
                numerology=1, dmrs_symbols=(2,))

    # Grid-domain noise amplitude calibrated so one transmission reliably
    # FAILS at R=0.75 QAM16 while chase combining two independent copies
    # (+3 dB effective) reliably passes.
    NOISE = 0.21

    def make_samples(slot, rv):
        samples = []
        for c in range(ncell):
            tx_cfg = PuschRxConfig(rnti=rntis[c], n_id=c + 1, slot=slot,
                                   rv=rv, **base)
            tx = build_ulsch_tx_slot(tx_cfg)
            if len(tbs_list) < ncell:
                tbs_list.append(rng.integers(0, 2, tx_cfg.tbs).astype(np.uint8))
            grid_pair, _ = tx(jnp.asarray(tbs_list[c][None]))
            alloc = (np.asarray(grid_pair)[0]
                     + NOISE * rng.normal(size=grid_pair[0].shape)
                     .astype(np.float32))
            carrier = np.zeros((14, cell.nof_subc, 2), np.float32)
            carrier[:, :12 * 12, :] = alloc
            samp = np.asarray(ofdm.ofdm_modulate(
                jnp.asarray(carrier), cell.dft_size, 1, slot % 2))
            samples.append(samp[None])
        return np.stack(samples)

    def pdus(rv, new_data):
        return [PuschPdu(rnti=rntis[c], rb_start=0, rb_size=12,
                         modulation=Modulation.QAM16, target_code_rate=0.75,
                         n_id=c + 1, dmrs_symbols=(2,), rv=rv,
                         new_data=new_data, harq_id=3)
                for c in range(ncell)]

    # First transmission: noisy enough to fail.
    out0 = phy.process_ul_slot(
        [UlTtiRequest(slot=0, pusch=(p,)) for p in pdus(0, True)],
        make_samples(0, 0))
    crcs0 = [i for o in out0 for i in o if isinstance(i, CrcIndication)]
    assert not any(i.tb_crc_ok for i in crcs0), "first tx should fail"

    # Chase-combining retransmission: only the combined soft bits decode.
    out1 = phy.process_ul_slot(
        [UlTtiRequest(slot=2, pusch=(p,)) for p in pdus(0, False)],
        make_samples(2, 0))
    for c, o in enumerate(out1):
        crc = [i for i in o if isinstance(i, CrcIndication)]
        data = [i for i in o if isinstance(i, RxDataIndication)]
        assert crc and crc[0].tb_crc_ok, f"cell {c} retx failed"
        np.testing.assert_array_equal(data[0].tb_bits, tbs_list[c])


def test_multi_cell_dl_matches_per_cell():
    """The batched multi-cell DL program (cells on the mesh axis) produces
    the same grids/samples as per-cell UpperPhy dispatch."""
    from srsran_projectvtlmo_tpu.fapi.pdus import (
        DlTtiRequest, TxDataRequest, SsbPdu, PdschPdu)
    from srsran_projectvtlmo_tpu.phy.upper_phy import UpperPhy

    cell = CellConfig(nof_rb=52, dft_size=1024, numerology=1,
                      nof_tx_ports=2, phys_cell_id=7)
    mc = MultiCellUpperPhy(cell, 2)
    rng = np.random.default_rng(11)

    reqs, txs = [], []
    for c, rnti in enumerate((0x4601, 0x4702)):
        pdsch = PdschPdu(rnti=rnti, rb_start=4, rb_size=24,
                         modulation=Modulation.QAM16, target_code_rate=0.5,
                         nof_layers=2, start_symbol=2, nof_symbols=10,
                         dmrs_symbols=(2,), n_id=c + 1)
        req = DlTtiRequest(
            slot=3,
            ssb=(SsbPdu(phys_cell_id=7, ssb_block_index=0, sfn=c,
                        half_radio_frame=False),),
            pdsch=(pdsch,),
        )
        from srsran_projectvtlmo_tpu.phy.dl_slot import get_dl_slot_program
        tbs = get_dl_slot_program(req, cell).pdsch_cfgs[0].tbs
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        reqs.append(req)
        txs.append(TxDataRequest(slot=3, tb_bits=[tb]))

    grids, samples = mc.process_dl_slot(reqs, txs, fetch=True)
    assert grids.shape[0] == 2 and samples.shape[0] == 2

    ref_phy = UpperPhy(cell)
    for c in range(2):
        g_ref, s_ref = ref_phy.process_dl_slot(reqs[c], txs[c], fetch=False)
        np.testing.assert_allclose(grids[c], np.asarray(g_ref), atol=2e-5)
        np.testing.assert_allclose(samples[c], np.asarray(s_ref), atol=2e-4)


def test_multi_cell_csi_two_phase_buckets():
    """CSI-on-PUSCH across cells in the batched path: ONE phase-A program on
    the cell axis; cells whose decoded part 1 selects different part-2 sizes
    finish in separate phase-B bucket dispatches."""
    from srsran_projectvtlmo_tpu.fapi.pdus import UciIndication
    from srsran_projectvtlmo_tpu.ops import ofdm

    ncell = 2
    cell = CellConfig(nof_rb=24, dft_size=512, numerology=1, nof_rx_ports=1)
    rmesh = make_ran_mesh(nof_cell_shards=2, nof_sp_shards=4)
    phy = MultiCellUpperPhy(cell, ncell, rmesh)

    rng = np.random.default_rng(23)
    slot = 2
    p2map = (4, 6, 8, 10)
    rntis, nids, csi1_vals = [0x111, 0x222], [3, 9], [1, 3]
    tbs_list, csi2_list, samples, pdus = [], [], [], []
    for c in range(ncell):
        csi2_size = p2map[csi1_vals[c]]
        tx_cfg = PuschRxConfig(
            nof_rb=16, modulation=Modulation.QAM16, target_code_rate=0.5,
            rnti=rntis[c], n_id=nids[c], rb_start=4, nof_rx_ports=1,
            dft_size=cell.dft_size, numerology=1, slot=slot,
            dmrs_symbols=(2,), nof_csi_part1_bits=2)
        tx = build_ulsch_tx_slot(tx_cfg, nof_csi_part2_bits=csi2_size)
        tb = rng.integers(0, 2, tx_cfg.tbs).astype(np.uint8)
        csi1 = np.array([[csi1_vals[c] >> 1, csi1_vals[c] & 1]], np.uint8)
        csi2 = rng.integers(0, 2, (1, csi2_size)).astype(np.uint8)
        tbs_list.append(tb)
        csi2_list.append(csi2[0])
        grid_pair, _ = tx(jnp.asarray(tb[None]), csi1_bits=jnp.asarray(csi1),
                          csi2_bits=jnp.asarray(csi2))
        alloc = np.asarray(grid_pair)[0]
        carrier = np.zeros((14, cell.nof_subc, 2), np.float32)
        carrier[:, 4 * 12:20 * 12, :] = alloc
        samp = np.asarray(ofdm.ofdm_modulate(
            jnp.asarray(carrier), cell.dft_size, 1, slot % 2))
        samples.append(samp[None] + 0.003 * rng.normal(
            size=samp[None].shape).astype(np.float32))
        pdus.append(PuschPdu(
            rnti=rntis[c], rb_start=4, rb_size=16,
            modulation=Modulation.QAM16, target_code_rate=0.5, n_id=nids[c],
            dmrs_symbols=(2,), nof_csi_part1_bits=2, part2_size_map=p2map))

    requests = [UlTtiRequest(slot=slot, pusch=(pdus[c],)) for c in range(ncell)]
    out = phy.process_ul_slot(requests, np.stack(samples))
    for c in range(ncell):
        crc = [i for i in out[c] if isinstance(i, CrcIndication)][0]
        rxd = [i for i in out[c] if isinstance(i, RxDataIndication)][0]
        uci = [i for i in out[c] if isinstance(i, UciIndication)][0]
        assert crc.tb_crc_ok, f"cell {c} failed CRC with CSI multiplexed"
        np.testing.assert_array_equal(rxd.tb_bits, tbs_list[c])
        assert uci.csi1_valid
        exp_csi1 = [csi1_vals[c] >> 1, csi1_vals[c] & 1]
        np.testing.assert_array_equal(uci.csi1_bits, exp_csi1)
        assert uci.csi2_valid
        np.testing.assert_array_equal(uci.csi2_bits, csi2_list[c])
