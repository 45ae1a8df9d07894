"""The north-star cell profile as reusable pieces: the cell, its slot
requests, and the emulated UE and radio that feed the uplink.

BASELINE config 5, the reference's 100 MHz 4x2 TDD cell (reference:
apps/gnb/gnb.cpp + configs/gnb_ru_ran550_tdd_n78_100mhz_4x2.yml): a 273-PRB
4096-point 30 kHz carrier with 4 TX/RX ports.  DL = SSB (slot 0) +
interleaved PDCCH + CSI-RS + 2-layer precoded full-band PDSCH; UL = 2-layer
272-PRB QAM256 R=948/1024 PUSCH through the streaming rx-symbol path, PUCCH
format 1 on PRB 272 and a PRACH occasion in slot 4 of every 8.

`apps/gnb_sim.py --northstar` drives these pieces in a slot loop and
`chip_smoke.py` runs them on the GPU; both go through `UpperPhy` as a user
of the package would.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from srsran_projectvtlmo_tpu.fapi.pdus import (
    CsiRsPdu, DlTtiRequest, PdcchPdu, PdschPdu, PrachPdu, PucchPdu, PuschPdu,
    SsbPdu, TxDataRequest, UlTtiRequest)
from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig
from srsran_projectvtlmo_tpu.models.ulsch_tx import cached_ulsch_tx
from srsran_projectvtlmo_tpu.ops import ofdm
from srsran_projectvtlmo_tpu.ops import prach as prach_mod
from srsran_projectvtlmo_tpu.ops.csi_rs import CsiRsConfig
from srsran_projectvtlmo_tpu.phy import pucch as pucch_mod
from srsran_projectvtlmo_tpu.phy.prach_buffer import PrachBuffer, PrachBufferFormat
from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig
from srsran_projectvtlmo_tpu.ran.modulation import Modulation
from srsran_projectvtlmo_tpu.ran.re_pattern import csi_rs_patterns
from srsran_projectvtlmo_tpu.utils.cplx import np_to_pair, pair_to_np

CELL = CellConfig(nof_rb=273, dft_size=4096, numerology=1,
                  nof_tx_ports=4, nof_rx_ports=4, phys_cell_id=1)
PUSCH_RNTI = 0x4601
PUCCH_RNTI = 0x4602
#: The emulated radio repeats with period 8 (the TDD pattern length), and
#: slot 4 of each period carries the PRACH occasion with preamble 7.
PERIOD = 8
PRACH_SLOT = 4
PRACH_PREAMBLE = 7


@dataclass(frozen=True)
class Profile:
    cell: CellConfig
    pdsch: PdschPdu
    pdcch: PdcchPdu
    csi: CsiRsPdu
    ue_cfg: PuschRxConfig
    pucch: PucchPdu
    prach_cfg: prach_mod.PrachDetectorConfig
    prach_fmt: PrachBufferFormat
    prach: PrachPdu


def make_profile(cell: CellConfig = CELL) -> Profile:
    """The profile on `cell` (4 TX/RX ports): the PDSCH and CSI-RS span the
    carrier, the PUSCH all PRBs but the last, which carries the PUCCH."""
    pusch_rb = cell.nof_rb - 1
    w_dl = np.exp(-2j * np.pi * np.outer(np.arange(4), np.arange(2)) / 4) / 2.0
    prec = tuple(tuple((float(c.real), float(c.imag)) for c in row) for row in w_dl)
    # CSI-RS INSIDE the PDSCH span: the PDSCH rate-matches around it via the
    # reserved RE patterns (reference: pdsch_processor_impl.cpp:77-96).
    reserved = csi_rs_patterns(CsiRsConfig(
        nof_rb=cell.nof_rb, symbol=12, subcarrier_offset=3, slot=0))
    return Profile(
        cell=cell,
        pdsch=PdschPdu(rnti=PUSCH_RNTI, rb_start=0, rb_size=cell.nof_rb,
                       modulation=Modulation.QAM256, target_code_rate=948 / 1024,
                       nof_layers=2, start_symbol=2, nof_symbols=11,
                       dmrs_symbols=(2,), n_id=cell.phys_cell_id, precoding=prec,
                       reserved=reserved),
        pdcch=PdcchPdu(rnti=PUSCH_RNTI, nof_dci_bits=40, aggregation_level=4,
                       cce_index=0, start_symbol=1, n_id=cell.phys_cell_id,
                       n_rnti=PUSCH_RNTI, coreset_nof_rb=min(48, cell.nof_rb),
                       interleaved=True),
        csi=CsiRsPdu(nof_rb=cell.nof_rb, symbol=12, subcarrier_offset=3),
        ue_cfg=PuschRxConfig(
            nof_rb=pusch_rb, modulation=Modulation.QAM256,
            target_code_rate=948 / 1024, nof_layers=2, nof_rx_ports=4,
            rnti=PUSCH_RNTI, n_id=cell.phys_cell_id, dft_size=cell.dft_size,
            numerology=cell.numerology),
        pucch=PucchPdu(format=1, rnti=PUCCH_RNTI, prb_start=pusch_rb, nof_prb=1,
                       start_symbol=0, nof_symbols=14, initial_cyclic_shift=3,
                       time_domain_occ=0, nof_harq_bits=1, n_id=cell.phys_cell_id),
        prach_cfg=prach_mod.PrachDetectorConfig(
            sequence_length=prach_mod.LONG, root_sequence_index=0,
            zero_correlation_zone=1, ncs_table="1.25kHz"),
        prach_fmt=PrachBufferFormat(sequence_length=prach_mod.LONG,
                                    nof_symbols=1, nof_ports=4),
        prach=PrachPdu(format_is_long=True, root_sequence_index=0,
                       zero_correlation_zone=1),
    )


def dl_request(p: Profile, slot: int) -> DlTtiRequest:
    return DlTtiRequest(
        slot=slot,
        ssb=(SsbPdu(phys_cell_id=p.cell.phys_cell_id, ssb_block_index=0,
                    sfn=0, half_radio_frame=False),) if slot == 0 else (),
        pdcch=(p.pdcch,), pdsch=(p.pdsch,), csi_rs=(p.csi,))


def dl_tx_data(p: Profile, req: DlTtiRequest, rng) -> TxDataRequest:
    from srsran_projectvtlmo_tpu.phy.dl_slot import get_dl_slot_program

    tbs = get_dl_slot_program(req, p.cell).pdsch_cfgs[0].tbs
    return TxDataRequest(req.slot, [rng.integers(0, 2, tbs).astype(np.uint8)])


def pusch_pdu(p: Profile) -> PuschPdu:
    return PuschPdu(rnti=PUSCH_RNTI, rb_start=0, rb_size=p.ue_cfg.nof_rb,
                    modulation=Modulation.QAM256, target_code_rate=948 / 1024,
                    nof_layers=2, n_id=p.cell.phys_cell_id, dmrs_symbols=(2,))


def ul_slot(p: Profile, slot: int, rng, snr_db: float):
    """One emulated UL slot: the UE's 2-layer PUSCH through a fixed 4x2
    mixing channel, PUCCH F1 (one HARQ bit = 1) on the last PRB at every port,
    and AWGN at `snr_db`.  Returns (TB bits, frequency grid (4, 14, nsubc)
    complex64, time-domain samples (4, nsamples, 2))."""
    cell = p.cell
    k0 = p.ue_cfg.nof_rb * 12
    ue_slot = dataclasses.replace(p.ue_cfg, slot=slot)
    tb = rng.integers(0, 2, ue_slot.tbs).astype(np.uint8)
    layer_grids, _ = cached_ulsch_tx(ue_slot)(jnp.asarray(tb[None]))
    layers = pair_to_np(np.asarray(layer_grids))[0]  # (L, 14, 3264)
    mix = np.exp(-2j * np.pi * np.outer(np.arange(4), np.arange(2))
                 / 4).astype(np.complex64) / np.sqrt(4)
    full = np.zeros((4, 14, cell.nof_subc), np.complex64)
    full[:, :, :k0] = np.einsum("pl,lsk->psk", mix, layers)
    f1 = pucch_mod.PucchFormat1Config(
        n_id=cell.phys_cell_id, slot=slot, start_symbol=0, nof_symbols=14,
        initial_cyclic_shift=3, time_domain_occ=0, nof_harq_bits=1)
    seqs, (w_data,), (w_dmrs,) = pucch_mod._f1_tables(f1)
    d = (1 - 2 * 1) / np.sqrt(2) * (1 + 1j)
    i_data = i_dmrs = 0
    for s in range(14):
        if s % 2 == 0:
            val = w_dmrs[i_dmrs] * seqs[s]
            i_dmrs += 1
        else:
            val = d * w_data[i_data] * seqs[s]
            i_data += 1
        full[:, s, k0:k0 + 12] = val
    noise_amp = 10.0 ** (-snr_db / 20.0)
    full += noise_amp * (rng.normal(size=full.shape)
                         + 1j * rng.normal(size=full.shape)) / np.sqrt(2)
    samples = np.asarray(ofdm.ofdm_modulate(
        jnp.asarray(np_to_pair(full)), cell.dft_size, cell.numerology,
        slot % (1 << cell.numerology)))
    return tb, full, samples


def prach_occasion(p: Profile, rng) -> PrachBuffer:
    """The PRACH occasion buffer: preamble 7 through a per-port channel."""
    x = prach_mod.prach_generate(p.prach_cfg, preamble_index=PRACH_PREAMBLE)
    buf = PrachBuffer(p.prach_fmt, 0)
    h = (rng.normal(size=4) + 1j * rng.normal(size=4)) / np.sqrt(2)
    occ = (h[:, None] * x[None, :]
           + 0.05 * (rng.normal(size=(4, len(x))) + 1j * rng.normal(size=(4, len(x)))))
    buf.set_symbol(0, 0, np.stack([occ.real, occ.imag], -1))
    return buf


def process_ul_slot(phy, handler, p: Profile, slot: int, full, samples,
                    prach_buf: PrachBuffer | None) -> list:
    """The served UL path for one slot: the PUSCH fires from the streaming
    rx-symbol handler when its last symbol arrives; PUCCH (and PRACH, when
    the slot has an occasion) ride the slot request."""
    handler.repo.add(slot, pusch_pdu(p))
    inds = []
    for sym in range(14):
        for pdu in handler.handle_rx_symbol(slot, sym, full[:, sym, :]):
            inds.extend(phy.process_ul_slot(
                UlTtiRequest(slot=slot, pusch=(pdu,)), samples, validate=False))
    handler.release_slot(slot)
    inds.extend(phy.process_ul_slot(
        UlTtiRequest(slot=slot, pucch=(p.pucch,),
                     prach=(p.prach,) if prach_buf is not None else ()),
        samples, prach_samples=prach_buf, validate=False))
    return inds
