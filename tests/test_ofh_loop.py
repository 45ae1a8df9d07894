"""Closed OFH data-path loop (ru_emulator equivalent).

One real DL slot's IQ goes DU -> RU over the modeled split-7.2 fronthaul:
resource grid -> BFP compression -> packed PRBs -> U-plane section framing
(+ C-plane type 1) -> eCPRI -> VLAN Ethernet frames -> decode back through
the sequence-id and rx-window checkers -> grid parity within the BFP
quantization bound (reference: tests/integrationtests/ofh/, lib/ofh/receiver/).
"""

import numpy as np
import jax.numpy as jnp

from srsran_projectvtlmo_tpu.fapi.pdus import DlTtiRequest, TxDataRequest, PdschPdu
from srsran_projectvtlmo_tpu.ofh import cplane, ecpri, ethernet, uplane
from srsran_projectvtlmo_tpu.ofh.reception import SequenceIdChecker, RxWindowChecker
from srsran_projectvtlmo_tpu.ops.ofh_compression import (
    bfp_compress, bfp_decompress, pack_prbs, unpack_prbs,
)
from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig, UpperPhy
from srsran_projectvtlmo_tpu.ran.modulation import Modulation
from srsran_projectvtlmo_tpu.ran.slot import SlotPoint


def _du_transmit(grid, cell, slot_count, vlan, width):
    """DU side: compress + frame one slot of IQ as per-symbol VLAN frames."""
    frames = []
    slot_pt = SlotPoint(numerology=cell.numerology, count=slot_count)
    # One C-plane type-1 message announcing the slot's symbols.
    hdr = cplane.CplaneRadioHeader(
        direction=1, sfn=slot_pt.sfn, subframe=slot_pt.subframe_index,
        slot=slot_pt.slot_in_subframe, start_symbol=0)
    sec = cplane.CplaneCommonSection(
        section_id=0, prb_start=0, nof_prb=cell.nof_rb, nof_symbols=14)
    cp_msg = cplane.build_type1_message(hdr, sec)
    frames.append(("cplane", ethernet.build_vlan_frame(
        vlan, ecpri.build_rt_control_packet(rtc_id=0, seq_id=0,
                                            payload=cp_msg))))

    seq = 0
    for sym in range(14):
        re_pair = np.stack([grid[sym].real, grid[sym].imag],
                           -1).reshape(cell.nof_rb, 12, 2)
        # 0.5 linear backoff keeps QAM peaks (|re| up to ~1.08) inside the
        # int16 quantizer range (reference: ru_ofh iq_scaling config).
        mant, exp = bfp_compress(jnp.asarray(re_pair[None]), width,
                                 iq_scaling=0.5)
        prb_bytes = np.asarray(pack_prbs(mant, width, exp))[0]
        params = uplane.UplaneMessageParams(
            slot=slot_pt, symbol_id=sym, start_prb=0, nof_prb=cell.nof_rb,
            data_width=width)
        msg = uplane.build_uplane_message(params, prb_bytes)
        pkt = ecpri.build_iq_data_packet(pc_id=0, seq_id=seq, payload=msg)
        frames.append(("uplane", ethernet.build_vlan_frame(vlan, pkt)))
        seq = (seq + 1) & 0xFF
    return frames


def _ru_receive(frames, cell, width):
    """RU side: decode frames through the checkers, rebuild the grid."""
    seq_check = SequenceIdChecker()
    win = RxWindowChecker(numerology=cell.numerology, sym_start=0, sym_end=28)
    grid = np.zeros((14, cell.nof_subc), np.complex64)
    lost = 0
    got_cplane = None
    for kind, frame in frames:
        dec = ethernet.decode_vlan_frame(frame)
        pkt = ecpri.decode_packet(dec.payload)
        if kind == "cplane":
            got_cplane = cplane.decode_message(pkt.payload)
            continue
        lost += abs(seq_check.update_and_compare(pkt.pc_id, pkt.seq_id))
        res = uplane.decode_uplane_message(pkt.payload, static_width=width)
        slot_index = (res.slot_id
                      + (1 << cell.numerology) * res.subframe_id)
        win.on_new_symbol(res.frame_id, slot_index, res.symbol_id)
        assert win.check(res.frame_id, slot_index, res.symbol_id) == "on_time"
        mant, exp = unpack_prbs(jnp.asarray(res.prb_payload), width)
        re_pair = np.asarray(bfp_decompress(mant, width,
                                            iq_scaling=0.5,
                                            exponents=exp))
        vals = re_pair.reshape(cell.nof_rb, 12, 2)
        row = vals[..., 0] + 1j * vals[..., 1]
        grid[res.symbol_id, res.start_prb * 12:
             (res.start_prb + res.nof_prb) * 12] = row.reshape(-1)
    return grid, lost, got_cplane


def test_dl_slot_through_ofh_loop():
    cell = CellConfig(nof_rb=24, dft_size=512, numerology=1)
    phy = UpperPhy(cell)
    pdu = PdschPdu(rnti=0x77, rb_start=0, rb_size=24,
                   modulation=Modulation.QAM64, target_code_rate=0.6,
                   start_symbol=1, nof_symbols=13, dmrs_symbols=(2,),
                   n_id=cell.phys_cell_id)
    from srsran_projectvtlmo_tpu.phy.dl_slot import get_dl_slot_program
    req = DlTtiRequest(slot=5, pdsch=(pdu,))
    tbs = get_dl_slot_program(req, cell).pdsch_cfgs[0].tbs
    rng = np.random.default_rng(0)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    grid, _ = phy.process_dl_slot(req, TxDataRequest(5, [tb]))

    vlan = ethernet.VlanFrameParams(
        mac_dst=b"\x02\x00\x00\x00\x00\x01",
        mac_src=b"\x02\x00\x00\x00\x00\x02", tci=3)
    width = 9
    frames = _du_transmit(grid, cell, slot_count=5, vlan=vlan, width=width)
    rebuilt, lost, cp = _ru_receive(frames, cell, width)

    assert lost == 0, "sequence-id checker saw gaps"
    assert cp is not None and cp.section.nof_prb == cell.nof_rb

    # Grid parity within the 9-bit BFP quantization bound: EVM well under 1%.
    ref = grid.reshape(14, -1)
    err = np.linalg.norm(rebuilt - ref) / max(np.linalg.norm(ref), 1e-12)
    assert err < 0.01, f"fronthaul EVM {err:.4f}"
    # Exact zero REs survive (no compression noise added to silence).
    assert np.abs(rebuilt[0]).max() == 0 or np.abs(ref[0]).max() > 0


def test_ofh_loop_detects_lost_frame():
    cell = CellConfig(nof_rb=12, dft_size=256, numerology=1)
    rng = np.random.default_rng(1)
    grid = (rng.normal(size=(14, cell.nof_subc))
            + 1j * rng.normal(size=(14, cell.nof_subc))).astype(np.complex64)
    vlan = ethernet.VlanFrameParams(
        mac_dst=b"\x02\x00\x00\x00\x00\x01",
        mac_src=b"\x02\x00\x00\x00\x00\x02", tci=3)
    frames = _du_transmit(grid, cell, slot_count=1, vlan=vlan, width=9)
    # Drop one U-plane symbol frame.
    dropped = [f for i, f in enumerate(frames) if i != 5]
    _, lost, _ = _ru_receive(dropped, cell, 9)
    assert lost >= 1, "sequence-id checker must flag the dropped frame"
