"""bf16 resource grids: EVM-bounded parity vs the float32 path."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig, build_pusch_rx_slot
from srsran_projectvtlmo_tpu.models.ulsch_tx import build_ulsch_tx_slot
from srsran_projectvtlmo_tpu.models.channel import ChannelEmulator
from srsran_projectvtlmo_tpu.ran.modulation import Modulation
from srsran_projectvtlmo_tpu.ops import ofdm


@pytest.mark.slow
def test_bf16_grid_decodes_with_bounded_evm_penalty():
    cfg32 = PuschRxConfig(nof_rb=24, modulation=Modulation.QAM64,
                          target_code_rate=0.6, nof_rx_ports=1,
                          dft_size=512, numerology=1)
    cfg16 = dataclasses.replace(cfg32, grid_bf16=True)
    tx = build_ulsch_tx_slot(cfg32)
    rng = np.random.default_rng(0)
    tb = rng.integers(0, 2, (2, cfg32.tbs)).astype(np.uint8)
    grid_pair, _ = tx(jnp.asarray(tb))
    g = np.asarray(grid_pair)
    gc = g[..., 0] + 1j * g[..., 1]
    emu = ChannelEmulator("TDLA", 25.0, 1, cfg32.nof_subc, cfg32.scs_hz, seed=3)
    rx_slots = []
    for i in range(2):
        rx_grid, _ = emu.run(gc[i])
        rx_slots.append(rx_grid)
    rx_np = np.stack(rx_slots)  # (2, 1, 14, nsubc)
    pair = np.stack([rx_np.real, rx_np.imag], -1).astype(np.float32)
    samples = np.asarray(ofdm.ofdm_modulate(jnp.asarray(pair), cfg32.dft_size, 1, 0))

    out32 = build_pusch_rx_slot(cfg32)(jnp.asarray(samples))
    out16 = build_pusch_rx_slot(cfg16)(jnp.asarray(samples))

    ok32 = np.asarray(out32["tb_crc_ok"])
    ok16 = np.asarray(out16["tb_crc_ok"])
    assert ok32.all() and ok16.all()
    np.testing.assert_array_equal(np.asarray(out16["tb_bits_cb"]),
                                  np.asarray(out32["tb_bits_cb"]))
    evm32 = np.asarray(out32["evm"])
    evm16 = np.asarray(out16["evm"])
    # bf16 quantization adds at most ~0.4% absolute EVM at QAM64 scale
    # (bf16 has 8 mantissa bits: per-RE quantization SNR ~ 40 dB).
    assert np.all(evm16 - evm32 < 0.01), (evm16, evm32)
    # SNR estimates stay within 1 dB.
    assert np.all(np.abs(np.asarray(out16["snr_db"])
                         - np.asarray(out32["snr_db"])) < 1.0)


@pytest.mark.slow
def test_bf16_grid_4port_2layer_parity():
    """The north-star shape (4 ports, 2 layers) decodes identically with
    cbf16-equivalent grids, EVM penalty bounded (the precondition for
    bf16 grids being the default)."""
    cfg32 = PuschRxConfig(nof_rb=16, modulation=Modulation.QAM64,
                          target_code_rate=0.6, nof_rx_ports=4, nof_layers=2,
                          dft_size=512, numerology=1)
    cfg16 = dataclasses.replace(cfg32, grid_bf16=True)
    tx = build_ulsch_tx_slot(cfg32)
    rng = np.random.default_rng(4)
    tb = rng.integers(0, 2, (1, cfg32.tbs)).astype(np.uint8)
    layer_grids, _ = tx(jnp.asarray(tb))
    g = np.asarray(layer_grids)[0]  # (L, 14, nsubc, 2)
    gc = g[..., 0] + 1j * g[..., 1]
    # Well-conditioned 4x2 mixing + small noise.
    mix = np.exp(-2j * np.pi * np.outer(np.arange(4), np.arange(2)) / 4) / 2.0
    rx = np.einsum("pl,lsk->psk", mix, gc)
    rx += 0.01 * (rng.normal(size=rx.shape) + 1j * rng.normal(size=rx.shape))
    pair = np.stack([rx.real, rx.imag], -1).astype(np.float32)[None]
    samples = np.asarray(ofdm.ofdm_modulate(jnp.asarray(pair),
                                            cfg32.dft_size, 1, 0))

    out32 = build_pusch_rx_slot(cfg32)(jnp.asarray(samples))
    out16 = build_pusch_rx_slot(cfg16)(jnp.asarray(samples))
    assert np.asarray(out32["tb_crc_ok"]).all()
    assert np.asarray(out16["tb_crc_ok"]).all()
    np.testing.assert_array_equal(np.asarray(out16["tb_bits_cb"]),
                                  np.asarray(out32["tb_bits_cb"]))
    evm32 = np.asarray(out32["evm"])
    evm16 = np.asarray(out16["evm"])
    assert np.all(evm16 - evm32 < 0.01), (evm16, evm32)


def test_dl_bf16_grid_parity():
    """DL assembly with cbf16-equivalent grid storage (CellConfig.grid_bf16,
    the default): float32 accumulation, bfloat16 materialization.  The grid
    quantization error is bf16-epsilon-bounded and the OFDM samples' EVM
    penalty is far below the reference's cbf16 storage budget
    (reference: lib/phy/support/resource_grid_impl.h:41-51)."""
    from srsran_projectvtlmo_tpu.fapi.pdus import (
        DlTtiRequest, TxDataRequest, PdschPdu, SsbPdu)
    from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig, UpperPhy

    rng = np.random.default_rng(9)
    w = np.exp(-2j * np.pi * np.outer(np.arange(2), np.arange(2)) / 2) / np.sqrt(2)
    prec = tuple(tuple((float(c.real), float(c.imag)) for c in row) for row in w)
    req = DlTtiRequest(
        slot=1,
        ssb=(SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=0,
                    half_radio_frame=False),),
        pdsch=(PdschPdu(rnti=0x4601, rb_start=2, rb_size=20,
                        modulation=Modulation.QAM256,
                        target_code_rate=0.8, nof_layers=2,
                        start_symbol=2, nof_symbols=12, dmrs_symbols=(2,),
                        precoding=prec),),
    )
    cell16 = CellConfig(nof_rb=24, dft_size=512, numerology=1, nof_tx_ports=2)
    cell32 = dataclasses.replace(cell16, grid_bf16=False)
    assert cell16.grid_bf16  # the default IS bf16 storage
    from srsran_projectvtlmo_tpu.phy import dl_slot as dl_mod

    tbs = dl_mod.get_dl_slot_program(req, cell16).pdsch_cfgs[0].tbs
    tx_data = TxDataRequest(slot=1, tb_bits=[
        rng.integers(0, 2, tbs).astype(np.uint8)])
    g16, s16 = UpperPhy(cell16).process_dl_slot(req, tx_data)
    g32, s32 = UpperPhy(cell32).process_dl_slot(req, tx_data)

    assert g16.dtype == np.complex64 and g16.shape == g32.shape
    # Grid: bf16 has 8 mantissa bits -> relative error <= 2^-8 per RE.
    scale = np.abs(g32).max()
    np.testing.assert_allclose(g16, g32, atol=scale * 2 ** -8)
    # Samples: EVM penalty of the quantized grid is < 0.5%.
    err = np.sqrt(np.mean((s16 - s32) ** 2))
    ref = np.sqrt(np.mean(s32 ** 2))
    assert err / ref < 5e-3, f"DL bf16 sample EVM {err / ref:.4f}"
