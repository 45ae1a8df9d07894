"""CPU rehearsal of chip_smoke.py: its phase logic runs at a tiny cell
size, and the script refuses to report a result without a GPU."""

import json

import numpy as np
import jax
import pytest

import chip_smoke
from apps import northstar as ns
from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig


def test_refuses_to_report_ok_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("SRSRAN_TESTS_ON_GPU", "0")  # restored after the test
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "not 'gpu'" in out.err


def test_phases_at_tiny_size():
    """Slots 0..4 (SSB, PRACH) of a 24-PRB 4-port cell: UL bits, PUCCH,
    PRACH and the DL grid against a second device; then the memory phase."""
    prof = ns.make_profile(CellConfig(nof_rb=24, dft_size=512, numerology=1,
                                      nof_tx_ports=4, nof_rx_ports=4, phys_cell_id=1))
    line = chip_smoke.phase_slots(prof, 5, jax.devices()[1])
    assert "UL TB CRC and bits OK 5/5" in line and "PRACH OK 1/1" in line
    assert "PUSCH program memory" in chip_smoke.phase_memory(prof)


def test_dl_evm():
    rng = np.random.default_rng(0)
    ref = (rng.normal(size=(4, 14, 36)) + 1j * rng.normal(size=(4, 14, 36))).astype(np.complex64)
    assert chip_smoke.dl_evm(ref, ref) == 0.0
    assert chip_smoke.dl_evm(ref * (1 + 1e-3), ref) == pytest.approx(1e-3, rel=1e-3)


def test_check_raises_phase_failed():
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.PhaseFailed, match="broken"):
        chip_smoke.check(False, "broken")


def test_four_card_path_at_tiny_size():
    """The --four-cards comparison on 4 of the 8 virtual CPU devices: UL
    halo exchange, CB-sharded decode and batched DL on a (2 cell x 2 sp)
    mesh against one device, every stage spanning the whole mesh."""
    four, one = chip_smoke.four_cards(CellConfig(
        nof_rb=24, dft_size=512, numerology=1, nof_tx_ports=4, nof_rx_ports=4,
        phys_cell_id=1))
    assert "'devices_ul': 4" in four and "'devices_cb': 4" in four
    assert "UL bits equal to four cards" in one
