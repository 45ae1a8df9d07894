#!/usr/bin/env python3
"""Smoke test of the served upper-PHY slot path on the GPU.

  python chip_smoke.py                # one card
  python chip_smoke.py --four-cards   # the multi-device path on four cards

One card, five phases, each printing one line:
  1. device: JAX's devices and the card's name and power limit; stops unless
     JAX's platform is "gpu" (there is no CPU fallback);
  2. north-star slots (apps/northstar.py through UpperPhy): every UL TB CRC
     passes with the decoded bits equal to the sent ones, PUCCH F1 and PRACH
     detect, and each DL grid is within DL_EVM_BOUND of the same slot
     computed on the CPU;
  3. the reference-C++ vector comparisons of tests/test_reference_parity.py,
     run on the card at each test's own tolerance;
  4. the CUDA LDPC decoder against the XLA decoder and the reference vectors
     at real widths (the `gpu` tests of tests/test_ldpc_cuda.py);
  5. memory analysis of the compiled north-star PUSCH program.
A failed phase makes the script exit non-zero before the result line.

--four-cards runs only `__graft_entry__.multidevice_path` (2 cells x 2 sp:
UL with the overlap-save halo exchange, the codeblock-sharded early-stop
decode, the batched multi-cell DL) on four cards and on one card, and
compares them: TB and codeblock bits equal, DL grids within DL_EVM_BOUND.

The last line of standard output is the result:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: DL grids are stored as bfloat16 real pairs (8 significant bits), so one
#: float32 rounding difference between two backends can flip the last bit
#: of an RE: 2^-8 of its magnitude at most.  The bound is the RMS error over
#: the grid relative to its RMS, a few times that worst single flip.
DL_EVM_BOUND = 1e-2
SNR_DB = 34.0


class PhaseFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return "; ".join(line.strip() for line in res.stdout.splitlines() if line.strip())


def phase_device(nof_cards: int) -> str:
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX platform is {devs[0].platform!r}, not 'gpu': no card to test")
    check(len(devs) >= nof_cards, f"{len(devs)} cards, {nof_cards} needed")
    return (f"device: {devs} kind={devs[0].device_kind!r} jax={jax.__version__}"
            f" nvidia-smi: {card_line()}")


def dl_evm(got, ref) -> float:
    got = np.asarray(got, np.complex64)
    ref = np.asarray(ref, np.complex64)
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


def phase_slots(prof, nof_slots: int, reference_device) -> str:
    """`nof_slots` north-star slots through UpperPhy on the default device;
    the DL slots again on `reference_device` for the grid comparison."""
    import jax

    from apps import northstar as ns
    from srsran_projectvtlmo_tpu.fapi.pdus import (
        CrcIndication, RachIndication, RxDataIndication, UciIndication)
    from srsran_projectvtlmo_tpu.phy.rx_symbol_handler import RxSymbolHandler
    from srsran_projectvtlmo_tpu.phy.upper_phy import UpperPhy

    cell = prof.cell
    phy = UpperPhy(cell)
    handler = RxSymbolHandler(cell.nof_rx_ports, cell.nof_subc)
    rng = np.random.default_rng(0)
    dl_sent, dl_grids = [], []
    nof_prach = 0
    t0 = time.perf_counter()
    for count in range(nof_slots):
        slot = count % ns.PERIOD
        req = ns.dl_request(prof, slot)
        txd = ns.dl_tx_data(prof, req, rng)
        grid, _ = phy.process_dl_slot(req, txd)
        dl_sent.append((req, txd))
        dl_grids.append(grid)

        tb, full, samples = ns.ul_slot(prof, slot, rng, SNR_DB)
        prach_buf = None
        if slot == ns.PRACH_SLOT:
            nof_prach += 1
            prach_buf = ns.prach_occasion(prof, rng)
        inds = ns.process_ul_slot(phy, handler, prof, slot, full, samples, prach_buf)
        by_type = {}
        for ind in inds:
            by_type.setdefault(type(ind), []).append(ind)
        (crc,) = by_type.get(CrcIndication, [None])
        check(crc is not None and crc.tb_crc_ok, f"slot {count}: PUSCH TB CRC failed")
        (rxd,) = by_type[RxDataIndication]
        check(np.array_equal(rxd.tb_bits, tb), f"slot {count}: PUSCH TB bits differ")
        (uci,) = by_type.get(UciIndication, [None])
        check(uci is not None and uci.valid
              and np.asarray(uci.harq_bits).ravel()[:1].tolist() == [1],
              f"slot {count}: PUCCH F1 HARQ bit not detected")
        if prach_buf is not None:
            (rach,) = by_type.get(RachIndication, [None])
            found = [int(p[0]) for p in rach.preambles] if rach else []
            check(ns.PRACH_PREAMBLE in found,
                  f"slot {count}: PRACH preamble {ns.PRACH_PREAMBLE} not in {found}")
    t_run = time.perf_counter() - t0

    with jax.default_device(reference_device):
        ref_phy = UpperPhy(cell)
        evms = [dl_evm(grid, ref_phy.process_dl_slot(req, txd)[0])
                for grid, (req, txd) in zip(dl_grids, dl_sent)]
    check(max(evms) <= DL_EVM_BOUND,
          f"DL grid EVM vs {reference_device.platform} {max(evms):.3g} > {DL_EVM_BOUND}")
    pusch = prof.ue_cfg
    return (f"north-star slots: {nof_slots} DL+UL slots ({cell.nof_rb} PRB, "
            f"{cell.nof_rx_ports} ports, PUSCH {pusch.nof_rb} PRB {pusch.nof_layers} "
            f"layers {pusch.modulation.name} TBS {pusch.tbs}) in {t_run:.1f} s incl. "
            f"compilation: UL TB CRC and bits OK {nof_slots}/{nof_slots}, PUCCH F1 OK "
            f"{nof_slots}/{nof_slots}, PRACH OK {nof_prach}/{nof_prach}; DL grid EVM vs "
            f"{reference_device.platform} max {max(evms):.3g} (bound {DL_EVM_BOUND})")


def phase_pytest(title: str, args: list[str]) -> str:
    import pytest

    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:xdist",
                      "--rootdir", HERE, *args])
    check(rc == 0, f"{title}: pytest exit code {int(rc)}")
    return f"{title}: passed on the card ({time.perf_counter() - t0:.1f} s)"


def phase_memory(prof) -> str:
    import jax.numpy as jnp

    from apps import northstar as ns
    from srsran_projectvtlmo_tpu.ops import ofdm
    from srsran_projectvtlmo_tpu.phy.upper_phy import UpperPhy

    cell = prof.cell
    _, _, samples = ns.ul_slot(prof, 0, np.random.default_rng(1), SNR_DB)
    grid = ofdm.ofdm_demodulate(jnp.asarray(samples), cell.nof_subc, cell.dft_size,
                                cell.numerology, 0)
    prog, args = UpperPhy(cell).pusch_program(0, ns.pusch_pdu(prof), grid)
    mem = prog.lower(*args).compile().memory_analysis()
    check(mem is not None, "no memory analysis for the PUSCH program")
    return f"PUSCH program memory: {mem}"


def four_cards(cell=None) -> list[str]:
    """The multi-device path on 4 devices and on 1; `cell` narrows the
    north-star cell for rehearsals."""
    import jax

    from __graft_entry__ import multidevice_path
    from srsran_projectvtlmo_tpu.parallel.distributed import make_ran_mesh

    devs = jax.devices()
    ncb = 64  # divides the codeblock shards of both meshes
    t0 = time.perf_counter()
    four = multidevice_path(make_ran_mesh(2, 2, devices=devs[:4]), 2, ncb, cell)
    t4 = time.perf_counter() - t0
    one = multidevice_path(make_ran_mesh(1, 1, devices=devs[:1]), 2, ncb, cell)
    t1 = time.perf_counter() - t0 - t4
    lines = []
    for name, res in (("4 cards", four), ("1 card", one)):
        check(res["ul_ok"].all(), f"{name}: UL TB CRC failed {res['ul_ok']}")
        check(np.array_equal(res["ul_bits"], res["tb"]), f"{name}: UL TB bits differ")
        check(np.array_equal(res["cb_hard"], res["cb_info"]),
              f"{name}: CB-sharded decode bits differ")
    spans = {k: four[k] for k in four if k.startswith("devices_")}
    check(all(v == 4 for v in spans.values()), f"4 cards: a stage left the mesh: {spans}")
    check(np.array_equal(four["ul_bits"], one["ul_bits"]), "UL bits differ 4 vs 1 card")
    evm = max(dl_evm(a[..., 0] + 1j * a[..., 1], b[..., 0] + 1j * b[..., 1])
              for a, b in zip(four["dl_grids"], one["dl_grids"]))
    check(evm <= DL_EVM_BOUND, f"DL grids 4 vs 1 card EVM {evm:.3g} > {DL_EVM_BOUND}")
    lines.append(f"four cards: 2 cells x 2 sp, UL halo-exchange path TB CRC and "
                 f"bits OK per cell, CB-sharded early-stop decode of {ncb} CBs OK, "
                 f"batched north-star DL OK; devices spanned per stage {spans} "
                 f"({t4:.1f} s incl. compilation)")
    lines.append(f"one card, same cells: UL bits equal to four cards, CB bits equal, "
                 f"DL grid EVM 4 vs 1 card {evm:.3g} (bound {DL_EVM_BOUND}) "
                 f"({t1:.1f} s incl. compilation)")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path, on four cards vs one")
    ap.add_argument("--slots", type=int, default=10)
    args = ap.parse_args(argv)

    # The selected tests run in this process on the card; the CPU backend
    # stays available for the reference DL run.
    os.environ["SRSRAN_TESTS_ON_GPU"] = "1"
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, HERE)

    import jax

    try:
        print(phase_device(4 if args.four_cards else 1), flush=True)
        from srsran_projectvtlmo_tpu.utils.cache import enable_compilation_cache

        enable_compilation_cache()
        if args.four_cards:
            for line in four_cards():
                print(line, flush=True)
        else:
            from apps import northstar as ns

            prof = ns.make_profile()
            print(phase_slots(prof, args.slots, jax.devices("cpu")[0]), flush=True)
            print(phase_pytest("reference vectors", [
                os.path.join(HERE, "tests", "test_reference_parity.py")]), flush=True)
            print(phase_pytest("LDPC kernel parity", [
                "-m", "gpu", os.path.join(HERE, "tests", "test_ldpc_cuda.py")]), flush=True)
            print(phase_memory(prof), flush=True)
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
