#!/usr/bin/env python3
"""DL slot assembly benchmark: fused device program for the north-star DL
slot — 4 ports, 2-layer 273-PRB QAM256 PDSCH with precoding + PDCCH + SSB +
CSI-RS — measuring aggregate slot rate and device-time breakdown.

Mirrors the reference's pdsch_processor_benchmark scope plus the grid mapper
(reference: tests/benchmarks/phy/upper/channel_processors/
pdsch_processor_benchmark.cpp).
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(HERE, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

import numpy as np
import jax.numpy as jnp

from srsran_projectvtlmo_tpu.utils.cache import enable_compilation_cache
enable_compilation_cache()

from srsran_projectvtlmo_tpu.fapi.pdus import (
    DlTtiRequest, TxDataRequest, PdschPdu, PdcchPdu, SsbPdu, CsiRsPdu,
)
from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig, UpperPhy
from srsran_projectvtlmo_tpu.phy.dl_slot import get_dl_slot_program
from srsran_projectvtlmo_tpu.ran.modulation import Modulation


def main():
    rounds = int(os.environ.get("ROUNDS", "20"))
    cell = CellConfig(nof_rb=273, dft_size=4096, numerology=1, nof_tx_ports=4)
    phy = UpperPhy(cell)
    w = np.exp(-2j * np.pi * np.outer(np.arange(4), np.arange(2)) / 4) / 2.0
    prec = tuple(tuple((float(c.real), float(c.imag)) for c in row) for row in w)
    req = DlTtiRequest(
        slot=2,
        ssb=(SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=0,
                    half_radio_frame=False),),
        pdcch=(PdcchPdu(rnti=0x4601, nof_dci_bits=40, aggregation_level=4,
                        cce_index=0, start_symbol=1, n_id=1, n_rnti=0x4601,
                        coreset_nof_rb=48, interleaved=True),),
        pdsch=(PdschPdu(rnti=0x4601, rb_start=0, rb_size=273,
                        modulation=Modulation.QAM256,
                        target_code_rate=948 / 1024, nof_layers=2,
                        start_symbol=2, nof_symbols=12, dmrs_symbols=(2,),
                        precoding=prec),),
        csi_rs=(CsiRsPdu(nof_rb=273, symbol=13, subcarrier_offset=3),),
    )
    program = get_dl_slot_program(req, cell)
    tbs = program.pdsch_cfgs[0].tbs
    rng = np.random.default_rng(0)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    tx_data = TxDataRequest(slot=2, tb_bits=[tb])
    print(f"DL slot: TBS={tbs} ports=4 layers=2", flush=True)

    t0 = time.perf_counter()
    grid, samples = phy.process_dl_slot(req, tx_data)
    print(f"first slot (compile): {time.perf_counter()-t0:.1f}s", flush=True)
    assert grid.shape == (4, 14, cell.nof_subc)

    # Pipelined throughput through the full host+device path, including
    # the ~10 MB grid+samples readback; the device-bound number below
    # excludes it.
    t0 = time.perf_counter()
    for _ in range(rounds):
        grid, samples = phy.process_dl_slot(req, tx_data, validate=False)
    dt = time.perf_counter() - t0
    print(f"dl_slot_rate_273prb_4port_2layer: {rounds/dt:.1f} slots/s "
          f"({dt/rounds*1e3:.2f} ms/slot incl host + readback)", flush=True)

    # Device-bound rate: op-profile rawTime of the fused slot program
    # (assembly + encode + precode + OFDM), values fed through the cached
    # dynamic-input path exactly as production does.
    import json
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from device_time import profile_device

    tb_j = jnp.asarray(tb)
    from srsran_projectvtlmo_tpu.phy.dl_slot import build_dl_slot_inputs

    _vals0 = build_dl_slot_inputs(program, req, tx_data, 2)

    def step(tb_dev):
        _, s = program.run(2, (tb_dev,), *_vals0[1:],
                           pdsch_pdus=tuple(req.pdsch))
        return s

    dev_s, tops = profile_device(step, tb_j, reps=5)
    print(json.dumps({
        "metric": "dl_slot_device_bound_rate_273prb_4port_2layer",
        "value": round(1.0 / dev_s, 1), "unit": "slots/s (op-profile)",
        "vs_baseline": round(1.0 / dev_s / 2000.0, 4)}), flush=True)
    for frac, name in tops[:6]:
        print(f"  {100*frac:6.2f}% {name[:80]}", flush=True)

    # Batched slot assembly (the multi-cell production shape: cells/slots on
    # the leading axis of ONE program) — per-op overheads amortize; this is
    # the deployment-relevant DL number for the multi-cell du_low.
    batch = int(os.environ.get("DL_BATCH", "8"))
    vals = _vals0
    args_one = program._value_args(2, *vals, tuple(req.pdsch),
                                   tuple(req.pdcch), tuple(req.ssb))
    stacked = program.stack_values([args_one] * batch)
    dev_b, tops_b = profile_device(
        lambda st: program.run_stacked(2, st)[1], stacked, reps=3)
    rate_b = batch / dev_b
    print(json.dumps({
        "metric": f"dl_slot_device_bound_rate_batched{batch}_273prb_4port_2layer",
        "value": round(rate_b, 1),
        "unit": f"slots/s (op-profile, batch {batch})",
        "vs_baseline": round(rate_b / 2000.0, 4)}), flush=True)
    for frac, name in tops_b[:6]:
        print(f"  {100*frac:6.2f}% {name[:80]}", flush=True)


if __name__ == "__main__":
    main()
