#!/usr/bin/env python3
"""Multi-cell north-star scaling benchmark (BASELINE config 5).

Runs `MultiCellUpperPhy` with N cells of the 273-PRB QAM256 4-port 2-layer
PUSCH config as ONE sharded program over the available device mesh and
reports aggregate slot rate + scaling efficiency vs N=1.

On one GPU all cells batch on one device (the multi-cell aggregate the
2000 slots/s bound speaks about); under the CPU test harness the cells
shard over the 8 virtual devices (correctness/scaling-shape validation — the
8 virtual devices share the host's physical cores, so wall-clock efficiency
is bounded by the core count, not the mesh).

reference: lib/du_low/du_low_impl.h:31-48 (one upper_phy per cell),
tests/benchmarks/phy/upper/channel_processors/pusch/pusch_processor_benchmark.cpp.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(HERE, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

import numpy as np


def main():
    import jax
    from srsran_projectvtlmo_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax.numpy as jnp
    from srsran_projectvtlmo_tpu.fapi.pdus import UlTtiRequest, PuschPdu
    from srsran_projectvtlmo_tpu.parallel.distributed import make_ran_mesh
    from srsran_projectvtlmo_tpu.parallel.multi_cell_phy import MultiCellUpperPhy
    from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation
    from srsran_projectvtlmo_tpu.ops import ofdm as ofdm_mod

    ndev = len(jax.devices())
    platform = jax.devices()[0].platform
    rounds = int(os.environ.get("ROUNDS", "2" if platform == "cpu" else "6"))
    cells_list = [int(x) for x in
                  os.environ.get("CELLS", "1,2,4").split(",")]

    cell = CellConfig(nof_rb=273, dft_size=4096, numerology=1,
                      nof_tx_ports=4, nof_rx_ports=4)
    nsamp = ofdm_mod.slot_sample_count(cell.dft_size, cell.numerology, 0)
    rng = np.random.default_rng(0)

    def pdu(c):
        return PuschPdu(rnti=0x4601 + c, rb_start=0, rb_size=273,
                        modulation=Modulation.QAM256,
                        target_code_rate=948 / 1024, nof_layers=2,
                        n_id=c + 1, dmrs_symbols=(2,))

    base_rate = None
    rows = []
    for n in cells_list:
        shards = min(n, ndev)
        rmesh = make_ran_mesh(nof_cell_shards=shards,
                              nof_sp_shards=ndev // shards)
        phy = MultiCellUpperPhy(cell, n, rmesh)
        samples = rng.normal(size=(n, 4, nsamp, 2)).astype(np.float32) * 0.3
        reqs = [UlTtiRequest(slot=0, pusch=(pdu(c),)) for c in range(n)]

        t0 = time.perf_counter()
        phy.process_ul_slot(reqs, samples)  # compile + run
        compile_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        for r in range(rounds):
            phy.process_ul_slot(
                [UlTtiRequest(slot=r % 2, pusch=(pdu(c),)) for c in range(n)],
                samples)
        dt = time.perf_counter() - t0
        rate = n * rounds / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * n)
        rows.append((n, shards, rate, eff))
        print(json.dumps({
            "metric": f"multi_cell_pusch_aggregate_rate_{n}cell",
            "value": round(rate, 2),
            "unit": f"slots/s ({platform}, {shards} cell shards, incl "
                    f"host dispatch/readback)",
            "vs_baseline": round(rate / 2000.0, 4)}), flush=True)
        print(f"  N={n}: compile+first {compile_s:.1f}s, "
              f"{rate:.2f} slots/s aggregate, per-cell eff {eff:.2f}",
              flush=True)

    print("\nscaling table (per-cell efficiency vs N=1):")
    print("| cells | shards | aggregate slots/s | efficiency |")
    print("|---|---|---|---|")
    for n, s, r, e in rows:
        print(f"| {n} | {s} | {r:.2f} | {e:.2f} |")


if __name__ == "__main__":
    main()
