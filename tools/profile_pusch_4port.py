#!/usr/bin/env python3
"""Profile the honest north-star PUSCH config on the device.

Config mirrors the reference benchmark profile `scs30_100MHz_256qam_rv0_4port_nlayer`
(reference: tests/benchmarks/phy/upper/channel_processors/pusch/pusch_processor_benchmark.cpp:186-196):
273 PRB, 30 kHz SCS, QAM256 R=948/1024, rv0, DM-RS type1 at symbol 2,
2 CDM groups, 4 rx ports, 2 layers.

Prints per-stage timings + end-to-end slot rate.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(HERE, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

import numpy as np
import jax
import jax.numpy as jnp

from srsran_projectvtlmo_tpu.models import build_pusch_rx_slot, build_ulsch_tx_slot
from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig, build_pusch_rx_from_grid
from srsran_projectvtlmo_tpu.models.channel import ChannelEmulator
from srsran_projectvtlmo_tpu.ran.modulation import Modulation
from srsran_projectvtlmo_tpu.ops import ofdm as ofdm_mod


def main():
    batch = int(os.environ.get("B", "8"))
    nports = int(os.environ.get("P", "4"))
    nlayers = int(os.environ.get("L", "2"))
    reps = int(os.environ.get("REPS", "10"))
    sinr_db = float(os.environ.get("SINR", "30"))
    from_grid = os.environ.get("FROM_GRID", "1") == "1"

    cfg = PuschRxConfig(nof_rb=273, modulation=Modulation.QAM256,
                        target_code_rate=948.0 / 1024.0,
                        nof_rx_ports=nports, nof_layers=nlayers,
                        dft_size=4096, numerology=1,
                        ldpc_early_stop=True)
    seg = cfg.segmentation
    print(f"TBS={cfg.tbs} nof_cb={seg.nof_cb} Z={seg.lifting_size} "
          f"ports={nports} layers={nlayers} batch={batch}", flush=True)

    tx = build_ulsch_tx_slot(cfg)
    rng = np.random.default_rng(0)
    tb = rng.integers(0, 2, (batch, cfg.tbs)).astype(np.uint8)
    t0 = time.perf_counter()
    grid_pair, _samples = tx(jnp.asarray(tb))
    grid_pair = np.asarray(jax.block_until_ready(grid_pair))
    print(f"tx done {time.perf_counter()-t0:.1f}s", flush=True)

    # Channel: per batch element, independent Rayleigh (port, layer) response.
    emu = ChannelEmulator("TDLA", sinr_db, nports, cfg.nof_subc, cfg.scs_hz, seed=1)
    if nlayers == 1:
        tx_grids = (grid_pair[..., 0] + 1j * grid_pair[..., 1])[:, None]
    else:
        tx_grids = grid_pair[..., 0] + 1j * grid_pair[..., 1]  # (B, L, nsym, nsubc)
    rx_grids = np.stack([emu.run_mimo(tx_grids[i])[0] for i in range(batch)])
    rx_pair = np.stack([rx_grids.real, rx_grids.imag], -1).astype(np.float32)
    rx_dev = jnp.asarray(rx_pair)

    if from_grid:
        rx = jax.jit(build_pusch_rx_from_grid(cfg))
    else:
        rx = build_pusch_rx_slot(cfg)
        t0 = time.perf_counter()
        samp = jax.block_until_ready(ofdm_mod.ofdm_modulate(rx_dev, cfg.dft_size, 1, 0))
        rx_dev = samp
        print(f"rx samples made {time.perf_counter()-t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    out = rx(rx_dev)
    jax.block_until_ready(out["tb_crc_ok"])
    print(f"compile+first run {time.perf_counter()-t0:.1f}s", flush=True)
    ok = np.asarray(out["tb_crc_ok"])
    iters = np.asarray(out["ldpc_iterations"])
    print(f"tb_crc_ok={ok.tolist()} mean_ldpc_iters={iters.mean():.2f}", flush=True)

    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = rx(rx_dev)
        jax.block_until_ready(out["tb_crc_ok"])
        lat.append(time.perf_counter() - t0)
    lat = np.array(lat)
    rate = batch / lat.mean()
    print(f"slot_rate={rate:.1f} slots/s  launch_mean={lat.mean()*1e3:.2f}ms "
          f"p99={np.percentile(lat, 99)*1e3:.2f}ms  per_slot={lat.mean()/batch*1e3:.3f}ms",
          flush=True)


if __name__ == "__main__":
    main()
