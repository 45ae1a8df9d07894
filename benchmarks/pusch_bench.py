#!/usr/bin/env python3
"""PUSCH processor slot-rate benchmark (the reference's
tests/benchmarks/phy/upper/channel_processors/pusch/pusch_processor_benchmark.cpp,
incl. its scs30_100MHz_256qam north-star profile) and a PDSCH Tx counterpart
(pdsch_processor_benchmark.cpp).

  python benchmarks/pusch_bench.py [--profile north_star|20mhz] [--batch 4]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

PROFILES = {
    # reference profile scs30_100MHz_256qam (273 PRB, QAM256, R~0.92)
    "north_star": dict(nof_rb=273, dft_size=4096, mod="QAM256", rate=0.92),
    "20mhz": dict(nof_rb=52, dft_size=1024, mod="QAM64", rate=0.66),
    "small": dict(nof_rb=24, dft_size=512, mod="QAM16", rate=0.5),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="north_star", choices=sorted(PROFILES))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--decoder", default=None, choices=["cuda", "xla"],
                    help="early-stop LDPC decoder (default: by platform)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from srsran_projectvtlmo_tpu.models import (
        build_pusch_rx_slot, build_ulsch_tx_slot, build_pdsch_tx_slot)
    from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig
    from srsran_projectvtlmo_tpu.models.pdsch_tx import PdschTxConfig
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation

    p = PROFILES[args.profile]
    mod = Modulation[p["mod"]]
    print(f"backend: {jax.devices()[0]}  profile: {args.profile}  batch: {args.batch}")

    cfg = PuschRxConfig(nof_rb=p["nof_rb"], modulation=mod,
                        target_code_rate=p["rate"], nof_rx_ports=1,
                        dft_size=p["dft_size"], numerology=1,
                        ldpc_decoder=args.decoder)
    tx = build_ulsch_tx_slot(cfg)
    rx = build_pusch_rx_slot(cfg)
    rng = np.random.default_rng(0)
    tb = rng.integers(0, 2, (args.batch, cfg.tbs)).astype(np.uint8)
    _, samples = tx(jnp.asarray(tb))
    samples = jax.block_until_ready(samples)[:, None]
    out = rx(samples)
    assert np.asarray(out["tb_crc_ok"]).all()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        out = rx(samples)
    _ = np.asarray(out["tb_crc_ok"])
    rate = args.batch * args.reps / (time.perf_counter() - t0)
    print(f"pusch rx {p['nof_rb']} PRB {p['mod']}: {rate:10.1f} slots/s "
          f"(TBS {cfg.tbs}, {rate * cfg.tbs / 1e6:.0f} Mbps)")

    dcfg = PdschTxConfig(nof_rb=p["nof_rb"], modulation=mod,
                         target_code_rate=p["rate"], dft_size=p["dft_size"],
                         numerology=1)
    dtx = build_pdsch_tx_slot(dcfg)
    dtb = rng.integers(0, 2, (args.batch, dcfg.tbs)).astype(np.uint8)
    g, s = dtx(jnp.asarray(dtb))
    jax.block_until_ready(s)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        g, s = dtx(jnp.asarray(dtb))
    jax.block_until_ready(s)
    rate = args.batch * args.reps / (time.perf_counter() - t0)
    print(f"pdsch tx {p['nof_rb']} PRB {p['mod']}: {rate:10.1f} slots/s "
          f"(TBS {dcfg.tbs}, {rate * dcfg.tbs / 1e6:.0f} Mbps)")


if __name__ == "__main__":
    main()
