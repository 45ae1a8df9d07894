#!/usr/bin/env python3
"""Time the CUDA early-stop LDPC decoder against the XLA program on the GPU.

Two places: the decoder alone on a 273-PRB slot's worth of noisy codeblocks
(76, max 6 iterations) at BG1 z=384 and z=208, and the whole north-star PUSCH
program (272 PRB, 4 ports, 2 layers, QAM256 R=948/1024, 34 dB) as UpperPhy
dispatches it, at 2 and 6 maximum iterations.  Each case runs the two
decoders in the order xla, cuda, cuda, xla; each entry is the median over
`--reps` calls of the host clock around a call that ends in
block_until_ready.

  python tools/ldpc_decoder_ab.py [--reps 30]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np


def median_ms(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print("no GPU: nothing measured", file=sys.stderr)
        return 2
    from srsran_projectvtlmo_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from srsran_projectvtlmo_tpu.ops import ofdm
    from srsran_projectvtlmo_tpu.ops.ldpc.select import es_decoder
    from srsran_projectvtlmo_tpu.phy.upper_phy import ExpertPhyConfig, UpperPhy
    from srsran_projectvtlmo_tpu.ran.ldpc_params import BaseGraph
    from apps import northstar as ns
    from tests.test_ldpc_cuda import SLOT_CBS, _noisy_codewords

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; jax {jax.__version__}; {jax.devices()[0].device_kind}")
    order = ("xla", "cuda", "cuda", "xla")

    def report(case, fns):
        ms = [median_ms(fns[d], args.reps) for d in order]
        ratio = (ms[0] + ms[3]) / (ms[1] + ms[2])
        print(f"{case}: " + ", ".join(f"{d} {m:.4f} ms" for d, m in zip(order, ms))
              + f"; xla/cuda = {ratio:.2f}", flush=True)

    for bg, z in ((BaseGraph.BG1, 384), (BaseGraph.BG1, 208)):
        _, noisy, kp = _noisy_codewords(bg, z, SLOT_CBS, seed=z)
        x = jnp.asarray(noisy)
        fns = {d: (lambda dec=es_decoder(d): dec(x, bg, z, "CRC24B", kp,
                                                 nof_iterations=6))
               for d in ("xla", "cuda")}
        its = np.asarray(fns["cuda"]()[3])
        report(f"decoder alone {bg.name} z={z} {SLOT_CBS} CBs "
               f"(iterations used mean {its.mean():.2f}, max {its.max()})", fns)

    prof = ns.make_profile()
    cell = prof.cell
    rng = np.random.default_rng(0)
    tb, _, samples = ns.ul_slot(prof, 0, rng, 34.0)
    grid = ofdm.ofdm_demodulate(jnp.asarray(samples), cell.nof_subc, cell.dft_size,
                                cell.numerology, 0)
    pdu = ns.pusch_pdu(prof)
    for iters in (2, 6):
        fns = {}
        for d in ("xla", "cuda"):
            phy = UpperPhy(cell, ExpertPhyConfig(ldpc_decoder=d,
                                                 pusch_decoder_max_iterations=iters))
            prog, prog_args = phy.pusch_program(0, pdu, grid)
            out = prog(*prog_args)
            assert bool(np.asarray(out["tb_crc_ok"])[0]), f"{d}: TB CRC failed"
            used = np.asarray(out["ldpc_iterations"])
            fns[d] = (lambda p=prog, a=prog_args: p(*a)["tb_bits_cb"])
        report(f"north-star PUSCH program, max {iters} iterations "
               f"(iterations used max {used.max()})", fns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
