#!/usr/bin/env python3
"""LDPC encoder/decoder throughput benchmark (the reference's
tests/benchmarks/phy/upper/channel_coding/ldpc/*_benchmark.cpp equivalent).

Sweeps base graphs and lifting sizes, measures Mbps on the current backend
(host clock around calls that end in block_until_ready), and asserts exact
payload recovery at every size.  The decoder is the early-stop one that
`ops.ldpc.select` picks ("cuda" on a GPU, "xla" on the CPU) unless
--decoder names one; random payloads never pass the CRC, so every codeblock
runs the full --iters.

  python benchmarks/ldpc_bench.py [--decoder cuda|xla] [--batch 32] [--iters 6]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--decoder", default=None, choices=["cuda", "xla"])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--zs", default="40,64,104,128,176,208,256,352,384",
                help="lifting sizes; 'all' sweeps all 51 (reference benchmark shape)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from srsran_projectvtlmo_tpu.ran.ldpc_params import BaseGraph
    from srsran_projectvtlmo_tpu.ops.ldpc.encode import ldpc_encode
    from srsran_projectvtlmo_tpu.ops.ldpc.select import es_decoder, select_es_decoder

    decode = es_decoder(args.decoder)
    print(f"backend: {jax.devices()[0]}  decoder: {select_es_decoder(args.decoder)}"
          f"  batch: {args.batch}")
    rng = np.random.default_rng(0)
    for bg in (BaseGraph.BG1, BaseGraph.BG2):
        kb = 22 if bg == BaseGraph.BG1 else 10
        if args.zs == "all":
            from srsran_projectvtlmo_tpu.ran.ldpc_params import ALL_LIFTING_SIZES
            zs = list(ALL_LIFTING_SIZES)
        else:
            zs = [int(v) for v in args.zs.split(",")]
        for z in zs:
            k = kb * z
            info = rng.integers(0, 2, (args.batch, k)).astype(np.uint8)
            info_d = jnp.asarray(info)
            cw = ldpc_encode(info_d, bg, z)
            jax.block_until_ready(cw)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                cw = ldpc_encode(info_d, bg, z)
            jax.block_until_ready(cw)
            enc_mbps = args.batch * args.reps * k / (time.perf_counter() - t0) / 1e6

            llr = jnp.asarray(
                ((1 - 2 * np.asarray(cw)[:, 2 * z:].astype(np.int32)) * 8).astype(np.int8))

            def dec():
                return decode(llr, bg, z, "CRC24B", k, nof_iterations=args.iters)[:2]

            hard, _ = dec()
            jax.block_until_ready(hard)
            assert (np.asarray(hard) == info).all(), f"decode failed bg={bg} z={z}"
            t0 = time.perf_counter()
            for _ in range(args.reps):
                hard, _ = dec()
            jax.block_until_ready(hard)
            dec_mbps = args.batch * args.reps * k / (time.perf_counter() - t0) / 1e6
            print(f"{bg.name} z={z:4d} K={k:5d}: encode {enc_mbps:8.1f} Mbps   "
                  f"decode({args.iters}it) {dec_mbps:8.1f} Mbps")


if __name__ == "__main__":
    main()
