#!/usr/bin/env python3
"""Per-stage device timing of the north-star PUSCH pipeline (273 PRB QAM256,
4 rx ports, 2 layers, batch B). Each stage is jitted separately so the cost
split is visible; the fused pipeline overlaps some of these."""
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

from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig
from srsran_projectvtlmo_tpu.ran.modulation import Modulation


def timeit(name, fn, *args, reps=10):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    print(f"{name:34s} {dt*1e3:8.2f} ms", flush=True)
    return dt


def main():
    b = int(os.environ.get("B", "8"))
    nports, nlayers = 4, 2
    cfg = PuschRxConfig(nof_rb=273, modulation=Modulation.QAM256,
                        target_code_rate=948.0 / 1024.0,
                        nof_rx_ports=nports, nof_layers=nlayers,
                        dft_size=4096, numerology=1)
    seg = cfg.segmentation
    c, z = seg.nof_cb, seg.lifting_size
    qm = 8
    plan, info = cfg.demux_plan()
    es = cfg.cb_rate_match_sizes(info.nof_ul_sch_bits)
    print(f"B={b} C={c} Z={z} E0={es[0]}", flush=True)
    rng = np.random.default_rng(0)

    # --- channel estimation (per (layer, port)) ------------------------------
    from srsran_projectvtlmo_tpu.ops.channel_estimate import estimate_channel_hop
    npil_half = 3 * cfg.nof_rb
    despread_pair = jnp.asarray(
        rng.normal(size=(nlayers, nports, b, 1, npil_half, 2)).astype(np.float32))
    ones = jnp.stack([jnp.ones((1, npil_half)), jnp.zeros((1, npil_half))], -1)
    epochs = (0.0005,)

    @jax.jit
    def est_all(g):
        f = lambda x: estimate_channel_hop(x, ones, cfg.nof_rb, 4, cfg.scs_hz, epochs)
        return jax.vmap(jax.vmap(jax.vmap(f, in_axes=0), in_axes=1, out_axes=0),
                        in_axes=0, out_axes=0)(g)

    timeit("channel_estimate (L*P*B hops)", est_all, despread_pair)

    # --- equalizer ------------------------------------------------------------
    from srsran_projectvtlmo_tpu.ops.equalization import mmse_weights, apply_weights
    s = cfg.nof_subc
    h = jnp.asarray(rng.normal(size=(b, s, nports, nlayers, 2)).astype(np.float32))
    nv = jnp.asarray(np.abs(rng.normal(size=(b, nports))).astype(np.float32) + 0.01)
    y = jnp.asarray(rng.normal(size=(b, 13, s, nports, 2)).astype(np.float32))

    @jax.jit
    def eq(h, nv, y):
        w, pv = mmse_weights(h, nv)
        return apply_weights(w, y), pv

    timeit("mmse weights+apply", eq, h, nv, y)

    # --- soft demap -----------------------------------------------------------
    from srsran_projectvtlmo_tpu.ops.demodulation import soft_demap
    nre = cfg.nof_data_re * nlayers
    eqs = jnp.asarray(rng.normal(size=(b, nre, 2)).astype(np.float32))
    eqnv = jnp.asarray(np.abs(rng.normal(size=(b, nre)).astype(np.float32)) + 0.1)
    dm = jax.jit(lambda a, n: soft_demap(a, n, cfg.modulation))
    timeit("soft_demap", dm, eqs, eqnv)

    # --- descramble + sch gather ----------------------------------------------
    g_sch = len(plan.sch_bit_idx)
    llr = jnp.asarray(rng.integers(-100, 100, (b, nre * qm)).astype(np.int8))
    signs = jnp.asarray(rng.integers(0, 2, nre * qm).astype(np.int32) * 2 - 1)
    idx = jnp.asarray(plan.sch_bit_idx)

    @jax.jit
    def descr(llr):
        x = jnp.clip(llr.astype(jnp.int32) * signs[None], -127, 127).astype(jnp.int8)
        return x[:, idx]

    timeit("descramble+sch gather", descr, llr)

    # --- rate dematch -----------------------------------------------------------
    from srsran_projectvtlmo_tpu.ops.ldpc import rate_matching as rm
    sch_llr = jnp.asarray(rng.integers(-100, 100, (b, g_sch)).astype(np.int8))
    offsets = np.concatenate([[0], np.cumsum(es)]).astype(int)

    @jax.jit
    def dematch(sch_llr):
        groups = {}
        for j in range(c):
            groups.setdefault(int(es[j]), []).append(j)
        bufs = [None] * c
        for e_val, js in groups.items():
            cb_llr = jnp.stack([sch_llr[:, offsets[j]:offsets[j + 1]] for j in js], 1)
            out = rm.rate_dematch(cb_llr, seg.base_graph, z,
                                  seg.nof_filler_bits_per_cb, cfg.rv, e_val, qm)
            for i, j in enumerate(js):
                bufs[j] = out[:, i]
        return jnp.stack(bufs, 1)

    soft = timeit("rate_dematch", dematch, sch_llr)
    soft_arr = jax.block_until_ready(dematch(sch_llr))

    # --- LDPC decode ------------------------------------------------------------
    from srsran_projectvtlmo_tpu.ops.ldpc.select import es_decoder, select_es_decoder
    flat = soft_arr.reshape(b * c, -1)
    kp = seg.nof_payload_bits_per_cb
    for it in (2, 6):
        timeit(f"ldpc_decode_es ({select_es_decoder()}) max{it}",
               lambda x, i=it: es_decoder()(x, seg.base_graph, z, "CRC24B", kp,
                                            nof_iterations=i)[0], flat, reps=5)

    # --- CRC check ---------------------------------------------------------------
    from srsran_projectvtlmo_tpu.ops.crc import crc_check_device
    bits = jnp.asarray(rng.integers(0, 2, (b, c, kp)).astype(np.uint8))
    timeit("crc24b check", jax.jit(lambda x: crc_check_device(x, "CRC24B")), bits)

    # --- OFDM demod (4 ports) ------------------------------------------------------
    from srsran_projectvtlmo_tpu.ops import ofdm as ofdm_mod
    nsamp = 14 * cfg.dft_size + int(np.sum(ofdm_mod.cp_lengths(cfg.dft_size, 1, 0)))
    samp = jnp.asarray(rng.normal(size=(b, nports, nsamp, 2)).astype(np.float32))
    timeit("ofdm_demod 4port", jax.jit(lambda x: ofdm_mod.ofdm_demodulate(
        x, cfg.nof_subc, cfg.dft_size, 1, 0)), samp)


if __name__ == "__main__":
    main()
