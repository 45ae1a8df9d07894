#!/usr/bin/env python3
"""Cumulative-prefix timing of the honest 4-port/2-layer PUSCH pipeline:
rebuilds the pusch_rx stages inline and times P1..P5 jitted prefixes, so each
stage's in-fused marginal cost is (P_k - P_{k-1}).  P5 adds the early-stop
LDPC decoder that `ops.ldpc.select` picks for the platform."""
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
from srsran_projectvtlmo_tpu.ran.modulation import Modulation, bits_per_symbol
from srsran_projectvtlmo_tpu.ops import prg as prg_mod
from srsran_projectvtlmo_tpu.ops.channel_estimate import estimate_channel_hop
from srsran_projectvtlmo_tpu.ops.equalization import mmse_weights, apply_weights
from srsran_projectvtlmo_tpu.ops.demodulation import soft_demap
from srsran_projectvtlmo_tpu.ops.ldpc import rate_matching as rm
from srsran_projectvtlmo_tpu.utils.cplx import to_cplx, from_cplx


def timeit(name, fn, *args, reps=10):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    dt = (time.perf_counter() - t0) / reps
    print(f"{name:30s} {dt*1e3:8.2f} ms", flush=True)
    return dt


def main():
    b = int(os.environ.get("B", "8"))
    cfg = PuschRxConfig(nof_rb=273, modulation=Modulation.QAM256,
                        target_code_rate=948.0 / 1024.0,
                        nof_rx_ports=4, nof_layers=2,
                        dft_size=4096, numerology=1)
    seg = cfg.segmentation
    qm = bits_per_symbol(cfg.modulation)
    plan, info = cfg.demux_plan()
    es = cfg.cb_rate_match_sizes(info.nof_ul_sch_bits)
    c, z = seg.nof_cb, seg.lifting_size
    offsets = np.concatenate([[0], np.cumsum(es)]).astype(int)
    nlayers, nre = cfg.nof_layers, cfg.nof_data_re
    data_syms = np.asarray(cfg.data_symbols, np.int32)
    dmrs_syms = np.asarray(cfg.dmrs_symbols, np.int32)
    pil_subc = (2 * np.arange(6 * cfg.nof_rb)).astype(np.int32)
    from srsran_projectvtlmo_tpu.ops.dmrs import dmrs_type1_sequence
    ref = np.stack([dmrs_type1_sequence(0, 2, cfg.n_id, cfg.nof_rb)])
    descr_signs = 1 - 2 * prg_mod.gold_sequence_bits(
        cfg.scrambling_cinit(), cfg.nof_codeword_bits).astype(np.int32)
    epochs = cfg.symbol_epochs_s()
    dmrs_epochs = tuple(epochs[cfg.start_symbol + int(s)] for s in cfg.dmrs_symbols)

    rng = np.random.default_rng(0)
    grid = jnp.asarray(rng.normal(size=(b, 4, 14, cfg.nof_subc, 2)).astype(np.float32))

    def est(grid):
        rx_pilots = grid[:, :, dmrs_syms][:, :, :, pil_subc, :]
        yp = to_cplx(rx_pilots)
        ref_c = jnp.asarray(ref)
        lse = yp * jnp.conj(ref_c)[None, None]
        pairs = lse.reshape(lse.shape[:-1] + (lse.shape[-1] // 2, 2))
        despread = jnp.stack(
            [pairs.mean(-1), (pairs[..., 0] - pairs[..., 1]) * 0.5], axis=0)
        despread_pair = from_cplx(despread)
        ones = jnp.stack([jnp.ones_like(despread[0].real),
                          jnp.zeros_like(despread[0].real)], -1)

        def est_layer_port(g):
            return estimate_channel_hop(g, ones[0, 0], cfg.nof_rb, 4,
                                        cfg.scs_hz, dmrs_epochs)

        e = jax.vmap(jax.vmap(est_layer_port, in_axes=1, out_axes=0),
                     in_axes=0, out_axes=0)(despread_pair)
        return e

    def eq(grid):
        e = est(grid)
        ce = e["ce_pair"]
        noise = jnp.mean(e["noise_var"], axis=0)
        h_sub = jnp.transpose(ce, (2, 3, 1, 0, 4))
        nvar_port = jnp.transpose(noise, (1, 0))
        w, nv = mmse_weights(h_sub, nvar_port)
        data = grid[:, :, data_syms]
        y = jnp.transpose(data, (0, 2, 3, 1, 4))
        eqs = apply_weights(w, y)
        eq_nvar = jnp.broadcast_to(
            nv[:, None], (b, len(data_syms), cfg.nof_subc, nlayers))
        return eqs, eq_nvar

    def demap(grid):
        eqs, eq_nvar = eq(grid)
        llr = soft_demap(eqs.reshape(b, nre * nlayers, 2),
                         eq_nvar.reshape(b, nre * nlayers), cfg.modulation)
        return llr

    def dematch(grid):
        llr = demap(grid)
        llr = (llr.astype(jnp.int32) * jnp.asarray(descr_signs)[None, :])
        llr = jnp.clip(llr, -127, 127).astype(jnp.int8)
        groups = {}
        for j in range(c):
            groups.setdefault(int(es[j]), []).append(j)
        bufs = [None] * c
        for e_val, js in groups.items():
            cb_llr = jnp.stack([llr[:, offsets[j]:offsets[j + 1]] for j in js], 1)
            out = rm.rate_dematch(cb_llr, seg.base_graph, z,
                                  seg.nof_filler_bits_per_cb, cfg.rv, e_val, qm)
            for i, j in enumerate(js):
                bufs[j] = out[:, i]
        return jnp.stack(bufs, 1)

    def full(grid, iters):
        soft = dematch(grid)
        from srsran_projectvtlmo_tpu.ops.ldpc.select import es_decoder

        hard, *_ = es_decoder()(soft.reshape(b * c, -1), seg.base_graph, z,
                                "CRC24B", seg.nof_payload_bits_per_cb,
                                nof_iterations=iters)
        return hard

    timeit("P1 estimate", jax.jit(est), grid)
    timeit("P2 +mmse", jax.jit(eq), grid)
    timeit("P3 +demap", jax.jit(demap), grid)
    timeit("P4 +descr+dematch", jax.jit(dematch), grid)
    for it in (2, 6):
        timeit(f"P5 full {it}it", jax.jit(lambda g, i=it: full(g, i)), grid, reps=5)


if __name__ == "__main__":
    main()
