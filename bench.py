#!/usr/bin/env python3
"""Benchmark driver: prints ONE JSON line {"metric", "value", "unit", "vs_baseline"}.

PRIMARY metric: the honest north-star PUSCH workload — 273 PRB, 30 kHz SCS,
QAM256 R=948/1024, **4 rx ports, 2 layers** — mirroring the reference's
`scs30_100MHz_256qam_rv0_4port_nlayer` benchmark profile
(reference: tests/benchmarks/phy/upper/channel_processors/pusch/
pusch_processor_benchmark.cpp:146-208,596: random resource-grid REs, LDPC
decoder at 2 iterations with early stop enabled — random data never converges,
so the measured path is the full 2-iteration decode, as in the reference).

The pipeline spans OFDM demod -> DM-RS estimation -> MMSE -> soft demap ->
descramble -> rate recovery -> LDPC -> CRC.  Slots batch per launch and
launches are pipelined (dispatched back to back, synced at the end), as the
reference's multi-threaded `-T` harness overlaps slots.  Each measurement
runs in its own child process, one after another; this parent never imports
JAX, so one process at a time holds the GPU.

vs_baseline: against the 2000 slots/s/cell real-time bound implied by the
reference's 100 MHz TDD 4x2 shipped config (BASELINE.md).

Secondary lines (printed first; the LAST JSON line is the headline): launch
latency, device busy time, the 1-port metric.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(HERE, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")


def child_pusch_4port(batch: int, rounds: int, iters_ldpc: int):
    import numpy as np
    import jax
    from srsran_projectvtlmo_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax.numpy as jnp
    from srsran_projectvtlmo_tpu.models.pusch_rx import (
        PuschRxConfig, build_pusch_rx_slot)
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation
    from srsran_projectvtlmo_tpu.ops import ofdm as ofdm_mod

    cfg = PuschRxConfig(nof_rb=273, modulation=Modulation.QAM256,
                        target_code_rate=948.0 / 1024.0,
                        nof_rx_ports=4, nof_layers=2, dft_size=4096,
                        numerology=1, ldpc_early_stop=True,
                        nof_ldpc_iterations=iters_ldpc)
    rx = build_pusch_rx_slot(cfg)
    rng = np.random.default_rng(0)
    # Random-RE grid, like the reference benchmark (complex normal REs).
    nsamp = ofdm_mod.slot_sample_count(cfg.dft_size, cfg.numerology, 0)
    inputs = [
        jnp.asarray(rng.normal(
            size=(batch, 4, nsamp, 2)).astype(np.float32) * 0.3)
        for _ in range(2)
    ]
    # True warmup: compile + one synced execution.
    np.asarray(rx(inputs[0])["tb_crc_ok"])
    np.asarray(rx(inputs[1])["tb_crc_ok"])

    # Latency: synced single launches (median of 5).
    lats = []
    for i in range(5):
        t0 = time.perf_counter()
        np.asarray(rx(inputs[i % 2])["tb_crc_ok"])
        lats.append(time.perf_counter() - t0)
    lat = float(np.median(lats))

    sys.path.insert(0, os.path.join(HERE, "tools"))
    from device_time import profile_device

    dev_s, _ = profile_device(lambda x: rx(x)["tb_crc_ok"], inputs[0], reps=3)
    # vs_baseline: real-time margin — the air-interface time of the batch
    # (batch x 0.5 ms slots at 30 kHz SCS) over the device time to
    # process it; >= 1.0 sustains the cell in real time.
    print(json.dumps({
        "metric": "pusch_rx_device_busy_per_launch",
        "value": round(dev_s * 1e3, 3), "unit": f"ms device busy ({batch} slots)",
        "vs_baseline": round(batch * 0.5 / max(dev_s * 1e3, 1e-9), 4)}))

    # Aggregate throughput: pipelined launches, one final sync.
    t0 = time.perf_counter()
    outs = [rx(inputs[i % 2])["tb_crc_ok"] for i in range(rounds)]
    for o in outs:
        np.asarray(o)
    rate = batch * rounds / (time.perf_counter() - t0)
    # Latency budget = max_proc_delay (3 slots) x 0.5 ms slot duration.
    print(json.dumps({
        "metric": "pusch_rx_launch_latency_273prb_qam256_4port_2layer",
        "value": round(lat * 1e3, 2), "unit": f"ms median, {batch} slots per launch",
        "vs_baseline": round(1.5 / max(lat * 1e3, 1e-9), 4)}))
    return {"metric": "pusch_rx_slot_rate_273prb_qam256_4port_2layer",
            "value": round(rate, 2), "unit": "slots/s",
            "vs_baseline": round(rate / 2000.0, 4)}


def child_pusch_1port(nrb: int, batch: int, iters: int):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from srsran_projectvtlmo_tpu.models import build_pusch_rx_slot, build_ulsch_tx_slot
    from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation

    cfg = PuschRxConfig(nof_rb=nrb, modulation=Modulation.QAM256,
                        target_code_rate=0.92, nof_rx_ports=1, dft_size=4096,
                        numerology=1)
    tx = build_ulsch_tx_slot(cfg)
    rx = build_pusch_rx_slot(cfg)
    rng = np.random.default_rng(0)
    tb = rng.integers(0, 2, (batch, cfg.tbs)).astype(np.uint8)
    _, samples = tx(jnp.asarray(tb))
    samples = jnp.asarray(np.asarray(samples))[:, None]
    ok = np.asarray(rx(samples)["tb_crc_ok"])
    assert ok.all(), f"1-port benchmark slot failed decode: {ok}"
    t0 = time.perf_counter()
    outs = [rx(samples)["tb_crc_ok"] for _ in range(iters)]
    for o in outs:
        np.asarray(o)
    rate = batch * iters / (time.perf_counter() - t0)
    return {"metric": f"pusch_rx_slot_rate_{nrb}prb_qam256_1port",
            "value": round(rate, 2), "unit": "slots/s",
            "vs_baseline": round(rate / 2000.0, 4)}


def child_ldpc(z: int, batch: int, iters_ldpc: int, reps: int):
    """Early-stop decoder throughput (the decoder `ops.ldpc.select` picks for
    this platform).  Random payloads never pass the CRC, so every codeblock
    runs the full iteration count, as in the reference benchmark
    (ldpc_decoder_benchmark.cpp)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from srsran_projectvtlmo_tpu.ran.ldpc_params import BaseGraph
    from srsran_projectvtlmo_tpu.ops.ldpc.encode import ldpc_encode
    from srsran_projectvtlmo_tpu.ops.ldpc.select import es_decoder, select_es_decoder

    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (batch, 22 * z)).astype(np.uint8)
    cw = np.asarray(ldpc_encode(jnp.asarray(info), BaseGraph.BG1, z))
    llr = jnp.asarray(((1 - 2 * cw[:, 2 * z:].astype(np.int32)) * 8).astype(np.int8))
    decode = es_decoder()

    def dec():
        return decode(llr, BaseGraph.BG1, z, "CRC24B", 22 * z,
                      nof_iterations=iters_ldpc)[0]

    assert (np.asarray(dec()) == info).all()
    t0 = time.perf_counter()
    outs = [dec() for _ in range(reps)]
    jax.block_until_ready(outs)
    mbps = batch * reps * 22 * z / (time.perf_counter() - t0) / 1e6
    return {"metric": f"ldpc_decode_bg1_z{z}_{iters_ldpc}it",
            "value": round(mbps, 1),
            "unit": f"Mbps ({select_es_decoder()} decoder, batch {batch})",
            "vs_baseline": None}


def child_pusch_6it(batch: int, iters_ldpc: int):
    """Device-bound north-star PUSCH rate with the LDPC decoder running the
    FULL iteration budget (random REs never pass CRC, so early stop cannot
    exit): evidences the real-time margin at an operating point near the
    decode threshold (~29 dB) where iterations go to 6, not at the
    34 dB/2-iteration point every other line measures (the reference sweeps
    iteration counts, ldpc_decoder_benchmark.cpp)."""
    import numpy as np
    from srsran_projectvtlmo_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax.numpy as jnp
    from srsran_projectvtlmo_tpu.models.pusch_rx import (
        PuschRxConfig, build_pusch_rx_slot)
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation
    from srsran_projectvtlmo_tpu.ops import ofdm as ofdm_mod

    sys.path.insert(0, os.path.join(HERE, "tools"))
    from device_time import profile_device

    cfg = PuschRxConfig(nof_rb=273, modulation=Modulation.QAM256,
                        target_code_rate=948.0 / 1024.0,
                        nof_rx_ports=4, nof_layers=2, dft_size=4096,
                        numerology=1, ldpc_early_stop=True,
                        nof_ldpc_iterations=iters_ldpc)
    rx = build_pusch_rx_slot(cfg)
    rng = np.random.default_rng(0)
    nsamp = ofdm_mod.slot_sample_count(cfg.dft_size, cfg.numerology, 0)
    x = jnp.asarray(rng.normal(size=(batch, 4, nsamp, 2)).astype(np.float32) * 0.3)
    dev_s, _ = profile_device(lambda a: rx(a)["tb_crc_ok"], x, reps=3)
    rate = batch / dev_s
    return {"metric": f"pusch_rx_device_bound_slot_rate_4port_2layer_{iters_ldpc}it_full",
            "value": round(rate, 1),
            "unit": f"slots/s (device busy, batch {batch}, no early-stop exit)",
            "vs_baseline": round(rate / 2000.0, 4)}


def child_latency(iters_ldpc: int):
    """Small-batch device latency of the north-star PUSCH slot against the
    max_proc_delay budget (2 slots x 0.5 ms)."""
    import numpy as np
    from srsran_projectvtlmo_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax.numpy as jnp
    from srsran_projectvtlmo_tpu.models.pusch_rx import (
        PuschRxConfig, build_pusch_rx_slot)
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation
    from srsran_projectvtlmo_tpu.ops import ofdm as ofdm_mod

    sys.path.insert(0, os.path.join(HERE, "tools"))
    from device_time import profile_device

    cfg = PuschRxConfig(nof_rb=273, modulation=Modulation.QAM256,
                        target_code_rate=948.0 / 1024.0,
                        nof_rx_ports=4, nof_layers=2, dft_size=4096,
                        numerology=1, ldpc_early_stop=True,
                        nof_ldpc_iterations=iters_ldpc)
    rx = build_pusch_rx_slot(cfg)
    rng = np.random.default_rng(0)
    nsamp = ofdm_mod.slot_sample_count(cfg.dft_size, cfg.numerology, 0)
    result = None
    for b in (1, 4):
        x = jnp.asarray(rng.normal(size=(b, 4, nsamp, 2)).astype(np.float32) * 0.3)
        dev_s, _ = profile_device(lambda a: rx(a)["tb_crc_ok"], x, reps=5)
        line = {"metric": f"pusch_rx_device_latency_batch{b}",
                "value": round(dev_s * 1e3, 3),
                "unit": f"ms device ({b} slot{'s' if b > 1 else ''})",
                "vs_baseline": round(b * 0.5 / max(dev_s * 1e3, 1e-9), 4)}
        if result is not None:
            print(json.dumps(result))
        result = line
    return result


def child_multicell(ncells: int, iters_ldpc: int):
    """Config-5 measured on chip: N same-structure cells' DL slot assembly
    (batched program) + N cells' PUSCH decode (batched program, HARQ
    retransmission combining riding the batch) — aggregate device-bound
    cell-slots/s vs N x 2000 (reference: lib/du_low/du_low_impl.h:31-48)."""
    import numpy as np
    from srsran_projectvtlmo_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax.numpy as jnp
    from srsran_projectvtlmo_tpu.fapi.pdus import (
        DlTtiRequest, TxDataRequest, PdschPdu, PdcchPdu, SsbPdu, CsiRsPdu)
    from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig
    from srsran_projectvtlmo_tpu.phy import dl_slot as dl_mod
    from srsran_projectvtlmo_tpu.models.pusch_rx import (
        PuschRxConfig, cached_pusch_rx_from_grid)
    from srsran_projectvtlmo_tpu.ops.dmrs import dmrs_type1_sequence
    from srsran_projectvtlmo_tpu.ops import prg as prg_mod
    from srsran_projectvtlmo_tpu.ops import ofdm as ofdm_mod
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation
    from srsran_projectvtlmo_tpu.utils.cplx import np_to_pair

    sys.path.insert(0, os.path.join(HERE, "tools"))
    from device_time import profile_device

    cell = CellConfig(nof_rb=273, dft_size=4096, numerology=1,
                      nof_tx_ports=4, nof_rx_ports=4)
    rng = np.random.default_rng(0)
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
    program = dl_mod.get_dl_slot_program(req, cell)
    tbs = program.pdsch_cfgs[0].tbs
    tx_data = TxDataRequest(slot=2, tb_bits=[
        rng.integers(0, 2, tbs).astype(np.uint8)])
    vals = dl_mod.build_dl_slot_inputs(program, req, tx_data, 2)
    args_one = program._value_args(2, *vals, tuple(req.pdsch),
                                   tuple(req.pdcch), tuple(req.ssb))
    stacked = program.stack_values([args_one] * ncells)
    dl_dev, _ = profile_device(
        lambda st: program.run_stacked(2, st)[1], stacked, reps=3)
    # Emit the DL half immediately: if the UL half times out under the
    # driver's budget, this measurement still lands in the record.
    print(json.dumps({
        "metric": f"multi_cell{ncells}_dl_aggregate_cell_slot_rate",
        "value": round(ncells / dl_dev, 1),
        "unit": f"cell-slots/s device-bound ({ncells} DL cells/launch)",
        "vs_baseline": round((ncells / dl_dev) / 2000.0, 4)}), flush=True)

    # UL: the production dynamic-params batched program, retransmitting
    # cells contributing stored soft bits.
    rx_cfg = PuschRxConfig(nof_rb=273, modulation=Modulation.QAM256,
                           target_code_rate=948.0 / 1024.0, nof_rx_ports=4,
                           nof_layers=2, dft_size=4096, numerology=1,
                           dynamic_params=True,
                           nof_ldpc_iterations=iters_ldpc)
    rx = cached_pusch_rx_from_grid(rx_cfg)
    seg = rx_cfg.segmentation
    nsamp = ofdm_mod.slot_sample_count(4096, 1, 0)
    samples = jnp.asarray(
        rng.normal(size=(ncells, 4, nsamp, 2)).astype(np.float32) * 0.3)
    refs, signs = [], []
    for c in range(ncells):
        ref = np.stack([dmrs_type1_sequence(2, 2, c + 1, 273)])
        refs.append(np_to_pair(ref))
        cinit = (((0x4601 + c) << 15) + c + 1) & 0x7FFFFFFF
        signs.append(1 - 2 * prg_mod.gold_sequence_bits(
            cinit, rx_cfg.nof_codeword_bits).astype(np.int8))
    ref_in = jnp.asarray(np.stack(refs))
    signs_in = jnp.asarray(np.stack(signs))
    # Half the cells retransmit: nonzero HARQ soft history in the batch.
    harq = rng.integers(-20, 20, size=(
        ncells, seg.nof_cb, seg.nof_cw_bits_per_cb)).astype(np.int8)
    harq[: ncells // 2] = 0
    harq_in = jnp.asarray(harq)

    def ul(s):
        grid = ofdm_mod.ofdm_demodulate(s, 273 * 12, 4096, 1, 0)
        return rx(grid, harq_in, ref_in, signs_in)["tb_crc_ok"]

    import jax

    ul_j = jax.jit(ul)
    ul_dev, _ = profile_device(ul_j, samples, reps=3)

    agg = 2 * ncells / (dl_dev + ul_dev)
    # vs_baseline: mixed DL/UL cell-slots per second over ONE cell's 2000
    # slots/s real-time rate — i.e. how many 100 MHz TDD 4x2 cells this one
    # chip sustains; the multi-cell mesh scales this linearly per chip
    # (cells shard the same batch axis, parallel/multi_cell_phy.py).
    return {"metric": f"multi_cell{ncells}_dl_ul_aggregate_cell_slot_rate",
            "value": round(agg, 1),
            "unit": f"cell-slots/s device-bound ({ncells} DL + {ncells} UL "
                    f"per launch pair, HARQ retx in batch)",
            "vs_baseline": round(agg / 2000.0, 4)}


def run_child(spec: dict, budget_s: int, argv=None, name=None):
    """Run one benchmark child under a watchdog.

    Child failures are LOUD: a timeout / nonzero exit / silent child prints
    an explicit `{"metric": "<name>_failed"}` line (with the cause in
    `unit`) so the record shows WHAT failed instead of the measurement
    silently vanishing.  Metric lines the child printed before dying are
    still passed through.
    """
    env = dict(os.environ)
    env["BENCH_CHILD_SPEC"] = json.dumps(spec)
    if "env" in spec:
        env.update(spec.pop("env"))
    cmd = ([sys.executable, "-u"] + argv if argv else
           [sys.executable, "-u", os.path.abspath(__file__)])
    failure = None
    stdout, stderr = "", ""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=budget_s, env=env)
        stdout, stderr = proc.stdout or "", proc.stderr or ""
        if proc.returncode != 0:
            failure = f"child failed rc={proc.returncode}"
    except subprocess.TimeoutExpired as exc:
        def _txt(v):
            return v.decode(errors="replace") if isinstance(v, bytes) else (v or "")
        stdout, stderr = _txt(exc.stdout), _txt(exc.stderr)
        failure = f"child timeout after {budget_s}s"
    result = None
    for line in stdout.strip().splitlines():
        if not line.startswith("{"):
            continue
        try:
            parsed = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not (isinstance(parsed, dict) and "metric" in parsed and "value" in parsed):
            continue  # incidental JSON-shaped log line, not a metric
        if result is not None:
            # Earlier JSON lines are secondary metrics: pass them through
            # (the driver keeps the LAST line as the headline).
            print(json.dumps(result))
        result = parsed
    if failure is not None:
        if result is not None:
            # Partial output before dying: keep the measurements, still flag.
            print(json.dumps(result))
        tail = stderr.strip().splitlines()[-1][:160] if stderr.strip() else ""
        print(json.dumps({
            "metric": f"{name or spec.get('kind', 'child')}_failed", "value": 0,
            "unit": (failure + (": " + tail if tail else ""))[:200],
            "vs_baseline": 0}))
        return None
    if result is None and name is not None:
        print(json.dumps({"metric": f"{name}_failed", "value": 0,
                          "unit": "child exited 0 without a metric line",
                          "vs_baseline": 0}))
    return result


def main() -> None:
    spec_env = os.environ.get("BENCH_CHILD_SPEC")
    if spec_env:
        spec = json.loads(spec_env)
        kind = spec.pop("kind")
        if kind == "script":
            return  # scripts run directly, not through the child protocol
        result = {"pusch4": child_pusch_4port, "pusch1": child_pusch_1port,
                  "ldpc": child_ldpc,
                  "latency": child_latency, "pusch4_6it": child_pusch_6it,
                  "multicell": child_multicell}[kind](**spec)
        print(json.dumps(result))
        return

    batch = int(os.environ.get("BENCH_BATCH", "64"))
    rounds = int(os.environ.get("BENCH_ROUNDS", "24"))
    # Secondary metric children (each under a subprocess watchdog; a failed
    # child just skips its lines).  The DRIVER keeps the LAST JSON line as
    # the headline, so the north-star PUSCH child runs last.
    secondaries = [
        ("dl_slot_bench", {"kind": "script", "env": {"ROUNDS": "5"}}, 1500,
         [os.path.join(HERE, "benchmarks", "dl_slot_bench.py")]),
        ("multi_cell4_dl_ul_aggregate_cell_slot_rate",
         {"kind": "multicell", "ncells": 4, "iters_ldpc": 2}, 1800, None),
        ("ldpc_decode_bg1_z208_2it",
         {"kind": "ldpc", "z": 208, "batch": 512, "iters_ldpc": 2,
          "reps": 10}, 700, None),
        ("pusch_rx_device_latency", {"kind": "latency", "iters_ldpc": 2}, 700, None),
        # Worst-case decode cost: 6 full min-sum iterations on
        # non-converging codewords — the operating point ~1 dB above the
        # LDPC waterfall where early stop cannot exit.
        ("pusch_rx_6it_threshold",
         {"kind": "pusch4_6it", "batch": 32, "iters_ldpc": 6}, 900, None),
    ]
    for name, spec, budget, argv in secondaries:
        result = run_child(dict(spec), budget, argv=argv, name=name)
        if result is not None:
            print(json.dumps(result))

    # Primary: the north-star PUSCH child; the smaller ones stand in only
    # when it fails.
    attempts = [
        ({"kind": "pusch4", "batch": batch, "rounds": rounds,
          "iters_ldpc": 2}, 900),
        ({"kind": "pusch1", "nrb": 273, "batch": 16, "iters": 10}, 700),
        ({"kind": "ldpc", "z": 384, "batch": 608, "iters_ldpc": 2, "reps": 10}, 500),
    ]
    for spec, budget in attempts:
        result = run_child(dict(spec), budget, name=spec["kind"])
        if result is not None:
            print(json.dumps(result))
            return
    print(json.dumps({"metric": "bench_failed", "value": 0, "unit": "n/a",
                      "vs_baseline": 0}))


if __name__ == "__main__":
    main()
