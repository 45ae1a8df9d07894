#!/usr/bin/env python3
"""Multi-host smoke test: TWO local processes through jax.distributed run the
sharded multi-cell PUSCH slot program and must produce results identical to a
single-process run (SURVEY Section 5.8).

Each process owns 2 virtual CPU devices; the global (cell=2 x sp=2) mesh puts
one cell per PROCESS (the cell axis) and the sample/sp axis inside each
process.  Run with no arguments: the parent computes the single-process
reference, spawns both workers, and diffs their reported results.
"""

import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker(out_path: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from srsran_projectvtlmo_tpu.parallel.distributed import (
        maybe_initialize_distributed, make_ran_mesh)

    assert maybe_initialize_distributed(), "distributed env not set"
    assert jax.process_count() == 2
    result = _run_slot(make_ran_mesh(nof_cell_shards=2, nof_sp_shards=2))
    if jax.process_index() == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)


def _run_slot(rmesh):
    """The sharded north-star-shaped slot (scaled down): returns per-cell
    CRC + TB checksums (fully replicated outputs, identical on every host)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from srsran_projectvtlmo_tpu.models.pusch_rx import (
        PuschRxConfig, build_pusch_rx_from_grid, flatten_tb_bits)
    from srsran_projectvtlmo_tpu.models.ulsch_tx import build_ulsch_tx_slot
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation

    n_cell = 2
    cfg = PuschRxConfig(nof_rb=12, modulation=Modulation.QAM16,
                        target_code_rate=0.5, nof_rx_ports=1, dft_size=256,
                        numerology=1, dmrs_symbols=(2,))
    tx = build_ulsch_tx_slot(cfg)
    rx = build_pusch_rx_from_grid(cfg)
    rng = np.random.default_rng(11)
    tb = rng.integers(0, 2, (n_cell, cfg.tbs)).astype(np.uint8)
    noise = rng.normal(size=(n_cell, 1, 14, cfg.nof_subc, 2)).astype(np.float32)

    mesh = rmesh.mesh
    with mesh:
        tb_dev = jax.device_put(jnp.asarray(tb),
                                NamedSharding(mesh, P("cell", None)))
        grid, _ = tx(tb_dev)  # (n_cell, 14, nsubc, 2)
        g = grid[:, None] + 0.01 * jax.device_put(
            jnp.asarray(noise),
            NamedSharding(mesh, P("cell", None, None, None, None)))
        out = rx(g)
        jax.block_until_ready(out["tb_crc_ok"])
        if jax.process_count() > 1:
            # Cell shards live on different PROCESSES: gather them onto every
            # host before reading (a plain fetch of a cross-process array is
            # illegal by design).
            from jax.experimental import multihost_utils as mhu

            ok = np.asarray(mhu.process_allgather(
                out["tb_crc_ok"], tiled=True))
            bits_cb = np.asarray(mhu.process_allgather(
                out["tb_bits_cb"], tiled=True))
        else:
            ok = np.asarray(out["tb_crc_ok"])
            bits_cb = np.asarray(out["tb_bits_cb"])
        bits = flatten_tb_bits(bits_cb, cfg.tbs)
    return {"crc": [bool(x) for x in ok],
            "tb_sha": [int(b.astype(np.int64).sum()) for b in bits],
            "match_tx": [bool((bits[c] == tb[c]).all()) for c in range(n_cell)]}


def main() -> int:
    if os.environ.get("MULTIHOST_WORKER"):
        worker(os.environ["MULTIHOST_OUT"])
        return 0

    # Single-process reference on 4 virtual devices.
    env_base = dict(os.environ)
    env_base["JAX_PLATFORMS"] = "cpu"
    env_base["XLA_FLAGS"] = (env_base.get("XLA_FLAGS", "")
                             + " --xla_force_host_platform_device_count=4").strip()
    ref_out = "/tmp/multihost_ref.json"
    code = (
        "import sys, json; sys.path.insert(0, %r);"
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        "from tools.multihost_smoke import _run_slot;"
        "from srsran_projectvtlmo_tpu.parallel.distributed import make_ran_mesh;"
        "json.dump(_run_slot(make_ran_mesh(nof_cell_shards=2, nof_sp_shards=2)),"
        " open(%r, 'w'))" % (HERE, ref_out))
    subprocess.run([sys.executable, "-c", code], env=env_base, check=True,
                   timeout=420)
    ref = json.load(open(ref_out))
    print("single-process:", ref, flush=True)

    port = _free_port()
    out_path = "/tmp/multihost_p0.json"
    procs = []
    for pid in range(2):
        env = dict(env_base)
        env["XLA_FLAGS"] = (dict(os.environ).get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=2").strip()
        env.update({
            "MULTIHOST_WORKER": "1",
            "MULTIHOST_OUT": out_path,
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
        })
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__)],
                                      env=env))
    for p in procs:
        p.wait(timeout=420)
        assert p.returncode == 0, f"worker exited {p.returncode}"
    got = json.load(open(out_path))
    print("two-process:  ", got, flush=True)
    assert got == ref, f"multi-process result differs: {got} vs {ref}"
    print("MULTIHOST SMOKE OK: 2-process sharded slot == single-process")
    return 0


if __name__ == "__main__":
    sys.exit(main())
