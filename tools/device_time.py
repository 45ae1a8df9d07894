#!/usr/bin/env python3
"""Device busy time of a jitted call, read from a jax.profiler trace.

`profile_device(fn, *args, reps=3)` runs fn(*args) `reps` times under the
profiler and returns (busy seconds per call, [(share, kernel name), ...]):
busy is the union of the intervals in which a kernel or copy ran on the
first GPU's streams, read with `jax.profiler.ProfileData` (nothing beyond
JAX is needed).  A trace without a GPU device plane is an error.

  python tools/device_time.py   # the north-star PUSCH program, B slots
"""
import glob
import os
import shutil
import sys
import tempfile
from collections import defaultdict

import numpy as np


def _busy_ns(intervals) -> int:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profile_device(fn, *args, reps: int = 3, top: int = 12):
    import jax

    jax.block_until_ready(fn(*args))  # compile and warm up outside the trace
    tmp = tempfile.mkdtemp(prefix="jaxprof")
    try:
        with jax.profiler.trace(tmp):
            for _ in range(reps):
                jax.block_until_ready(fn(*args))
        (path,) = glob.glob(os.path.join(tmp, "plugins/profile/*/*.xplane.pb"))
        data = jax.profiler.ProfileData.from_file(path)
        planes = [p for p in data.planes if p.name.startswith("/device:GPU:0")]
        if not planes:
            raise RuntimeError("trace has no /device:GPU:0 plane: "
                               + ", ".join(p.name for p in data.planes))
        intervals, per_name = [], defaultdict(int)
        for plane in planes:
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    intervals.append((ev.start_ns, ev.end_ns))
                    per_name[ev.name] += ev.duration_ns
        busy = _busy_ns(intervals)
        total = sum(per_name.values()) or 1
        tops = sorted(((t / total, n) for n, t in per_name.items()), reverse=True)
        return busy * 1e-9 / reps, tops[:top]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax.numpy as jnp
    from srsran_projectvtlmo_tpu.models.pusch_rx import (
        PuschRxConfig, build_pusch_rx_from_grid)
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation
    from srsran_projectvtlmo_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    b = int(os.environ.get("B", "8"))
    cfg = PuschRxConfig(nof_rb=273, modulation=Modulation.QAM256,
                        target_code_rate=948.0 / 1024.0,
                        nof_rx_ports=4, nof_layers=2, dft_size=4096,
                        numerology=1, ldpc_early_stop=True,
                        nof_ldpc_iterations=int(os.environ.get("ITERS", "6")))
    rx = build_pusch_rx_from_grid(cfg)
    rng = np.random.default_rng(0)
    g = jnp.asarray(rng.normal(size=(b, 4, 14, cfg.nof_subc, 2)).astype(np.float32))
    secs, tops = profile_device(lambda x: rx(x)["tb_crc_ok"], g)
    print(f"device busy: {secs * 1e3:.3f} ms per call ({b} slots)")
    for frac, name in tops:
        print(f"  {100 * frac:6.2f}% {name[:90]}")
