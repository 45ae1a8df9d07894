"""CUDA early-stop LDPC decoder (native/ldpc_decoder.cu) bound through jax.ffi.

Same contract and bit-exact results as `decode.ldpc_decode_es`.  Each thread
block holds one codeblock's soft values and check-to-variable messages in
shared memory for the whole decode (a group of codeblocks at small lifting
sizes), so the per-layer gathers and scatters of the XLA program never reach
device memory, and every codeblock stops on its own CRC pass.

The shared library is built from the repository's source with `nvcc` into
`native/build/` on first use (or ahead of time with
`python -m srsran_projectvtlmo_tpu.ops.ldpc.decode_cuda`).  There is no
fallback: a GPU run that cannot build or load it fails.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ...ran.ldpc_params import BaseGraph
from .decode import DEFAULT_ITERATIONS, DEFAULT_SCALING
from .graphs import get_graph

TARGET = "srsran_ldpc_decode_es"

_NATIVE_DIR = Path(__file__).resolve().parents[3] / "native"
_SOURCE = _NATIVE_DIR / "ldpc_decoder.cu"
_LIBRARY = _NATIVE_DIR / "build" / "libsrsran_ldpc_decoder.so"

#: Threads a block should have at least before codeblocks are grouped, and
#: the dynamic shared memory a block may take (the H100 allows 227 KB).
_MIN_THREADS = 256
_MAX_SHARED_BYTES = 200 * 1024


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA LDPC decoder cannot be built")
    return path


def build() -> Path:
    """Compile native/ldpc_decoder.cu for sm_90a unless the library is newer."""
    if _LIBRARY.exists() and _LIBRARY.stat().st_mtime >= _SOURCE.stat().st_mtime:
        return _LIBRARY
    _LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", str(tmp), str(_SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    os.replace(tmp, _LIBRARY)
    return _LIBRARY


@functools.lru_cache(maxsize=1)
def load() -> None:
    """Build (if needed) and register the FFI target for the CUDA platform."""
    lib = ctypes.cdll.LoadLibrary(str(build()))
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.SrsranLdpcDecodeEs),
                                platform="CUDA")
    # Every operand and result leads with the codeblock axis, so a sharded
    # batch decodes in place on each device.
    jax.ffi.register_ffi_target_as_batch_partitionable(TARGET)


@functools.lru_cache(maxsize=None)
def kernel_plan(bg: BaseGraph, z: int):
    """Compacted edge tables and codeblocks per thread block for (bg, z).

    Returns (row_start (M+1,), cols (E,), shifts (E,), group): the real edges
    of each layer in base-graph column order (the order decides argmin
    ties), and how many codeblocks share a block so that small lifting sizes
    still give a block of at least `_MIN_THREADS` threads.
    """
    g = get_graph(bg, z)
    real = g.row_cols >= 0
    row_start = np.concatenate([[0], np.cumsum(real.sum(1))]).astype(np.int32)
    cols = g.row_cols[real].astype(np.int32)
    shifts = g.row_shifts[real].astype(np.int32)
    per_cb = (g.n_full + len(cols)) * z
    group = max(1, min(_MIN_THREADS // z, 1024 // z, _MAX_SHARED_BYTES // per_cb, 32))
    return row_start, cols, shifts, group


def ldpc_decode_es_cuda(
    llrs,
    bg: BaseGraph,
    z: int,
    crc_name: str,
    nof_crc_covered_bits: int,
    *,
    nof_iterations: int = DEFAULT_ITERATIONS,
    scaling_factor: float = DEFAULT_SCALING,
):
    """CUDA twin of `decode.ldpc_decode_es`: (B, N) int8 rate-recovered LLRs ->
    (hard (B, K) uint8, soft_info (B, K) int8, crc_ok (B,) bool,
    nof_iterations_used (B,) int32)."""
    return _decode_es_cuda_jit(llrs, bg, z, crc_name, int(nof_crc_covered_bits),
                               nof_iterations, float(scaling_factor))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _decode_es_cuda_jit(llrs, bg: BaseGraph, z: int, crc_name: str, kp: int,
                        max_iterations: int, scaling_factor: float):
    from ..crc import POLYS

    load()
    g = get_graph(bg, z)
    row_start, cols, shifts, group = kernel_plan(bg, z)
    order, poly = POLYS[crc_name]
    b = llrs.shape[0]
    call = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((b, g.kb * z), jnp.int8),
         jax.ShapeDtypeStruct((b,), jnp.int32),
         jax.ShapeDtypeStruct((b,), jnp.int32)),
        vmap_method="expand_dims",
    )
    soft, ok, iters = call(
        llrs.astype(jnp.int8),
        z=np.int32(z), nv=np.int32(g.n_full), kb=np.int32(g.kb),
        group=np.int32(group), max_iterations=np.int32(max_iterations),
        scaling=np.float32(scaling_factor), crc_order=np.int32(order),
        crc_poly=np.int32(poly), crc_covered_bits=np.int32(kp),
        row_start=row_start, cols=cols, shifts=shifts)
    hard = (soft <= 0).astype(jnp.uint8)
    return hard, soft, ok.astype(bool), iters


if __name__ == "__main__":
    print(build())
