"""Test configuration.

By default the tests run JAX on the CPU with 8 virtual devices, so sharded
code paths are validated on a virtual mesh.  `chip_smoke.py` runs selected
tests on the GPU instead: it sets SRSRAN_TESTS_ON_GPU=1 before JAX starts,
and then this file leaves the platform alone.  Tests marked `gpu` take the
`on_gpu` fixture, which skips them when the default backend is not a GPU.
"""

import os

import pytest

ON_GPU = os.environ.get("SRSRAN_TESTS_ON_GPU") == "1"

if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu"

    # Persistent compilation cache for the CPU tier: reruns skip hundreds
    # of XLA:CPU compiles.  JAX_COMPILATION_CACHE_DIR wins when it is set.
    from srsran_projectvtlmo_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache(
        None if os.environ.get("JAX_COMPILATION_CACHE_DIR") else
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".jax_cache_cpu"))
    # Only persist executables whose compile took >= 0.5 s: the warm-run win
    # comes from the expensive programs.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@pytest.fixture
def on_gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: CUDA kernels have no CPU or interpret mode")
