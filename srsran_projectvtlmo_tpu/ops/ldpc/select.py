"""The one place that chooses the early-stop LDPC decoder.

"cuda" is the hand-written kernel (`decode_cuda`), "xla" the plain program
(`decode.ldpc_decode_es`); both return bit-identical results.  With no
explicit choice the platform decides, as the reference's impl selection
"auto" does (channel_coding_factories.cpp:103-110): the kernel on a GPU, the
XLA program on the CPU.  Any other platform is an error, and so is asking for
the kernel where there is no GPU: nothing falls back silently.
"""

from __future__ import annotations

import jax

DECODERS = ("cuda", "xla")


def _platform() -> str:
    return jax.default_backend()


def select_es_decoder(choice: str | None = None) -> str:
    """Resolve a decoder choice (None, "cuda" or "xla") for this platform."""
    platform = _platform()
    if platform not in ("gpu", "cpu"):
        raise ValueError(f"no LDPC decoder for platform {platform!r}")
    if choice is None:
        return "cuda" if platform == "gpu" else "xla"
    if choice not in DECODERS:
        raise ValueError(f"unknown LDPC decoder {choice!r}; expected one of {DECODERS}")
    if choice == "cuda" and platform != "gpu":
        raise ValueError(f"the CUDA LDPC decoder needs a GPU, not {platform!r}")
    return choice


def es_decoder(choice: str | None = None):
    """fn(llrs, bg, z, crc_name, nof_crc_covered_bits, *, nof_iterations)
    with the `decode.ldpc_decode_es` contract, for the resolved choice."""
    if select_es_decoder(choice) == "cuda":
        from .decode_cuda import ldpc_decode_es_cuda

        return ldpc_decode_es_cuda
    from .decode import ldpc_decode_es

    return ldpc_decode_es
