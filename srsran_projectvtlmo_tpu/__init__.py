"""srsran_projectvtlmo_tpu: a 5G NR upper-PHY framework for accelerators.

A from-scratch JAX rebuild of the srsRAN Project's upper-PHY signal chain
(reference: the srsRAN Project, C++ 5G RAN).  The compute path (OFDM, LDPC,
polar, channel estimation, equalization, PRACH correlation) runs as batched,
jitted array programs, with one CUDA kernel (the early-stop LDPC decoder) on
the GPU; host Python orchestrates slots.

Layout:
  ran/       exact-integer 3GPP math (TBS, segmentation, rate-match params, tables)
  ops/       device kernels: channel coding, modulation, OFDM, estimation, equalization
  phy/       slot-level processors (PDSCH/PUSCH/PDCCH/PRACH/PUCCH), resource grids, HARQ
  fapi/      FAPI-shaped PDU dataclasses -- the public slot API
  models/    channel models (AWGN/TDL emulators) and end-to-end chain models
  parallel/  device meshes, shardings, multi-chip slot pipelines
  utils/     LLR int8 semantics, bit packing, config, tracing
"""

__version__ = "0.1.0"
