"""PDCCH encoding/processing and blind-decoding (TS 38.212 Section 7.3, 38.211 Section 7.3.2).

Tx: DCI payload -> CRC24C over a 24-ones prefix, RNTI-masked parity -> input
interleaver -> polar (n_max = 9, no channel interleaver) -> rate match ->
scramble -> QPSK -> (with DM-RS) REG/CCE resource mapping.
Rx (test driver / monitoring): descramble -> rate dematch -> SC decode ->
deinterleave -> CRC check with RNTI unmasking.
reference: lib/phy/upper/channel_processors/pdcch_encoder_impl.cpp:33-98,
pdcch_modulator_impl.cpp, pdcch_processor_impl.cpp.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..ops import prg as prg_mod
from ..ops.crc import crc_host
from ..ops.modulation import modulate_np
from ..ops.demodulation import soft_demap
from ..ops.polar import PolarCode, polar_encode, polar_decode, polar_allocate, polar_deallocate
from ..ops.polar import rate_matching as polar_rm
from ..ops.polar.interleave import interleave, deinterleave
from ..ran.modulation import Modulation

CRC_LEN = 24
RNTI_LEN = 16

#: REs per CCE: 6 REGs x 12 subcarriers, 3 of 12 are DM-RS -> 54 data REs.
RE_PER_CCE = 54
DMRS_PER_CCE = 18


def _polar_code(k: int, e: int) -> PolarCode:
    return PolarCode(K=k, E=e, n_max=9, ibil=False)


def _rnti_bits(rnti: int) -> np.ndarray:
    return np.asarray([(rnti >> (RNTI_LEN - 1 - i)) & 1 for i in range(RNTI_LEN)], np.uint8)


def pdcch_encode(dci_bits: np.ndarray, rnti: int, e: int) -> np.ndarray:
    """Encode one DCI payload to E rate-matched bits (host + device mix)."""
    a = np.asarray(dci_bits, dtype=np.uint8)
    k = len(a) + CRC_LEN
    code = _polar_code(k, e)
    # CRC24C over [1]*24 + payload; parity's last 16 bits masked with the RNTI.
    a_prime = np.concatenate([np.ones(CRC_LEN, np.uint8), a])
    crc = crc_host(a_prime, "CRC24C")
    crc[-RNTI_LEN:] ^= _rnti_bits(rnti)
    c = np.concatenate([a, crc])
    c_il = interleave(jnp.asarray(c[None]), k)
    u = polar_allocate(c_il, code)
    x = polar_encode(u, code.n)
    return np.asarray(polar_rm.rate_match(x, code))[0]


def pdcch_scrambling_cinit(n_id: int, n_rnti: int) -> int:
    return ((n_rnti << 16) + n_id) % (1 << 31)


@dataclass(frozen=True)
class PdcchCandidateConfig:
    nof_dci_bits: int
    aggregation_level: int  # 1, 2, 4, 8, 16 CCEs
    rnti: int
    n_id: int = 0        # pdcch-DMRS-ScramblingID / scrambling id
    n_rnti: int = 0      # scrambling RNTI (UE-specific search space)

    @property
    def e(self) -> int:
        return self.aggregation_level * RE_PER_CCE * 2  # QPSK


def pdcch_modulate(cfg: PdcchCandidateConfig, dci_bits: np.ndarray) -> np.ndarray:
    """DCI -> complex data symbols (aggregation_level * 54,) complex64."""
    coded = pdcch_encode(dci_bits, cfg.rnti, cfg.e)
    seq = prg_mod.gold_sequence_bits(pdcch_scrambling_cinit(cfg.n_id, cfg.n_rnti), cfg.e)
    scr = coded ^ seq
    return modulate_np(scr, Modulation.QPSK)


def pdcch_dmrs_values(slot: int, start_symbol: int, duration: int,
                      prbs, n_id: int) -> np.ndarray:
    """DM-RS pilot values for a candidate, ordered (symbol, prb, k in {1,5,9}).

    The Gold sequence is CRB-indexed (3 pilots per PRB from reference point 0)
    with per-symbol c_init (TS 38.211 Section 7.4.1.3).
    """
    vals = []
    mmax = (max(prbs) + 1) * 3
    for sym in range(start_symbol, start_symbol + duration):
        cinit = ((1 << 17) * (14 * slot + sym + 1) * (2 * n_id + 1)
                 + 2 * n_id) % (1 << 31)
        bits = prg_mod.gold_sequence_bits(cinit, 2 * mmax).astype(np.float32)
        v = (1.0 - 2.0 * bits) / np.sqrt(2.0)
        pil = (v[0::2] + 1j * v[1::2]).astype(np.complex64)
        for prb in prbs:
            vals.extend(pil[3 * prb:3 * prb + 3])
    return np.asarray(vals, np.complex64)


def pdcch_blind_decode(rx_syms_pair, noise_var, cfg: PdcchCandidateConfig):
    """Attempt decoding one candidate from (B, E/2, 2) equalized symbols.

    Returns (dci_bits (B, nof_dci_bits) uint8, crc_ok (B,) bool).
    """
    llr = soft_demap(rx_syms_pair, noise_var, Modulation.QPSK)  # (B, E)
    seq = prg_mod.gold_sequence_bits(pdcch_scrambling_cinit(cfg.n_id, cfg.n_rnti), cfg.e)
    signs = jnp.asarray(1 - 2 * seq.astype(np.int32))
    llr = jnp.clip(llr.astype(jnp.int32) * signs[None], -127, 127).astype(jnp.int8)

    k = cfg.nof_dci_bits + CRC_LEN
    code = _polar_code(k, cfg.e)
    buf = polar_rm.rate_dematch(llr, code)
    u = polar_decode(buf, code)
    c_il = polar_deallocate(u, code)
    c = deinterleave(c_il, k)

    a = c[..., : cfg.nof_dci_bits]
    crc = c[..., cfg.nof_dci_bits:]
    unmasked = crc.at[..., -RNTI_LEN:].set(
        crc[..., -RNTI_LEN:] ^ jnp.asarray(_rnti_bits(cfg.rnti))
    )
    # Verify CRC24C over ones-prefix + payload.
    ones = jnp.ones(a.shape[:-1] + (CRC_LEN,), jnp.uint8)
    from ..ops.crc import crc_device

    expect = crc_device(jnp.concatenate([ones, a], axis=-1), "CRC24C")
    ok = jnp.all(expect == unmasked, axis=-1)
    return a, ok
