"""SS/PBCH block generation: PSS, SSS, PBCH encode + modulate, SSB assembly.

TS 38.211 Sections 7.4.2.2/7.4.2.3 (PSS/SSS m-sequences), TS 38.212
Section 7.1 (PBCH payload interleaving, scrambling, CRC24C, polar K=56 E=864),
TS 38.211 Section 7.4.3 (SS/PBCH block: 240 subcarriers x 4 symbols).
reference: lib/phy/upper/channel_processors/pbch_encoder_impl.cpp:32-160,
pbch_modulator_impl.cpp, ssb_processor_impl.cpp.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..ops import prg as prg_mod
from ..ops.crc import crc_host
from ..ops.modulation import modulate_np
from ..ops.polar import PolarCode, polar_encode, polar_allocate
from ..ops.polar import rate_matching as polar_rm
from ..ops.polar.interleave import interleave
from ..ran.modulation import Modulation

A = 32          # payload bits
B = A + 24      # payload + CRC24C
E = 864         # rate-matched bits
SSB_NSUBC = 240
SSB_NSYM = 4

#: TS 38.212 Table 7.1.1-1: PBCH payload interleaver pattern G(j).
G = np.asarray([16, 23, 18, 17, 8, 30, 10, 6, 24, 7, 0, 5, 3, 2, 1, 4,
                9, 11, 12, 13, 14, 15, 19, 20, 21, 22, 25, 26, 27, 28, 29, 31])


def _mseq(taps: tuple[int, int], init: list[int]) -> np.ndarray:
    x = np.zeros(127 + 7, dtype=np.uint8)
    x[:7] = init
    for i in range(127):
        x[i + 7] = x[i + taps[0]] ^ x[i + taps[1]]
    return x[:127]


_PSS_X = _mseq((4, 0), [0, 1, 1, 0, 1, 1, 1])
_SSS_X0 = _mseq((4, 0), [1, 0, 0, 0, 0, 0, 0])
_SSS_X1 = _mseq((1, 0), [1, 0, 0, 0, 0, 0, 0])


def pss_sequence(n_id2: int) -> np.ndarray:
    n = (np.arange(127) + 43 * n_id2) % 127
    return (1.0 - 2.0 * _PSS_X[n]).astype(np.complex64)


def sss_sequence(n_id1: int, n_id2: int) -> np.ndarray:
    m0 = 15 * (n_id1 // 112) + 5 * n_id2
    m1 = n_id1 % 112
    n = np.arange(127)
    d = (1 - 2 * _SSS_X0[(n + m0) % 127].astype(np.int32)) * \
        (1 - 2 * _SSS_X1[(n + m1) % 127].astype(np.int32))
    return d.astype(np.complex64)


@dataclass(frozen=True)
class PbchMessage:
    sfn: int
    ssb_idx: int
    half_radio_frame: bool
    n_id: int  # physical cell id
    l_max: int = 8
    #: 24-bit MIB-derived part of the payload (bits a_1..a_24 before SFN/HRF/SSB fields).
    mib_payload: tuple[int, ...] = tuple([0] * 24)
    #: Subcarrier offset k_SSB (TS 38.211 Section 7.4.3.1); its MSB rides in
    #: the payload when L_max != 64 (reference: pbch_encoder_impl.cpp:75).
    k_ssb: int = 0


def pbch_payload(msg: PbchMessage) -> np.ndarray:
    """Build the interleaved 32-bit payload a (TS 38.212 Section 7.1.1)."""
    a = np.zeros(A, dtype=np.uint8)
    payload = list(msg.mib_payload)
    # 24 MIB bits + 4 SFN LSBs + HRF + 3 SSB/k_ssb bits = 32.
    j_sfn = 0
    j_other = 14
    sfn_begin, sfn_len = 1, 6
    for i in range(A - 8):
        if sfn_begin <= i < sfn_begin + sfn_len:
            a[G[j_sfn]] = payload[i]
            j_sfn += 1
        else:
            a[G[j_other]] = payload[i]
            j_other += 1
    a[G[j_sfn]] = (msg.sfn >> 3) & 1
    a[G[j_sfn + 1]] = (msg.sfn >> 2) & 1
    a[G[j_sfn + 2]] = (msg.sfn >> 1) & 1
    a[G[j_sfn + 3]] = msg.sfn & 1
    a[G[10]] = 1 if msg.half_radio_frame else 0
    if msg.l_max == 64:
        a[G[11]] = (msg.ssb_idx >> 5) & 1
        a[G[12]] = (msg.ssb_idx >> 4) & 1
        a[G[13]] = (msg.ssb_idx >> 3) & 1
    else:
        a[G[11]] = (msg.k_ssb >> 4) & 1
        a[G[12]] = 0  # reserved
        a[G[13]] = 0
    return a


def pbch_scramble_payload(a: np.ndarray, msg: PbchMessage) -> np.ndarray:
    """First scrambling (TS 38.212 Section 7.1.2): skips SFN 2nd/3rd LSBs, HRF, SSB bits."""
    m = A - 6 if msg.l_max == 64 else A - 3
    sfn_2nd_g = G[6 + 2]
    sfn_3rd_g = G[6 + 1]
    v = 2 * a[sfn_3rd_g] + a[sfn_2nd_g]
    seq = prg_mod.gold_sequence_bits(msg.n_id, m * v + A)[m * v:]
    out = a.copy()
    j = 0
    for i in range(A):
        is_ssb = (i in (G[11], G[12], G[13])) and msg.l_max == 64
        if is_ssb or i == G[10] or i == sfn_2nd_g or i == sfn_3rd_g:
            s = 0
        else:
            s = seq[j]
            j += 1
        out[i] ^= s
    return out


def pbch_encode(msg: PbchMessage) -> np.ndarray:
    """Full PBCH encode -> (E,) bits (before the second, E-level scrambling)."""
    a = pbch_payload(msg)
    a_prime = pbch_scramble_payload(a, msg)
    b = np.concatenate([a_prime, crc_host(a_prime, "CRC24C")])
    code = PolarCode(K=B, E=E, n_max=9, ibil=False)
    c_il = interleave(jnp.asarray(b[None]), B)
    u = polar_allocate(c_il, code)
    x = polar_encode(u, code.n)
    return np.asarray(polar_rm.rate_match(x, code))[0]


def pbch_modulate(msg: PbchMessage) -> np.ndarray:
    """Encode + second scrambling + QPSK -> (432,) symbols."""
    bits = pbch_encode(msg)
    # TS 38.211 Section 7.3.3.1: v = 2 (L_max=4) or 3 LSBs of the SSB index.
    v = msg.ssb_idx % 4 if msg.l_max == 4 else msg.ssb_idx % 8
    seq = prg_mod.gold_sequence_bits(msg.n_id, E * (v + 1))[E * v:]
    scr = bits ^ seq
    return modulate_np(scr, Modulation.QPSK)


def pbch_dmrs(msg: PbchMessage) -> np.ndarray:
    """(144,) DM-RS QPSK pilots (TS 38.211 Section 7.4.1.4)."""
    i_ssb = msg.ssb_idx % (4 if msg.l_max == 4 else 8)
    i_bar = i_ssb + (4 if (msg.l_max == 4 and msg.half_radio_frame) else 0)
    cinit = ((1 << 11) * (i_bar + 1) * (msg.n_id // 4 + 1) + (1 << 6) * (i_bar + 1)
             + (msg.n_id % 4)) % (1 << 31)
    bits = prg_mod.gold_sequence_bits(cinit, 288).astype(np.float32)
    vals = (1 - 2 * bits) / np.sqrt(2)
    return (vals[0::2] + 1j * vals[1::2]).astype(np.complex64)


def assemble_ssb(msg: PbchMessage, beta_pss: float = 1.0) -> np.ndarray:
    """SS/PBCH block grid (4 symbols x 240 subcarriers), complex64.

    Layout per TS 38.211 Table 7.4.3.1-1: PSS at symbol 0 subc 56..183,
    SSS at symbol 2 same range, PBCH on symbols 1,3 (full 240) and symbol 2
    (subc 0..47 and 192..239), DM-RS every 4th subcarrier with offset
    v = N_id mod 4 within the PBCH REs.
    """
    grid = np.zeros((SSB_NSYM, SSB_NSUBC), np.complex64)
    grid[0, 56:183] = pss_sequence(msg.n_id % 3) * beta_pss
    grid[2, 56:183] = sss_sequence(msg.n_id // 3, msg.n_id % 3)

    v = msg.n_id % 4
    data = pbch_modulate(msg)
    dmrs = pbch_dmrs(msg)

    def fill(symbol: int, sub_range: np.ndarray, data_it, dmrs_it):
        for k in sub_range:
            if k % 4 == v:
                grid[symbol, k] = dmrs[next(dmrs_it)]
            else:
                grid[symbol, k] = data[next(data_it)]

    d_idx = iter(range(len(data)))
    r_idx = iter(range(len(dmrs)))
    fill(1, np.arange(240), d_idx, r_idx)
    fill(2, np.arange(0, 48), d_idx, r_idx)
    fill(2, np.arange(192, 240), d_idx, r_idx)
    fill(3, np.arange(240), d_idx, r_idx)
    return grid
