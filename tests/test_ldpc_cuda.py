"""The CUDA early-stop LDPC decoder and the one decoder selection point.

The kernel itself runs only on a GPU (CUDA has no interpret mode): its parity
tests carry the `gpu` marker and skip elsewhere; `chip_smoke.py` runs them on
the card.  On the CPU the tests cover what surrounds it: the selection rules,
the wrapper's shapes and group size, that the UpperPhy dispatch traces the
kernel, and a numpy model of the kernel's two-pass layer update and in-block
CRC basis checked against the XLA decoder it must match bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from srsran_projectvtlmo_tpu.ran.ldpc_params import BaseGraph
from srsran_projectvtlmo_tpu.ops.crc import POLYS, crc_zero_basis
from srsran_projectvtlmo_tpu.ops.ldpc import decode_cuda, select
from srsran_projectvtlmo_tpu.ops.ldpc.decode import ldpc_decode_es
from srsran_projectvtlmo_tpu.ops.ldpc.graphs import get_graph
from tests.test_ldpc_early_stop import _crc_codewords

#: A 273-PRB 2-layer QAM256 R=948/1024 slot (TBS 638984) segments into 76
#: BG1 z=384 codeblocks.
SLOT_CBS = 76


def _noisy_codewords(bg, z, batch, seed, flip=0.07):
    """CRC-carrying codewords with a share of halved, sign-flipped LLRs and
    one undecodable codeblock, so early stop, late convergence and failure
    all occur in one batch."""
    info, llr, kp = _crc_codewords(bg, z, batch, "CRC24B", seed=seed)
    rng = np.random.default_rng(seed + 1)
    noisy = np.where(rng.random(llr.shape) < flip, -llr // 2, llr).astype(np.int8)
    noisy[batch // 2] = rng.integers(-20, 20, noisy.shape[1]).astype(np.int8)
    return info, noisy, kp


# --------------------------------------------------------------- on the GPU --

@pytest.mark.gpu
@pytest.mark.parametrize("bg,z,batch", [
    (BaseGraph.BG1, 384, SLOT_CBS), (BaseGraph.BG1, 208, SLOT_CBS),
    (BaseGraph.BG2, 52, SLOT_CBS), (BaseGraph.BG2, 40, 7)])
def test_cuda_decoder_bit_exact_vs_xla(on_gpu, bg, z, batch):
    info, noisy, kp = _noisy_codewords(bg, z, batch, seed=z)
    x = jnp.asarray(noisy)
    ref = ldpc_decode_es(x, bg, z, "CRC24B", kp, nof_iterations=6)
    got = decode_cuda.ldpc_decode_es_cuda(x, bg, z, "CRC24B", kp, nof_iterations=6)
    for name, a, b in zip(("hard", "soft", "crc_ok", "iterations"), ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    iters = np.asarray(got[3])
    assert iters.min() < iters.max() == 6, "batch did not exercise early stop"


@pytest.mark.gpu
def test_cuda_decoder_matches_reference_vectors(on_gpu):
    """The reference C++ decoder's fixed-iteration vectors.  The vectors'
    messages carry no CRC, so a CRC over all systematic bits never passes
    and the kernel runs every iteration, as the reference did."""
    from tests.test_reference_parity import _DATA, _KEYS, _parse

    for key in [k for k in _KEYS if "_it6_" in k or "_it2_" in k]:
        bg, z, it = _parse(key)
        k = get_graph(BaseGraph(bg), z).kb * z
        hard, _, ok, iters = decode_cuda.ldpc_decode_es_cuda(
            jnp.asarray(_DATA[f"{key}_llr"][None]), BaseGraph(bg), z, "CRC24B", k,
            nof_iterations=it)
        assert not np.asarray(ok).any() and int(np.asarray(iters)[0]) == it, key
        np.testing.assert_array_equal(np.asarray(hard)[0], _DATA[f"{key}_dec"], err_msg=key)


# ------------------------------------------------------------ on the CPU ----

@pytest.fixture
def platform(monkeypatch):
    def set_platform(name):
        monkeypatch.setattr(select, "_platform", lambda: name)
    return set_platform


class TestSelection:
    def test_cpu_picks_xla(self):
        assert select.select_es_decoder() == "xla"
        assert select.es_decoder() is ldpc_decode_es

    def test_gpu_picks_cuda(self, platform):
        platform("gpu")
        assert select.select_es_decoder() == "cuda"
        assert select.select_es_decoder("xla") == "xla"
        assert select.es_decoder() is decode_cuda.ldpc_decode_es_cuda

    @pytest.mark.parametrize("name", ["tpu", "rocm", "METAL"])
    def test_unknown_platform_raises(self, platform, name):
        platform(name)
        with pytest.raises(ValueError, match="no LDPC decoder"):
            select.select_es_decoder()

    def test_forcing_the_kernel_on_cpu_raises(self):
        with pytest.raises(ValueError, match="needs a GPU"):
            select.select_es_decoder("cuda")
        with pytest.raises(ValueError, match="needs a GPU"):
            select.es_decoder("cuda")

    def test_unknown_decoder_raises(self, platform):
        platform("gpu")
        with pytest.raises(ValueError, match="unknown LDPC decoder"):
            select.select_es_decoder("pallas")


class TestKernelPlan:
    @pytest.mark.parametrize("bg,z,group", [
        (BaseGraph.BG1, 384, 1), (BaseGraph.BG1, 208, 1), (BaseGraph.BG1, 176, 1),
        (BaseGraph.BG2, 104, 2), (BaseGraph.BG2, 52, 4), (BaseGraph.BG2, 40, 6),
        (BaseGraph.BG2, 2, 32)])
    def test_tables_and_group(self, bg, z, group):
        g = get_graph(bg, z)
        row_start, cols, shifts, got_group = decode_cuda.kernel_plan(bg, z)
        assert got_group == group
        assert row_start.shape == (g.m + 1,) and row_start[-1] == len(cols)
        assert len(cols) == int((g.row_cols >= 0).sum()) <= 320
        assert (0 <= shifts).all() and (shifts < z).all()
        # Block limits of the kernel: threads and shared memory.
        assert group * z <= 1024
        assert group * (g.n_full + len(cols)) * z <= decode_cuda._MAX_SHARED_BYTES
        # Edge order inside each row is the base graph's column order.
        for r in range(g.m):
            row = cols[row_start[r]:row_start[r + 1]]
            np.testing.assert_array_equal(row, g.row_cols[r][g.row_cols[r] >= 0])


@pytest.fixture
def traced_kernel(platform, monkeypatch):
    """Trace (never lower) the CUDA path on the CPU: the platform reads as a
    GPU and the library loader is not called."""
    platform("gpu")
    monkeypatch.setattr(decode_cuda, "load", lambda: None)


@pytest.mark.parametrize("bg,z,batch", [(BaseGraph.BG1, 384, SLOT_CBS),
                                        (BaseGraph.BG2, 40, 7)])
def test_wrapper_shapes(traced_kernel, bg, z, batch):
    g = get_graph(bg, z)
    llr = jax.ShapeDtypeStruct((batch, (g.n_full - 2) * z), jnp.int8)
    hard, soft, ok, iters = jax.eval_shape(
        lambda x: decode_cuda.ldpc_decode_es_cuda(x, bg, z, "CRC24B", g.kb * z), llr)
    assert (hard.shape, hard.dtype) == ((batch, g.kb * z), jnp.uint8)
    assert (soft.shape, soft.dtype) == ((batch, g.kb * z), jnp.int8)
    assert (ok.shape, ok.dtype) == ((batch,), jnp.bool_)
    assert (iters.shape, iters.dtype) == ((batch,), jnp.int32)
    traced = jax.jit(lambda x: decode_cuda.ldpc_decode_es_cuda(
        x, bg, z, "CRC24B", g.kb * z)).trace(llr)
    assert decode_cuda.TARGET in str(traced.jaxpr)


def test_upper_phy_dispatch_traces_the_kernel(traced_kernel):
    """The PUSCH program UpperPhy dispatches for a PDU, built with the
    platform's default decoder, contains the kernel's custom call."""
    from srsran_projectvtlmo_tpu.fapi.pdus import PuschPdu
    from srsran_projectvtlmo_tpu.models.pusch_rx import build_pusch_rx_from_grid
    from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig, UpperPhy
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation

    cell = CellConfig(nof_rb=24, dft_size=512, numerology=1, nof_rx_ports=2)
    phy = UpperPhy(cell)
    pdu = PuschPdu(rnti=0x44, rb_start=0, rb_size=8, modulation=Modulation.QAM16,
                   target_code_rate=0.5, n_id=3, dmrs_symbols=(2,))
    grid = jnp.zeros((2, 14, cell.nof_subc, 2), jnp.bfloat16)
    cfg, p2map, _, (sub, ref, signs, fix) = phy._pusch_inputs(1, pdu, grid)
    assert cfg.ldpc_decoder is None and p2map is None
    # A fresh (uncached) program: the GPU trace must not reach later tests.
    traced = build_pusch_rx_from_grid(cfg).trace(sub, None, ref, signs, fix)
    assert decode_cuda.TARGET in str(traced.jaxpr)


# ---------------------------------------------- numpy model of the kernel ---

def _sat_sub(a, b):
    out = np.where(np.abs(a) == 127, a,
                   np.where(np.abs(b) == 127, -b, np.clip(a - b, -120, 120)))
    return np.where(a == b, 0, out)


def _promotion_sum(a, b):
    s = a + b
    plain = np.where(s > 120, 127, np.where(s < -120, -127, s))
    out = np.where(np.abs(a) == 127, a, np.where(np.abs(b) == 127, b, plain))
    return np.where(a == -b, 0, out)


def _crc_basis_model(crc_name, kp, kb, z):
    """The kernel's per-thread CRC basis walk: x^(kp-1-k) mod g for
    k = c*z + lane, from the last column down by multiplying with x^z."""
    order, poly = POLYS[crc_name]

    def mulx(r):
        r <<= 1
        return r ^ poly if (r >> order) & 1 else r

    def mulmod(a, b):
        acc = 0
        for i in range(order):
            if (b >> i) & 1:
                acc ^= a
            a = mulx(a)
        return acc

    xz = 1
    for _ in range(z):
        xz = mulx(xz)
    basis = np.zeros((kb, z), np.int64)
    for lane in range(z):
        if lane >= kp:
            continue
        c_last = (kp - 1 - lane) // z
        r = 1
        for _ in range(kp - 1 - (c_last * z + lane)):
            r = mulx(r)
        for c in range(min(c_last, kb - 1), -1, -1):
            basis[c, lane] = r
            r = mulmod(r, xz)
    return basis


def _kernel_model(llr, bg, z, crc_name, kp, max_iterations, scaling=0.8):
    """One codeblock through the kernel's algorithm: min pass, then an update
    pass that recomputes v2c, int8 messages per edge, in-block CRC stop."""
    g = get_graph(bg, z)
    row_start, cols, shifts, _ = decode_cuda.kernel_plan(bg, z)
    basis = _crc_basis_model(crc_name, kp, g.kb, z)
    soft = np.concatenate([np.zeros(2 * z, np.int64), llr.astype(np.int64)]).reshape(g.n_full, z)
    c2v = np.zeros((len(cols), z), np.int64)
    lane = np.arange(z)
    for it in range(max_iterations):
        for r in range(g.m):
            edges = range(row_start[r], row_start[r + 1])
            min1 = np.full(z, 128)
            min2 = np.full(z, 128)
            argmin = np.full(z, row_start[r])
            parity = np.zeros(z, np.int64)
            for e in edges:
                v = _sat_sub(soft[cols[e], (lane + shifts[e]) % z], c2v[e])
                a = np.abs(v)
                new_min = a < min1
                min2 = np.where(new_min, min1, np.where(a < min2, a, min2))
                argmin = np.where(new_min, e, argmin)
                min1 = np.where(new_min, a, min1)
                parity ^= (v < 0)
            m1 = np.floor(np.minimum(min1, 120).astype(np.float32) * np.float32(scaling)
                          + np.float32(0.5)).astype(np.int64)
            m2 = np.floor(np.minimum(min2, 120).astype(np.float32) * np.float32(scaling)
                          + np.float32(0.5)).astype(np.int64)
            for e in edges:
                pos = (lane + shifts[e]) % z
                v = _sat_sub(soft[cols[e], pos], c2v[e])
                mag = np.where(argmin == e, m2, m1)
                msg = np.where(parity ^ (v < 0), -mag, mag)
                soft[cols[e], pos] = _promotion_sum(msg, v)
                c2v[e] = msg
        acc = np.bitwise_xor.reduce(np.where(soft[:g.kb] <= 0, basis, 0), axis=None)
        if acc == 0:
            return soft[:g.kb].reshape(-1), True, it + 1
    return soft[:g.kb].reshape(-1), False, max_iterations


@pytest.mark.parametrize("crc_name,kp,z", [("CRC24B", 22 * 16, 16), ("CRC24B", 10 * 40, 40),
                                           ("CRC16", 300, 40), ("CRC24A", 1000, 52)])
def test_kernel_crc_basis_walk_matches_zero_basis(crc_name, kp, z):
    order, _ = POLYS[crc_name]
    kb = -(-kp // z)
    ref = crc_zero_basis(crc_name, kp).astype(np.int64) << np.arange(order)
    packed = np.zeros(kb * z, np.int64)
    packed[:kp] = ref.sum(-1)
    np.testing.assert_array_equal(_crc_basis_model(crc_name, kp, kb, z).reshape(-1), packed)


@pytest.mark.parametrize("bg,z", [(BaseGraph.BG1, 16), (BaseGraph.BG2, 13)])
def test_kernel_model_bit_exact_vs_xla(bg, z):
    info, noisy, kp = _noisy_codewords(bg, z, 4, seed=z, flip=0.1)
    hard, soft, ok, iters = (np.asarray(a) for a in ldpc_decode_es(
        jnp.asarray(noisy), bg, z, "CRC24B", kp, nof_iterations=4))
    for i in range(noisy.shape[0]):
        m_soft, m_ok, m_it = _kernel_model(noisy[i], bg, z, "CRC24B", kp, 4)
        np.testing.assert_array_equal(m_soft, soft[i], err_msg=f"cb {i}")
        assert (m_ok, m_it) == (bool(ok[i]), int(iters[i])), f"cb {i}"
    assert not ok.all() and iters.max() == 4
