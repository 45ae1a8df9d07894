"""LDPC chain tests: graph structure, encoder validity (H c = 0), decoder
correctness and bit-exactness vs the golden numpy model, rate match round trip."""

import numpy as np
import pytest

import jax.numpy as jnp

from srsran_projectvtlmo_tpu.ran.ldpc_params import ALL_LIFTING_SIZES, BaseGraph
from srsran_projectvtlmo_tpu.ops.ldpc.graphs import get_graph, lifted_parity_matrix
from srsran_projectvtlmo_tpu.ops.ldpc.encode import ldpc_encode
from srsran_projectvtlmo_tpu.ops.ldpc.decode import ldpc_decode
from srsran_projectvtlmo_tpu.ops.ldpc import rate_matching as rm
from srsran_projectvtlmo_tpu.utils.llr import LLR_INFTY

from tests.golden.ldpc import golden_decode

# z=208/384 compile for tens of seconds on CPU; the fast tier keeps the
# small/medium lifting sizes and the slow tier covers the big ones.
SAMPLE_Z = [2, 3, 13, 30, 52, 112,
            pytest.param(208, marks=pytest.mark.slow),
            pytest.param(384, marks=pytest.mark.slow)]


class TestGraphs:
    @pytest.mark.parametrize("bg", [BaseGraph.BG1, BaseGraph.BG2])
    def test_plan_derivation_all_sizes(self, bg):
        for z in ALL_LIFTING_SIZES:
            g = get_graph(bg, z)  # raises if structure assertions fail
            assert g.max_row_degree <= 20
            assert (g.shifts >= -1).all() and (g.shifts < z).all()

    def test_edge_counts(self):
        # TS 38.212 base graphs have 316 (BG1) / 197 (BG2) edges.
        assert (get_graph(BaseGraph.BG1, 384).shifts >= 0).sum() == 316
        assert (get_graph(BaseGraph.BG2, 384).shifts >= 0).sum() == 197


class TestEncoder:
    @pytest.mark.parametrize("bg", [BaseGraph.BG1, BaseGraph.BG2])
    @pytest.mark.parametrize("z", SAMPLE_Z)
    def test_parity_equations_hold(self, bg, z):
        g = get_graph(bg, z)
        rng = np.random.default_rng(z)
        info = rng.integers(0, 2, (3, g.k)).astype(np.uint8)
        cw = np.asarray(ldpc_encode(jnp.asarray(info), bg, z))
        assert cw.shape == (3, g.n_full * z)
        # Systematic part preserved.
        np.testing.assert_array_equal(cw[:, : g.k], info)
        # H c^T = 0 over GF(2) against the independently constructed lifted H.
        h = lifted_parity_matrix(g)
        syndrome = (h.astype(np.int64) @ cw.T.astype(np.int64)) % 2
        assert syndrome.sum() == 0, f"nonzero syndrome bg={bg} z={z}"


class TestDecoder:
    @pytest.mark.parametrize("bg", [BaseGraph.BG1, BaseGraph.BG2])
    @pytest.mark.parametrize("z", [13, 52, 208])
    def test_noiseless_roundtrip(self, bg, z):
        g = get_graph(bg, z)
        rng = np.random.default_rng(z + 1)
        info = rng.integers(0, 2, (2, g.k)).astype(np.uint8)
        cw = np.asarray(ldpc_encode(jnp.asarray(info), bg, z))[:, 2 * z:]
        llr = ((1 - 2 * cw.astype(np.int32)) * 20).astype(np.int8)
        hard, _ = ldpc_decode(jnp.asarray(llr), bg, z, nof_iterations=6)
        np.testing.assert_array_equal(np.asarray(hard), info)

    @pytest.mark.parametrize("bg", [BaseGraph.BG1, BaseGraph.BG2])
    @pytest.mark.parametrize("z", [13, 26])
    def test_bit_exact_vs_golden(self, bg, z):
        """Soft outputs match the golden layered min-sum bit for bit, on noisy input."""
        g = get_graph(bg, z)
        rng = np.random.default_rng(z + 2)
        info = rng.integers(0, 2, (1, g.k)).astype(np.uint8)
        cw = np.asarray(ldpc_encode(jnp.asarray(info), bg, z))[:, 2 * z:]
        clean = (1 - 2 * cw.astype(np.float64)) * 7
        noisy = clean + rng.normal(0, 4.0, clean.shape)
        llr = np.clip(np.round(noisy), -20, 20).astype(np.int8)
        hard, soft = ldpc_decode(jnp.asarray(llr), bg, z, nof_iterations=4)
        g_hard, g_soft = golden_decode(llr[0], bg, z, nof_iterations=4, scaling=0.8)
        np.testing.assert_array_equal(np.asarray(soft)[0], g_soft,
                                      err_msg=f"soft mismatch bg={bg} z={z}")
        np.testing.assert_array_equal(np.asarray(hard)[0], g_hard)

    def test_corrects_noise(self):
        bg, z = BaseGraph.BG1, 52
        g = get_graph(bg, z)
        rng = np.random.default_rng(7)
        info = rng.integers(0, 2, (4, g.k)).astype(np.uint8)
        cw = np.asarray(ldpc_encode(jnp.asarray(info), bg, z))[:, 2 * z:]
        # BPSK over AWGN at moderate SNR.
        x = 1 - 2 * cw.astype(np.float64)
        y = x + rng.normal(0, 0.55, x.shape)
        llr = np.clip(np.round(8 * y), -120, 120).astype(np.int8)
        assert ((llr < 0) != (cw > 0)).mean() < 0.5  # sanity: llr sign mostly matches
        hard, _ = ldpc_decode(jnp.asarray(llr), bg, z, nof_iterations=10)
        errs = (np.asarray(hard) != info).sum()
        assert errs == 0, f"{errs} bit errors after decoding"


class TestRateMatch:
    @pytest.mark.parametrize("bg,z,f,rv,e,qm", [
        (BaseGraph.BG1, 52, 0, 0, 4000, 4),
        (BaseGraph.BG1, 52, 40, 0, 3000, 2),
        (BaseGraph.BG1, 52, 40, 2, 3000, 6),
        (BaseGraph.BG2, 52, 16, 0, 1000, 2),
        (BaseGraph.BG2, 52, 16, 3, 6000, 8),  # E > N - F: repetition
    ])
    def test_plan_properties(self, bg, z, f, rv, e, qm):
        plan = rm.rate_match_plan(bg, z, f, rv, e, qm)
        n = (66 if bg == BaseGraph.BG1 else 50) * z
        kb = 22 if bg == BaseGraph.BG1 else 10
        assert plan.shape == (e,)
        assert plan.min() >= 0 and plan.max() < n
        # Never selects filler positions.
        filler = set(range(kb * z - 2 * z - f, kb * z - 2 * z))
        assert not (set(plan.tolist()) & filler)
        # For rv0 without repetition, deinterleaving recovers the circular-buffer
        # selection in order: position 0, 1, ... skipping filler.
        if rv == 0 and e <= n - f:
            j = np.arange(e // qm)
            i = np.arange(qm)
            perm = (i[None, :] * (e // qm) + j[:, None]).reshape(-1)
            sel = np.empty(e, dtype=np.int64)
            sel[np.arange(e)] = plan  # plan[out] = sel_seq[perm[out]]
            sel_seq = np.empty(e, dtype=np.int64)
            sel_seq[perm] = plan
            assert sel_seq[0] == 0
            assert (np.diff(sel_seq) > 0).all()  # monotone since k0=0, no wrap

    def test_roundtrip_identity(self):
        """dematch(match(cw)) recovers sign-consistent LLRs at every selected position."""
        bg, z, f, rv, e, qm = BaseGraph.BG1, 52, 40, 0, 5000, 4
        g = get_graph(bg, z)
        rng = np.random.default_rng(9)
        info = rng.integers(0, 2, (1, g.k)).astype(np.uint8)
        info[:, g.k - f:] = 0
        cw = np.asarray(ldpc_encode(jnp.asarray(info), bg, z))[:, 2 * z:]
        tx = np.asarray(rm.rate_match(jnp.asarray(cw), bg, z, f, rv, e, qm))
        llr_in = ((1 - 2 * tx.astype(np.int32)) * 10).astype(np.int8)
        buf = np.asarray(rm.rate_dematch(jnp.asarray(llr_in), bg, z, f, rv, e, qm))
        sel, filler = rm.rate_dematch_plan(bg, z, f, rv, e, qm)
        # Filler marked fixed-0.
        assert (buf[0, filler] == LLR_INFTY).all()
        # Every selected position has an LLR whose sign matches the bit.
        got_bits = (buf[0, sel] < 0).astype(np.uint8)
        np.testing.assert_array_equal(got_bits, cw[0, sel])
        # Decode closes the loop.
        hard, _ = ldpc_decode(jnp.asarray(buf), bg, z, nof_iterations=6)
        np.testing.assert_array_equal(np.asarray(hard)[0], info[0])
