"""Channel equalization: MMSE/ZF for SIMO and MIMO resource elements.

The 1xN SIMO closed form follows the reference exactly, including its
unit-combined-gain normalization and degenerate-input handling
(reference: lib/phy/upper/equalization/equalize_mmse_1xn.h:44-96).  The general
L-layer case runs as batched small hermitian solves per RE (the reference
dispatches on port count, lib/phy/upper/equalization/
channel_equalizer_generic_impl.cpp:99-119).

All I/O uses real-pair arrays; per-RE small-matrix math is jit-internal complex.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.cplx import to_cplx, from_cplx

#: The small per-RE products below run at full float32: a GPU's default
#: TF32 inputs (10-bit mantissa) put ZF symbols ~1e-2 off the reference's
#: float closed form, outside the stored-vector tolerance.
HIGHEST = jax.lax.Precision.HIGHEST


def equalize_mmse_1xn(y_pair, h_pair, noise_var_port, tx_scaling: float = 1.0):
    """MMSE equalization of a single-layer transmission over N rx ports.

    Args:
      y_pair: (..., nre, nports, 2) received REs.
      h_pair: (..., nre, nports, 2) channel estimates.
      noise_var_port: (..., nports) per-port noise variance estimates.
      tx_scaling: transmit amplitude scaling applied to the channel.

    Returns:
      (symbols (..., nre, 2), noise_vars (..., nre)): equalized symbols and
      post-equalization noise variances (infinity where degenerate).
    """
    y = to_cplx(y_pair)
    h = to_cplx(h_pair) * tx_scaling
    nvar = jnp.broadcast_to(noise_var_port[..., None, :], y.shape)  # (..., nre, nports)

    ch_norm = jnp.abs(h) ** 2
    ok = jnp.isfinite(ch_norm) & (ch_norm > 0) & jnp.isfinite(nvar) & (nvar > 0)
    ch_norm = jnp.where(ok, ch_norm, 0.0)
    c = jnp.sum(ch_norm, axis=-1)  # sum |h|^2
    nvar_acc = jnp.sum(ch_norm * jnp.where(ok, nvar, 0.0), axis=-1)
    mf = jnp.sum(jnp.where(ok, y * jnp.conj(h), 0.0), axis=-1)

    denom = c * c + nvar_acc
    good = jnp.isfinite(c) & (c > 0) & jnp.isfinite(nvar_acc) & (nvar_acc > 0)
    out = jnp.where(good, mf * c / jnp.where(good, denom, 1.0), 0.0)
    nvars = jnp.where(good, nvar_acc / jnp.where(good, denom, 1.0), jnp.inf)
    return from_cplx(out), nvars


def mmse_weights(h_pair, noise_var_port, tx_scaling: float = 1.0):
    """MMSE weight matrices per resource element / subcarrier.

    Because the slot's channel estimate is constant across the data symbols,
    the weights are computed ONCE per subcarrier and applied to every symbol
    (`apply_weights`) — 13x fewer solves than the per-RE formulation for a
    full slot.  L = 1 uses the reference's SIMO closed form
    (reference: lib/phy/upper/equalization/equalize_mmse_1xn.h:44-96);
    L = 2 a closed-form 2x2 hermitian adjugate inverse; L >= 3 falls back to
    a batched inverse (still per subcarrier, not per RE).

    Args:
      h_pair: (..., S, P, L, 2) channel estimates.
      noise_var_port: (..., P) per-port noise variances.

    Returns:
      (w_pair (..., S, L, P, 2) weights with noise whitening and bias
       correction folded in — symbols = w @ y —, nvar_out (..., S, L)
       post-equalization noise variances, +inf where degenerate).
    """
    nlayers = h_pair.shape[-2]
    nvar = noise_var_port[..., None, :]  # (..., 1, P)
    # All small-L paths run in EXPLICIT real arithmetic: XLA lowers complex
    # abs to hypot, complex division to a full Smith divide, and tiny complex
    # einsums to matrix-unit calls; real-pair elementwise math fuses into a
    # handful of elementwise passes instead.
    hr = h_pair[..., 0] * tx_scaling  # (..., S, P, L)
    hi = h_pair[..., 1] * tx_scaling

    if nlayers == 1:
        hr0, hi0 = hr[..., 0], hi[..., 0]  # (..., S, P)
        ch_norm = hr0 * hr0 + hi0 * hi0
        ok = jnp.isfinite(ch_norm) & (ch_norm > 0) & jnp.isfinite(nvar) & (nvar > 0)
        ch_norm = jnp.where(ok, ch_norm, 0.0)
        c = jnp.sum(ch_norm, axis=-1)  # (..., S)
        nvar_acc = jnp.sum(ch_norm * jnp.where(ok, nvar, 0.0), axis=-1)
        denom = c * c + nvar_acc
        good = jnp.isfinite(c) & (c > 0) & jnp.isfinite(nvar_acc) & (nvar_acc > 0)
        scale = jnp.where(good, c / jnp.where(good, denom, 1.0), 0.0)
        wr = jnp.where(ok, hr0, 0.0) * scale[..., None]  # (..., S, P)
        wi = jnp.where(ok, -hi0, 0.0) * scale[..., None]
        nvars = jnp.where(good, nvar_acc / jnp.where(good, denom, 1.0), jnp.inf)
        w_pair = jnp.stack([wr[..., None, :], wi[..., None, :]], axis=-1)
        return w_pair, nvars[..., None]

    if nlayers == 2:
        ninv = 1.0 / jnp.maximum(nvar, 1e-38)  # (..., 1, P)
        h0r, h0i = hr[..., 0], hi[..., 0]  # (..., S, P)
        h1r, h1i = hr[..., 1], hi[..., 1]
        # A = H^H N^-1 H + I (hermitian 2x2, diagonal real).
        a00 = jnp.sum((h0r * h0r + h0i * h0i) * ninv, axis=-1) + 1.0  # (..., S)
        a11 = jnp.sum((h1r * h1r + h1i * h1i) * ninv, axis=-1) + 1.0
        a01r = jnp.sum((h0r * h1r + h0i * h1i) * ninv, axis=-1)
        a01i = jnp.sum((h0r * h1i - h0i * h1r) * ninv, axis=-1)
        det = jnp.maximum(a00 * a11 - (a01r * a01r + a01i * a01i), 1e-30)
        # A^-1 = [[a11, -a01], [-conj(a01), a00]] / det.
        # B = H^H N^-1: b[l, p] = conj(h_pl) * ninv_p.
        b0r, b0i = h0r * ninv, -h0i * ninv  # (..., S, P)
        b1r, b1i = h1r * ninv, -h1i * ninv
        inv_det = 1.0 / det
        a11d = (a11 * inv_det)[..., None]
        a00d = (a00 * inv_det)[..., None]
        a01rd = (a01r * inv_det)[..., None]
        a01id = (a01i * inv_det)[..., None]
        # W = A^-1 B (w[l] rows over ports).
        w0r = a11d * b0r - (a01rd * b1r - a01id * b1i)
        w0i = a11d * b0i - (a01rd * b1i + a01id * b1r)
        w1r = a00d * b1r - (a01rd * b0r + a01id * b0i)
        w1i = a00d * b1i - (a01rd * b0i - a01id * b0r)
        # Bias d_l = [A^-1]_ll; unbias weights by 1/(1-d), noise = d/(1-d).
        d0 = jnp.clip(a11 * inv_det, 1e-9, 1.0 - 1e-9)
        d1 = jnp.clip(a00 * inv_det, 1e-9, 1.0 - 1e-9)
        g0 = (1.0 / (1.0 - d0))[..., None]
        g1 = (1.0 / (1.0 - d1))[..., None]
        wr_out = jnp.stack([w0r * g0, w1r * g1], axis=-2)  # (..., S, L, P)
        wi_out = jnp.stack([w0i * g0, w1i * g1], axis=-2)
        nvars = jnp.stack([d0 / (1.0 - d0), d1 / (1.0 - d1)], axis=-1)
        return jnp.stack([wr_out, wi_out], axis=-1), nvars

    h = to_cplx(h_pair) * tx_scaling  # (..., S, P, L)
    # Whitened normal matrix A = H^H N^-1 H + I and cross term B = H^H N^-1.
    ninv = 1.0 / jnp.maximum(nvar, 1e-38)  # (..., 1, P)
    ah_n = jnp.conj(jnp.swapaxes(h, -1, -2)) * ninv[..., None, :]  # (..., S, L, P)
    a = (jnp.einsum("...lp,...pk->...lk", ah_n, h, precision=HIGHEST)
         + jnp.eye(nlayers, dtype=h.dtype))
    a_inv = jnp.linalg.inv(a)

    w = jnp.einsum("...lk,...kp->...lp", a_inv, ah_n, precision=HIGHEST)  # (..., S, L, P)
    # Per-layer MMSE bias d = [A^-1]_ll in (0, 1]: unbias by 1/(1-d), post-eq
    # noise = d/(1-d).  Working with d directly avoids the 1-(1-d) float32
    # cancellation that would zero the noise variance at very high SNR.
    d = jnp.clip(jnp.real(jnp.diagonal(a_inv, axis1=-2, axis2=-1)),
                 1e-9, 1.0 - 1e-9)
    w = w / (1.0 - d)[..., None].astype(h.dtype)
    nvars = d / (1.0 - d)
    return from_cplx(w), nvars


def apply_weights(w_pair, y_pair):
    """Apply per-subcarrier weights to per-symbol received REs.

    Args:
      w_pair: (..., S, L, P, 2) from `mmse_weights`.
      y_pair: (..., nsym, S, P, 2) received data REs.

    Returns: (..., nsym, S, L, 2) equalized symbols.
    """
    wr, wi = w_pair[..., 0], w_pair[..., 1]
    yr, yi = y_pair[..., 0], y_pair[..., 1]
    outr = (jnp.einsum("...slp,...tsp->...tsl", wr, yr, precision=HIGHEST)
            - jnp.einsum("...slp,...tsp->...tsl", wi, yi, precision=HIGHEST))
    outi = (jnp.einsum("...slp,...tsp->...tsl", wr, yi, precision=HIGHEST)
            + jnp.einsum("...slp,...tsp->...tsl", wi, yr, precision=HIGHEST))
    return jnp.stack([outr, outi], axis=-1)


def apply_weights_ports_first(w_pair, y_pair, rot_pair=None):
    """`apply_weights` for REs kept in the grid's native (P, sym, subc) order.

    The port contraction is unrolled into explicit real multiply-adds: P and
    L are tiny (<= 4 / <= 2), so a dot_general would run as a pathological
    2x4 batched matmul while the unrolled form is a single fused elementwise pass
    over the grid.

    Args:
      w_pair: (..., S, L, P, 2) from `mmse_weights`/`zf_weights`.
      y_pair: (..., P, nsym, S, 2) received data REs, ports leading — the
        demodulated grid's layout, so no (B, P, T, S) -> (B, T, S, P)
        transpose has to materialize before equalization.
      rot_pair: optional (..., nsym, 2) unit phasors r_t; outputs are
        multiplied by conj(r_t) in the same fused pass (CFO derotation).

    Returns: (..., nsym, S, L, 2) equalized symbols.
    """
    wr, wi = w_pair[..., 0], w_pair[..., 1]  # (..., S, L, P)
    yr, yi = y_pair[..., 0], y_pair[..., 1]  # (..., P, T, S)
    nports = yr.shape[-3]
    outr = None
    outi = None
    for p in range(nports):
        wrp = wr[..., p][..., None, :, :]  # (..., 1, S, L)
        wip = wi[..., p][..., None, :, :]
        yrp = yr[..., p, :, :][..., None]  # (..., T, S, 1)
        yip = yi[..., p, :, :][..., None]
        tr = wrp * yrp - wip * yip
        ti = wrp * yip + wip * yrp
        outr = tr if outr is None else outr + tr
        outi = ti if outi is None else outi + ti
    if rot_pair is not None:
        cr = rot_pair[..., 0][..., None, None]  # (..., T, 1, 1)
        ci = rot_pair[..., 1][..., None, None]
        outr, outi = outr * cr + outi * ci, outi * cr - outr * ci
    return jnp.stack([outr, outi], axis=-1)


def zf_weights(h_pair, noise_var_port, tx_scaling: float = 1.0):
    """Zero-forcing weight matrices per subcarrier.

    L = 1 follows the reference SIMO ZF closed form: matched filter over
    ports divided by the combined channel energy, post-eq noise = nvar / c
    (reference: lib/phy/upper/equalization/equalize_zf_1xn.h:43-96).
    L >= 2 solves (H^H N^-1 H)^-1 H^H N^-1 (the reference's 2xN special case,
    equalize_zf_2xn.h:44, generalized); noise whitening keeps the estimator
    unbiased across ports with unequal noise.

    Same signature/returns as `mmse_weights`.
    """
    h = to_cplx(h_pair) * tx_scaling
    nlayers = h.shape[-1]
    nvar = noise_var_port[..., None, :]

    if nlayers == 1:
        hs = h[..., 0]
        ch_norm = jnp.abs(hs) ** 2
        ok = jnp.isfinite(ch_norm) & (ch_norm > 0) & jnp.isfinite(nvar) & (nvar > 0)
        ch_norm = jnp.where(ok, ch_norm, 0.0)
        c = jnp.sum(ch_norm, axis=-1)
        nvar_acc = jnp.sum(ch_norm * jnp.where(ok, nvar, 0.0), axis=-1)
        good = jnp.isfinite(c) & (c > 1e-30) & jnp.isfinite(nvar_acc)
        w = jnp.where(ok, jnp.conj(hs), 0.0) / jnp.where(good, c, 1.0)[..., None]
        w = jnp.where(good[..., None], w, 0.0)
        nvars = jnp.where(good, nvar_acc / jnp.where(good, c * c, 1.0), jnp.inf)
        return from_cplx(w[..., None, :]), nvars[..., None]

    ninv = 1.0 / jnp.maximum(nvar, 1e-38)
    ah_n = jnp.conj(jnp.swapaxes(h, -1, -2)) * ninv[..., None, :]
    a = jnp.einsum("...lp,...pk->...lk", ah_n, h, precision=HIGHEST)  # no +I: pure ZF

    if nlayers == 2:
        a00 = jnp.real(a[..., 0, 0])
        a11 = jnp.real(a[..., 1, 1])
        a01 = a[..., 0, 1]
        det = a00 * a11 - jnp.abs(a01) ** 2
        good = det > 1e-30
        det = jnp.where(good, det, 1.0)
        inv00 = (a11 / det).astype(h.dtype)
        inv11 = (a00 / det).astype(h.dtype)
        inv01 = -a01 / det
        a_inv = jnp.stack([
            jnp.stack([inv00, inv01], axis=-1),
            jnp.stack([jnp.conj(inv01), inv11], axis=-1),
        ], axis=-2)
        a_inv = jnp.where(good[..., None, None], a_inv, 0.0)
        nvars = jnp.where(good[..., None],
                          jnp.real(jnp.diagonal(a_inv, axis1=-2, axis2=-1)),
                          jnp.inf)
    else:
        a_inv = jnp.linalg.inv(a)
        nvars = jnp.real(jnp.diagonal(a_inv, axis1=-2, axis2=-1))

    w = jnp.einsum("...lk,...kp->...lp", a_inv, ah_n, precision=HIGHEST)
    return from_cplx(w), nvars


def equalize_zf_1xn(y_pair, h_pair, noise_var_port, tx_scaling: float = 1.0):
    """ZF equalization of a single-layer transmission over N rx ports.

    Same I/O convention as `equalize_mmse_1xn`
    (reference: lib/phy/upper/equalization/equalize_zf_1xn.h:43-96).
    """
    w_pair, nvars = zf_weights(h_pair[..., None, :], noise_var_port, tx_scaling)
    w = to_cplx(w_pair)[..., 0, :]  # (..., nre, P)
    y = to_cplx(y_pair)
    out = jnp.sum(w * y, axis=-1)
    return from_cplx(out), nvars[..., 0]


def equalize_mmse_general(y_pair, h_pair, noise_var_port, tx_scaling: float = 1.0):
    """MMSE for L layers over N ports via batched per-RE hermitian solves.

    Args:
      y_pair: (..., nre, nports, 2).
      h_pair: (..., nre, nports, nlayers, 2).
      noise_var_port: (..., nports).

    Returns:
      (symbols (..., nre, nlayers, 2), noise_vars (..., nre, nlayers)).
    """
    y = to_cplx(y_pair)  # (..., R, P)
    h = to_cplx(h_pair) * tx_scaling  # (..., R, P, L)
    nvar = jnp.broadcast_to(noise_var_port[..., None, :], y.shape)  # (..., R, P)

    # Whiten by per-port noise: scale rows by 1/sqrt(nvar).
    w = jax.lax.rsqrt(jnp.maximum(nvar, 1e-38))
    hw = h * w[..., None]
    yw = y * w

    # A = Hw^H Hw + I, rhs = Hw^H yw.
    ah = jnp.conj(jnp.swapaxes(hw, -1, -2))  # (..., R, L, P)
    a = (jnp.einsum("...lp,...pk->...lk", ah, hw, precision=HIGHEST)
         + jnp.eye(h.shape[-1], dtype=hw.dtype))
    rhs = jnp.einsum("...lp,...p->...l", ah, yw, precision=HIGHEST)
    sol = jnp.linalg.solve(a, rhs[..., None])[..., 0]  # (..., R, L)

    # Per-layer effective gain g_l = [A^{-1} Hw^H Hw]_{ll} = 1 - [A^{-1}]_{ll}.
    a_inv = jnp.linalg.inv(a)
    g = 1.0 - jnp.real(jnp.diagonal(a_inv, axis1=-2, axis2=-1))
    g = jnp.clip(g, 1e-9, 1.0 - 1e-9)
    out = sol / g
    nvars = (1.0 - g) / g
    return from_cplx(out), nvars
