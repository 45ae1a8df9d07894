"""Sample/sequence-axis sharding with overlap-save halo exchange.

The signal-processing analog of context parallelism (SURVEY §5.7): the lower
PHY's long sample streams shard across chips, and stages whose windows span
the boundary (FIR filtering, CP-offset DFT windows) exchange halo samples
with ring neighbours via `jax.lax.ppermute` inside `shard_map` —
instead of gathering the whole stream to one device.

Reference counterparts: the lower PHY streams samples symbol-by-symbol on one
thread and never parallelizes the sample axis
(reference: lib/phy/lower/lower_phy_baseband_processor.cpp:78-196,
lib/phy/lower/modulation/ofdm_demodulator_impl.cpp:94); amplitude control /
filters run per block in place (lib/phy/lower/amplitude_controller). Here a
slot's samples split over the mesh and every stage is collective-free except
one halo ppermute.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import ofdm as ofdm_mod


def shard_samples(samples, mesh: Mesh, axis: str = "sp",
                  batch_axis: str | None = None):
    """Place (..., nsamples, 2) with the sample axis sharded over `axis`
    (and optionally the leading batch dim over `batch_axis`)."""
    n = mesh.shape[axis]
    nsamples = samples.shape[-2]
    pad = (-nsamples) % n
    if pad:
        pad_w = [(0, 0)] * (samples.ndim - 2) + [(0, pad), (0, 0)]
        samples = jnp.pad(jnp.asarray(samples), pad_w)
    spec = [None] * samples.ndim
    spec[-2] = axis
    if batch_axis is not None:
        spec[0] = batch_axis
    return jax.device_put(samples, NamedSharding(mesh, P(*spec)))


def _specs(ndim: int, axis: str, batch_axis: str | None, trailing: int = 1):
    """PartitionSpec with the sample dim at -1-trailing sharded over `axis`."""
    spec = [None] * ndim
    spec[-1 - trailing] = axis
    if batch_axis is not None:
        spec[0] = batch_axis
    return P(*spec)


def _ring_halo(x, n: int, axis_name: str, from_right: bool):
    """Exchange an n-sample halo (axis -2) around the ring.

    from_right=False: each device receives the LAST n samples of its left
    neighbour (stream history; first shard gets zeros). from_right=True: each
    device receives the FIRST n samples of its right neighbour (stream
    future; last shard gets zeros).
    """
    nof = jax.lax.psum(1, axis_name)
    idx = jax.lax.axis_index(axis_name)
    if from_right:
        piece = x[..., :n, :]
        perm = [(d, (d - 1) % nof) for d in range(nof)]
        mask = idx == nof - 1
    else:
        piece = x[..., -n:, :]
        perm = [(d, (d + 1) % nof) for d in range(nof)]
        mask = idx == 0
    halo = jax.lax.ppermute(piece, axis_name, perm)
    return jnp.where(mask, jnp.zeros_like(halo), halo)


def fir_filter_overlap_save(samples, taps, mesh: Mesh, axis: str = "sp",
                            batch_axis: str | None = None):
    """Causal FIR filter over a sample-axis-sharded stream.

    y[n] = sum_k taps[k] x[n-k], computed shard-locally after an
    (ntaps-1)-sample halo exchange from the left ring neighbour (the
    overlap-save method): one ppermute per call regardless of stream length.
    Zero initial state, matching scipy.signal.lfilter.

    Args:
      samples: (..., nsamples, 2) real-pair stream; nsamples divisible by
        the mesh axis size.
      taps: (ntaps,) real or (ntaps, 2) complex-pair filter taps.

    Returns the filtered stream, same shape/sharding.
    """
    taps = np.asarray(taps, np.float32)
    if taps.ndim == 1:
        taps = np.stack([taps, np.zeros_like(taps)], -1)
    ntaps = taps.shape[0]
    halo_n = ntaps - 1

    def local(x):
        if halo_n:
            halo = _ring_halo(x, halo_n, axis, from_right=False)
            ext = jnp.concatenate([halo, x], axis=-2)
        else:
            ext = x
        xr, xi = ext[..., 0], ext[..., 1]
        n_local = x.shape[-2]
        acc_r = jnp.zeros(x.shape[:-1], jnp.float32)
        acc_i = jnp.zeros(x.shape[:-1], jnp.float32)
        for k in range(ntaps):
            # y[n] += h[k] * x[n-k]: x index (halo_n + n - k) into ext.
            seg_r = jax.lax.dynamic_slice_in_dim(xr, halo_n - k, n_local, -1)
            seg_i = jax.lax.dynamic_slice_in_dim(xi, halo_n - k, n_local, -1)
            acc_r = acc_r + taps[k, 0] * seg_r - taps[k, 1] * seg_i
            acc_i = acc_i + taps[k, 0] * seg_i + taps[k, 1] * seg_r
        return jnp.stack([acc_r, acc_i], axis=-1)

    spec = _specs(samples.ndim, axis, batch_axis)
    fn = shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec)
    return jax.jit(fn)(samples)


def _demod_plan(nsamples_padded: int, n_shards: int, dft_size: int, mu: int,
                slot_in_subframe: int, cp: str):
    """Static owner/offset tables for sample-sharded OFDM demodulation."""
    cps = ofdm_mod.cp_lengths(dft_size, mu, slot_in_subframe, cp)
    nsym = len(cps)
    shard = nsamples_padded // n_shards
    offs, owners = [], []
    t = 0
    for l in range(nsym):
        off = t + cps[l]
        offs.append(off)
        owners.append(off // shard)
        t += cps[l] + dft_size
    per_shard = max(sum(1 for o in owners if o == d) for d in range(n_shards))
    local_off = np.zeros((n_shards, per_shard), np.int32)
    sym_id = np.zeros((n_shards, per_shard), np.int32)
    valid = np.zeros((n_shards, per_shard), bool)
    fill = [0] * n_shards
    halo_n = 0
    for l, (off, d) in enumerate(zip(offs, owners)):
        j = fill[d]
        local_off[d, j] = off - d * shard
        sym_id[d, j] = l
        valid[d, j] = True
        fill[d] += 1
        halo_n = max(halo_n, off + dft_size - (d + 1) * shard)
    halo_n = max(int(halo_n), 0)
    if halo_n > shard:
        raise ValueError(
            f"shard of {shard} samples too small for {dft_size}-point windows:"
            f" needs {halo_n}-sample halo; use fewer shards")
    return local_off, sym_id, valid, halo_n, per_shard, nsym, shard


def sharded_ofdm_demodulate(samples_pair, nsubc: int, dft_size: int, mu: int,
                            mesh: Mesh, slot_in_subframe: int = 0,
                            center_freq_hz: float = 0.0, scale: float = 1.0,
                            cp: str = "normal", axis: str = "sp",
                            batch_axis: str | None = None):
    """OFDM slot demodulation with the time-sample axis sharded over `mesh`.

    Each device owns the DFT windows starting inside its shard and fetches
    up to one window of halo samples from its right ring neighbour —
    overlap-save halos. Numerically identical to ops.ofdm.ofdm_demodulate.

    Args:
      samples_pair: (..., nsamples, 2) slot baseband (host or device).

    Returns (..., nsym, nsubc, 2) resource grid (replicated).
    """
    n = mesh.shape[axis]
    nsamples = samples_pair.shape[-2]
    padded = -(-nsamples // n) * n
    if padded != nsamples:
        pad_w = [(0, 0)] * (samples_pair.ndim - 2) + [(0, padded - nsamples), (0, 0)]
        samples_pair = jnp.asarray(samples_pair)
        samples_pair = jnp.pad(samples_pair, pad_w)

    local_off, sym_id, valid, halo_n, per_shard, nsym, shard = _demod_plan(
        padded, n, dft_size, mu, slot_in_subframe, cp)
    phase = np.conj(ofdm_mod._phase_compensation(
        dft_size, mu, slot_in_subframe, center_freq_hz, cp))
    phase_pair = np.stack([phase.real, phase.imag], -1).astype(np.float32)

    def local(x):
        halo = _ring_halo(x, max(halo_n, 1), axis, from_right=True)
        ext = jnp.concatenate([x, halo], axis=-2)  # (..., shard+halo, 2)
        d = jax.lax.axis_index(axis)
        my_off = jnp.asarray(local_off)[d]      # (per_shard,)
        my_sym = jnp.asarray(sym_id)[d]
        wins = []
        for p in range(per_shard):
            wins.append(jax.lax.dynamic_slice_in_dim(
                ext, my_off[p], dft_size, axis=-2))
        w = jnp.stack(wins, axis=-3)  # (..., per_shard, dft, 2)
        wc = w[..., 0] + 1j * w[..., 1]
        bins = jnp.fft.fft(wc, axis=-1) / jnp.complex64(dft_size)
        ph = jnp.asarray(phase_pair)[my_sym]  # (per_shard, 2)
        phc = (ph[..., 0] + 1j * ph[..., 1])[..., None]
        bins = bins * phc
        half = nsubc // 2
        grid = jnp.concatenate(
            [bins[..., dft_size - half:], bins[..., : nsubc - half]], axis=-1
        ) * jnp.complex64(scale)
        return jnp.stack([grid.real, grid.imag], axis=-1)

    in_spec = _specs(samples_pair.ndim, axis, batch_axis)
    out_spec = _specs(samples_pair.ndim + 1, axis, batch_axis, trailing=2)
    fn = shard_map(local, mesh=mesh, in_specs=(in_spec,), out_specs=out_spec)
    stacked = jax.jit(fn)(
        shard_samples(jnp.asarray(samples_pair), mesh, axis, batch_axis))
    # (..., n*per_shard, nsubc, 2) in shard order -> slot symbol order.
    order = np.full(nsym, -1, np.int64)
    for d in range(n):
        for p in range(per_shard):
            if valid[d, p]:
                order[sym_id[d, p]] = d * per_shard + p
    assert (order >= 0).all()
    return jnp.take(stacked, jnp.asarray(order), axis=-3)
