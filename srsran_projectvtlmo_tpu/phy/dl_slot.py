"""Fused device-side DL slot assembly: PDSCH (with real precoding) + PDCCH +
SSB + CSI-RS onto multi-port resource grids, then OFDM modulation — one jitted
program per slot *structure*.

Replaces the reference's per-RE resource-grid-mapper loops
(reference: lib/phy/support/resource_grid_mapper_impl.cpp,
include/srsran/phy/generic_functions/precoding/channel_precoder.h:49-61,
lib/phy/upper/channel_processors/pdsch_processor_concurrent_impl.cpp:31-58)
with a *gather plan*: every RE of every port grid is produced by ONE
`jnp.take` from a concatenated source buffer (zero RE + each channel's
precoded symbols), with all index math done once on the host at plan-build
time.  Slot-dependent VALUES (DM-RS/CSI-RS pilots, DCI codewords) are program
*inputs*, so a steady-state cell never recompiles across slots.

Precoding is applied per PDSCH as a configurable (P x L) matrix einsum
(`ops.precoding.precode`), 1-4 layers onto up to 4 ports; DM-RS type 1 maps
layers {0,1} to CDM group 0 (even subcarriers, fd-OCC +/+ and +/-) and layers
{2,3} to CDM group 1 (odd subcarriers), per TS 38.211 Table 7.4.1.1.2-1.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..fapi.pdus import DlTtiRequest, PdschPdu, PdcchPdu
from ..models.pdsch_tx import PdschTxConfig
from ..models.sch_tx import (
    build_sch_symbols_tx_dyn, sch_k0_prime, sch_scramble_planes)
from ..ops import ofdm as ofdm_mod
from ..ops.precoding import layer_map, precode, identity_precoder
from ..ran.pdcch_mapping import (
    cce_to_reg_non_interleaved, cce_to_reg_interleaved, pdcch_coreset_prbs,
    pdcch_re_indices,
)
from ..utils.cplx import to_cplx, from_cplx


def _pdsch_cfg(pdu: PdschPdu, cell) -> PdschTxConfig:
    return PdschTxConfig(
        nof_rb=pdu.rb_size, modulation=pdu.modulation,
        target_code_rate=pdu.target_code_rate, nof_layers=pdu.nof_layers,
        nof_ofdm_symbols=pdu.nof_symbols,
        dmrs_symbols=tuple(s - pdu.start_symbol for s in pdu.dmrs_symbols),
        rv=pdu.rv, rnti=pdu.rnti, n_id=pdu.n_id,
        start_symbol=pdu.start_symbol, rb_start=pdu.rb_start,
        dft_size=cell.dft_size, numerology=cell.numerology,
        reserved=tuple(getattr(pdu, "reserved", ()) or ()),
    )


def _pdsch_symbol_plans(pdu: PdschPdu, cfg: PdschTxConfig):
    """Hole-aware mapping plan when the PDU carries reserved RE patterns:
    per data symbol, maximal runs of allocation RBs sharing one free-RE
    submask become segments — "full" (contiguous slice) or "comb"
    (reshape + static column writes), both scatter-free.  Returns a list of
    (abs_symbol, [("full", sub0, nsub) | ("comb", sub0, n_rb, free_offs)])
    in RE-stream order (reference: resource_grid_mapper skips reserved REs
    in mapping order, pdsch_processor_impl.cpp:77-96)."""
    from ..ran.re_pattern import reserved_mask_window

    abs_data = [pdu.start_symbol + int(s) for s in cfg.data_symbols]
    mask = reserved_mask_window(cfg.reserved, pdu.rb_start, pdu.rb_size,
                                abs_data)  # (nd, nsub) True = reserved
    dmrs_abs = [pdu.start_symbol + int(s) for s in cfg.dmrs_symbols]
    dm = reserved_mask_window(cfg.reserved, pdu.rb_start, pdu.rb_size,
                              dmrs_abs)
    assert not dm.any(), \
        "reserved REs on PDSCH DM-RS symbols are unsupported (the scheduler " \
        "must not collide CSI-RS/CORESET with DM-RS; reference merges them " \
        "into one pattern but asserts no DM-RS collision upstream)"
    plans = []
    for di, sym in enumerate(abs_data):
        free = ~mask[di].reshape(pdu.rb_size, 12)
        segs = []
        rb = 0
        while rb < pdu.rb_size:
            sub = free[rb]
            rb2 = rb + 1
            while rb2 < pdu.rb_size and np.array_equal(free[rb2], sub):
                rb2 += 1
            if sub.all():
                segs.append(("full", rb * 12, (rb2 - rb) * 12))
            elif sub.any():
                segs.append(("comb", rb * 12, rb2 - rb,
                             tuple(int(k) for k in np.where(sub)[0])))
            rb = rb2
        plans.append((sym, segs))
    return plans


def _precoding_matrix(pdu: PdschPdu, nof_ports: int) -> np.ndarray:
    """(P, L, 2) float32 precoding weights for the PDU."""
    if getattr(pdu, "precoding", None) is None:
        return identity_precoder(nof_ports, pdu.nof_layers)
    w = np.asarray(pdu.precoding, np.float32)  # (P, L, 2)
    assert w.shape == (nof_ports, pdu.nof_layers, 2), \
        f"precoding shape {w.shape} != ({nof_ports}, {pdu.nof_layers}, 2)"
    return w


def _pdcch_plan(pdu: PdcchPdu, cell):
    """Host index plan for one PDCCH candidate: (prbs, data_idx, dmrs_idx)."""
    if pdu.interleaved:
        regs = cce_to_reg_interleaved(
            pdu.coreset_nof_rb, pdu.duration, pdu.reg_bundle_size,
            pdu.interleaver_size, pdu.shift_index,
            pdu.aggregation_level, pdu.cce_index)
    else:
        regs = cce_to_reg_non_interleaved(pdu.aggregation_level, pdu.cce_index)
    offsets = pdu.coreset_rb_start + np.arange(pdu.coreset_nof_rb)
    prbs = pdcch_coreset_prbs(regs, pdu.duration, offsets)
    data_idx, dmrs_idx = pdcch_re_indices(
        prbs, pdu.duration, pdu.start_symbol, cell.nof_subc)
    return prbs, data_idx, dmrs_idx


#: Per-layer fd-OCC within its CDM group: w_f(k') for k' in {0, 1}.
_OCC = {0: (1.0, 1.0), 1: (1.0, -1.0), 2: (1.0, 1.0), 3: (1.0, -1.0)}


def _shape_pdsch(pdu: PdschPdu) -> PdschPdu:
    """Strip value-only fields so the compile key covers shape alone.

    rnti/n_id (scrambling sequence), rv (rate-match indices) and the
    precoding weights ride as device inputs — a steady-state cell with a
    CHANGING UE set compiles exactly one DL program per slot structure
    (reference analog: per-slot PDU churn is the normal case,
    lib/fapi_adaptor/phy/fapi_to_phy_translator.cpp:290-351)."""
    return dataclasses.replace(pdu, rnti=0, n_id=0, rv=0, precoding=None)


def _shape_pdcch(pdu: PdcchPdu) -> PdcchPdu:
    """PDCCH value-only fields (scrambling/CRC-mask identities and the
    precoding vector) stripped; the candidate's CCE/REG geometry stays."""
    return dataclasses.replace(pdu, rnti=0, n_id=0, n_rnti=0, precoding=None)


def _shape_csi_rs(pdu) -> object:
    """CSI-RS value-only field (the Gold-sequence scrambling identity)
    stripped; the row/k_ref/density RE geometry stays — the pilot VALUES
    arrive as device inputs, so a scrambling_id change must not recompile."""
    return dataclasses.replace(pdu, scrambling_id=0)


def _port_vector(precoding, nof_ports: int) -> np.ndarray:
    """(P, 2) float32 single-layer port weights; None = port 0 only."""
    if precoding is None:
        w = np.zeros((nof_ports, 2), np.float32)
        w[0, 0] = 1.0
        return w
    w = np.asarray(precoding, np.float32)
    assert w.shape == (nof_ports, 2), \
        f"port precoding shape {w.shape} != ({nof_ports}, 2)"
    return w


@dataclass(frozen=True)
class DlSlotPlanKey:
    """The compile-cache key: everything shape/index-determining, NOT the slot
    and not per-UE values (PDU tuples are `_shape_pdsch`/`_shape_pdcch`
    normalized)."""
    cell_nof_rb: int
    cell_dft_size: int
    numerology: int
    nof_tx_ports: int
    pdsch: tuple[PdschPdu, ...]
    pdcch: tuple[PdcchPdu, ...]
    nof_ssb: int
    #: Shape-normalized CSI-RS PDUs (row/k_ref/density determine the per-port
    #: RE layout; scrambling values ride as inputs).
    csi_rs: tuple = ()
    ssb_k0: tuple[int, ...] = ()


class DlSlotProgram:
    """One compiled DL slot assembly for a fixed slot structure.

    Program inputs (device arrays, slot-dependent values):
      tb_bits:     tuple of (TBS_i,) uint8
      pdsch_dmrs:  tuple of (ndmrs, npil, 2) float32 base pilot sequences
      pdcch_syms:  tuple of (n_re, 2) float32 candidate REs (data + DM-RS
                   combined, host-permuted into block order — see
                   build_dl_slot_inputs)
      pdcch_dmrs:  () — retained for signature stability (values ride
                   combined in pdcch_syms)
      ssb_grids:   tuple of (4, 240, 2) float32 assembled SSB blocks
      csi_vals:    tuple of (nof_rb, 2) float32
      pdsch_scr:   tuple of (G_i,) uint8 scrambling sequences (rnti/n_id)
      pdsch_rm:    tuple of per-PDU tuples of (E,) int32 rate-match gathers (rv)
      pdsch_w:     tuple of (P, L, 2) float32 precoding matrices
    """

    def __init__(self, key: "DlSlotPlanKey", cell):
        self.key = key
        self.cell = cell
        p = key.nof_tx_ports

        # --- PDSCH: contiguous symbol runs + DM-RS comb interleave ----------
        self.pdsch_cfgs = [_pdsch_cfg(pdu, cell) for pdu in key.pdsch]
        self.pdsch_tx = [build_sch_symbols_tx_dyn(cfg) for cfg in self.pdsch_cfgs]
        self.pdsch_layout = []
        for pdu, cfg in zip(key.pdsch, self.pdsch_cfgs):
            abs_data = [pdu.start_symbol + int(s) for s in cfg.data_symbols]
            runs = []  # (abs_sym_start, count, offset into data-symbol axis)
            start = prev = abs_data[0]
            off0 = 0
            for di, s in enumerate(abs_data[1:], 1):
                if s != prev + 1:
                    runs.append((start, prev - start + 1, off0))
                    start = s
                    off0 = di
                prev = s
            runs.append((start, prev - start + 1, off0))
            self.pdsch_layout.append({
                "k0": pdu.rb_start * 12,
                "nsub": cfg.nof_subc,
                "runs": runs,
                "dmrs_abs": [pdu.start_symbol + int(s)
                             for s in cfg.dmrs_symbols],
                #: Hole-aware per-symbol segment plan when the PDU reserves
                #: REs (CSI-RS/CORESET rate matching); None = fast path.
                "plans": (_pdsch_symbol_plans(pdu, cfg)
                          if cfg.reserved else None),
            })

        # --- PDCCH: per-candidate block span, scatter-free ------------------
        # The candidate's REs cover FULL PRBs (each REG occupies all 12
        # subcarriers: 9 data + 3 DM-RS), so with the VALUES host-permuted
        # into block order (build_dl_slot_inputs applies `order`) the device
        # assembly is a reshape + a tiny one-hot matmul that places the
        # occupied PRBs into the span — no scatter, which would lower to a
        # per-element loop once the values batch (the multi-cell program).
        self.pdcch_prbs: list[list[int]] = []
        self.pdcch_layout = []
        for pdu in key.pdcch:
            prbs, data_idx, dmrs_idx = _pdcch_plan(pdu, cell)
            self.pdcch_prbs.append(prbs)
            sp0 = min(prbs) * 12
            sp1 = (max(prbs) + 1) * 12
            span = sp1 - sp0
            s0 = pdu.start_symbol

            def local(flat):
                sym = flat // cell.nof_subc
                sub = flat % cell.nof_subc
                return (sym - s0) * span + (sub - sp0)

            pos = np.asarray([local(f) for f in np.concatenate(
                [data_idx, dmrs_idx])], np.int64)
            order = np.argsort(pos)
            pos_sorted = pos[order]
            prb_off = np.unique((pos_sorted % span) // 12)
            nprb = len(prb_off)
            # Full-PRB occupancy, identical PRB set per symbol.
            grid_pos = (np.arange(pdu.duration)[:, None, None] * span
                        + prb_off[None, :, None] * 12
                        + np.arange(12)[None, None, :]).reshape(-1)
            assert np.array_equal(pos_sorted, grid_pos), \
                "PDCCH candidate does not occupy full PRBs"
            onehot = np.zeros((span // 12, nprb), np.float32)
            onehot[prb_off, np.arange(nprb)] = 1.0
            self.pdcch_layout.append({
                "s0": s0, "dur": pdu.duration, "sp0": sp0, "span": span,
                "order": order, "nprb": nprb,
                "onehot": jnp.asarray(onehot),
            })

        # --- CSI-RS: per-port regular comb patterns -------------------------
        from ..ops.csi_rs import CsiRsConfig, csi_rs_pattern
        self.csi_layouts = []
        for pdu in key.csi_rs:
            cfgc = CsiRsConfig(
                nof_rb=pdu.nof_rb, prb_start=pdu.prb_start, row=pdu.row,
                k_ref=pdu.k_ref, symbol=pdu.symbol, density=pdu.density,
                symbol_l1=getattr(pdu, "symbol_l1", 8),
                subcarrier_offset=pdu.subcarrier_offset,
                scrambling_id=pdu.scrambling_id, slot=0)
            pat = csi_rs_pattern(cfgc)  # layout; values arrive per slot
            assert len(pat) <= p, \
                f"CSI-RS row {pdu.row} needs {len(pat)} ports > cell's {p}"
            ports = []
            for port, (symbols, subc, _) in enumerate(pat):
                rbs = np.unique(subc // 12)
                n_off = len(subc) // len(rbs)
                k_offs = (subc[:n_off] - rbs[0] * 12).tolist()
                # Occupied RBs are contiguous (density 1/3) or stride 2 (.5).
                stride = 1 if len(rbs) == 1 else int(rbs[1] - rbs[0])
                assert np.all(np.diff(rbs) == stride), "irregular CSI-RS RBs"
                ports.append({
                    "symbols": [int(s) for s in symbols],
                    "rb0": int(rbs[0]), "n_rb": len(rbs), "stride": stride,
                    "k_offs": k_offs,
                })
            self.csi_layouts.append(ports)

        self._compiled = jax.jit(self._assemble, static_argnums=(0,))

    def _dmrs_port_pilots(self, i: int, pil, w_pair):
        """Base pilots (ndmrs, npil, 2) -> per-port comb values
        (P, ndmrs, 2, npil, 2): precoded CDM-group pilots for both combs."""
        cfg = self.pdsch_cfgs[i]
        w = to_cplx(w_pair)  # (P, L)
        pil_c = to_cplx(pil)  # (ndm, npil)
        nl = cfg.nof_layers
        npil = pil_c.shape[-1]
        occ = np.zeros((2, nl, npil), np.complex64)  # (comb, layer, npil)
        for l in range(nl):
            comb = l // 2
            w0, w1 = _OCC[l]
            occ[comb, l, 0::2] = w0
            occ[comb, l, 1::2] = w1
        # port x comb pilots: sum_l w[p,l] * occ[comb,l,:] * pil
        out = jnp.einsum("pl,cln,mn->pmcn", w, jnp.asarray(occ), pil_c)
        return from_cplx(out)  # (P, ndm, 2, npil, 2)

    @staticmethod
    def _weighted(w_p, val_pair):
        """Complex multiply one port weight (2,) by values (..., 2)."""
        wr, wi = w_p[0], w_p[1]
        vr, vi = val_pair[..., 0], val_pair[..., 1]
        return jnp.stack([wr * vr - wi * vi, wr * vi + wi * vr], axis=-1)

    def _assemble(self, slot_in_sf: int, tb_bits, pdsch_dmrs, pdcch_syms,
                  pdcch_dmrs, ssb_grids, csi_vals, pdsch_scr, pdsch_rm,
                  pdsch_w, pdcch_w, ssb_w):
        p = self.key.nof_tx_ports
        s_carrier = self.cell.nof_subc
        grid = jnp.zeros((p, 14, s_carrier, 2), jnp.float32)

        # PDSCH: data runs land as contiguous dynamic-update-slices; DM-RS
        # rows come from a comb interleave reshape — no RE gather anywhere.
        for i, cfg in enumerate(self.pdsch_cfgs):
            lay = self.pdsch_layout[i]
            w = pdsch_w[i]
            syms = self.pdsch_tx[i](tb_bits[i][None], pdsch_scr[i],
                                    pdsch_rm[i])[0]  # (G,) complex
            sym_pair = jnp.stack([jnp.real(syms), jnp.imag(syms)], -1)
            layers = layer_map(jnp.moveaxis(sym_pair, -1, 0), cfg.nof_layers)
            layers = jnp.moveaxis(layers, 0, -1)  # (L, M, 2)
            ports = precode(layers, w)  # (P, nre, 2)
            if lay["plans"] is None:
                nd = len(cfg.data_symbols)
                blocks = ports.reshape(p, nd, lay["nsub"], 2)
                for (sym0, count, off) in lay["runs"]:
                    grid = jax.lax.dynamic_update_slice(
                        grid, blocks[:, off:off + count], (0, sym0, lay["k0"], 0))
            else:
                # Reserved-RE rate matching: consume the (reduced) RE stream
                # in mapping order, skipping the reserved holes — contiguous
                # slices for full segments, reshape + static column writes
                # for per-RB comb holes.  Scatter-free.
                off = 0
                for sym, segs in lay["plans"]:
                    for seg in segs:
                        if seg[0] == "full":
                            _, sub0, nsub = seg
                            vals = ports[:, off:off + nsub][:, None]
                            grid = jax.lax.dynamic_update_slice(
                                grid, vals, (0, sym, lay["k0"] + sub0, 0))
                            off += nsub
                        else:
                            _, sub0, n_rb, free_offs = seg
                            f = len(free_offs)
                            vals = ports[:, off:off + n_rb * f].reshape(
                                p, n_rb, f, 2)
                            blk = jnp.zeros((p, n_rb, 12, 2), jnp.float32)
                            for j, ko in enumerate(free_offs):
                                blk = blk.at[:, :, ko].set(vals[:, :, j])
                            grid = jax.lax.dynamic_update_slice(
                                grid, blk.reshape(p, 1, n_rb * 12, 2),
                                (0, sym, lay["k0"] + sub0, 0))
                            off += n_rb * f
            dm = self._dmrs_port_pilots(i, pdsch_dmrs[i], w)  # (P, ndm, 2, npil, 2)
            rows = jnp.transpose(dm, (0, 1, 3, 2, 4)).reshape(
                p, dm.shape[1], -1, 2)  # (P, ndm, 2*npil, 2) comb-interleaved
            for mi, sym in enumerate(lay["dmrs_abs"]):
                grid = jax.lax.dynamic_update_slice(
                    grid, rows[:, mi:mi + 1], (0, sym, lay["k0"], 0))

        # PDCCH: values arrive block-ordered (data + DM-RS pre-permuted on
        # the host); a reshape exposes the (sym, prb, subc) structure and a
        # one-hot matmul places the occupied PRBs into the span — ADDED so
        # co-scheduled channels elsewhere survive.  No scatter anywhere.
        for i, lay in enumerate(self.pdcch_layout):
            w_rows = jnp.stack([self._weighted(pdcch_w[i][pi], pdcch_syms[i])
                                for pi in range(p)])  # (P, n_re, 2)
            rows = w_rows.reshape(p, lay["dur"], lay["nprb"], 12, 2)
            block = jnp.einsum("sp,adpkr->adskr", lay["onehot"], rows,
                               preferred_element_type=jnp.float32)
            block = block.reshape(p, lay["dur"], lay["span"], 2)
            grid = grid.at[:, lay["s0"]:lay["s0"] + lay["dur"],
                           lay["sp0"]:lay["sp0"] + lay["span"]].add(block)

        # SSB: contiguous 240-subcarrier block on symbols 0-3 per port.
        for b in range(self.key.nof_ssb):
            k0 = self.key.ssb_k0[b]
            blk = jnp.stack([self._weighted(ssb_w[b][pi], ssb_grids[b])
                             for pi in range(p)])  # (P, 4, 240, 2)
            grid = grid.at[:, 0:4, k0:k0 + blk.shape[2]].add(blk)

        # CSI-RS: comb patterns built with scalar-index column writes and RB
        # reshapes; values arrive flat in (port, symbol, subc) order.
        for i, ports_lay in enumerate(self.csi_layouts):
            vals = csi_vals[i]
            off = 0
            for port, pl in enumerate(ports_lay):
                n_rb, n_off = pl["n_rb"], len(pl["k_offs"])
                for sym in pl["symbols"]:
                    v = vals[off:off + n_rb * n_off].reshape(n_rb, n_off, 2)
                    off += n_rb * n_off
                    rb_block = jnp.zeros((n_rb, 12, 2), jnp.float32)
                    for j, ko in enumerate(pl["k_offs"]):
                        rb_block = rb_block.at[:, ko].set(v[:, j])
                    if pl["stride"] == 1:
                        row = rb_block.reshape(n_rb * 12, 2)
                    else:
                        # Density 0.5: zero RB between occupied RBs.
                        z = jnp.zeros_like(rb_block)
                        row = jnp.stack([rb_block, z], axis=1).reshape(
                            n_rb * 2 * 12, 2)[: (n_rb * 2 - 1) * 12]
                    grid = grid.at[port, sym,
                                   pl["rb0"] * 12:pl["rb0"] * 12 + row.shape[0]
                                   ].add(row)
        if getattr(self.cell, "grid_bf16", False):
            # cbf16 grid storage (reference: resource_grid_impl.h:41-51):
            # everything above accumulated in float32; the materialized
            # grid — what the modulator reads and what leaves the device —
            # is bfloat16 real pairs (half the HBM traffic).  The OFDM
            # modulate upcasts per-symbol for the FFT.
            grid = grid.astype(jnp.bfloat16)
        samples = ofdm_mod.ofdm_modulate(
            grid, self.cell.dft_size, self.cell.numerology, slot_in_sf)
        return grid, samples

    def _value_args(self, slot: int, tb_bits, pdsch_dmrs, pdcch_syms,
                    pdcch_dmrs, ssb_grids, csi_vals, pdsch_pdus, pdcch_pdus,
                    ssb_pdus):
        """Build the per-slot VALUE argument tuple for `_assemble` (all the
        non-static inputs, in signature order after slot_in_sf)."""
        pdus = tuple(pdsch_pdus) if pdsch_pdus else self.key.pdsch
        p = self.key.nof_tx_ports
        scr, rm_idx, ws = [], [], []
        for pdu, cfg in zip(pdus, self.pdsch_cfgs):
            scr.append(_scramble_planes(cfg, pdu.rnti, pdu.n_id))
            rm_idx.append(_k0_prime(cfg, pdu.rv))
            ws.append(jnp.asarray(_precoding_matrix(pdu, p)))
        cpdus = tuple(pdcch_pdus) if pdcch_pdus else self.key.pdcch
        pw = tuple(jnp.asarray(_port_vector(getattr(c, "precoding", None), p))
                   for c in cpdus)
        spdus = tuple(ssb_pdus) if ssb_pdus else (None,) * self.key.nof_ssb
        sw = tuple(jnp.asarray(_port_vector(getattr(s, "precoding", None), p))
                   for s in spdus)
        return (tuple(tb_bits), tuple(pdsch_dmrs), tuple(pdcch_syms),
                tuple(pdcch_dmrs), tuple(ssb_grids), tuple(csi_vals),
                tuple(scr), tuple(rm_idx), tuple(ws), pw, sw)

    def _batched_fn(self, slot_in_sf: int):
        """Jitted vmap of the slot assembly over a leading batch axis on
        EVERY value input: slots of one cell, or one slot of many same-
        structure cells (the du_low multi-cell DL analog of the reference's
        per-cell upper_phy instances, lib/du_low/du_low_impl.h:31-48).
        Amortizes per-op overheads: the single-slot program is launch/layout
        bound at ~1.4x real time while the B=8 batch exceeds 3x."""
        if not hasattr(self, "_batched_cache"):
            self._batched_cache = {}
        if slot_in_sf not in self._batched_cache:
            f = functools.partial(self._assemble, slot_in_sf)
            self._batched_cache[slot_in_sf] = jax.jit(jax.vmap(f))
        return self._batched_cache[slot_in_sf]

    @staticmethod
    def stack_values(value_args_batch, shard_fn=None):
        """Stack per-entry `_value_args(...)` tuples onto a leading batch
        axis.  `shard_fn` (optional) maps each stacked leaf to a device
        placement — the multi-cell path shards the batch axis over the mesh
        "cell" axis."""
        stacked = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *value_args_batch)
        if shard_fn is not None:
            stacked = jax.tree_util.tree_map(shard_fn, stacked)
        return stacked

    def run_stacked(self, slot: int, stacked):
        """Execute the batched slot assembly on pre-stacked value args.
        Returns (grid (B, P, 14, nsubc, 2), samples (B, P, nsamples, 2))."""
        return self._batched_fn(slot % (1 << self.cell.numerology))(*stacked)

    def run_batched(self, slot: int, value_args_batch, shard_fn=None):
        """`stack_values` + `run_stacked` in one call (per-slot batches
        whose values change every call; steady-value benches should
        pre-stack once)."""
        return self.run_stacked(slot,
                                self.stack_values(value_args_batch, shard_fn))

    def run(self, slot: int, tb_bits=(), pdsch_dmrs=(), pdcch_syms=(),
            pdcch_dmrs=(), ssb_grids=(), csi_vals=(), pdsch_pdus=(),
            pdcch_pdus=(), ssb_pdus=()):
        """Execute the compiled slot program.

        `pdsch_pdus`/`pdcch_pdus`/`ssb_pdus` are the ORIGINAL (un-normalized)
        PDUs carrying the per-UE values (rnti/n_id/rv/precoding); when
        omitted, the key's normalized PDUs are used (rnti=0, rv=0, identity
        layer->port precoding; port-0 PDCCH/SSB)."""
        slot_in_sf = slot % (1 << self.cell.numerology)
        args = self._value_args(slot, tb_bits, pdsch_dmrs, pdcch_syms,
                                pdcch_dmrs, ssb_grids, csi_vals, pdsch_pdus,
                                pdcch_pdus, ssb_pdus)
        return self._compiled(slot_in_sf, *args)


@functools.lru_cache(maxsize=512)
def _scramble_planes(cfg, rnti: int, n_id: int):
    return tuple(jnp.asarray(p) for p in sch_scramble_planes(cfg, rnti, n_id))


@functools.lru_cache(maxsize=256)
def _k0_prime(cfg, rv: int):
    """rv as a one-hot selector over the 4 static k0' slices (see
    build_sch_symbols_tx_dyn)."""
    oh = np.zeros(4, np.uint8)
    oh[rv] = 1
    return jnp.asarray(oh)


@functools.lru_cache(maxsize=64)
def _cached_program(key: DlSlotPlanKey, cell) -> DlSlotProgram:
    return DlSlotProgram(key, cell)


def plan_key_for(request: DlTtiRequest, cell) -> DlSlotPlanKey:
    return DlSlotPlanKey(
        cell_nof_rb=cell.nof_rb,
        cell_dft_size=cell.dft_size,
        numerology=cell.numerology,
        nof_tx_ports=cell.nof_tx_ports,
        pdsch=tuple(_shape_pdsch(p) for p in request.pdsch),
        pdcch=tuple(_shape_pdcch(p) for p in request.pdcch),
        nof_ssb=len(request.ssb),
        csi_rs=tuple(_shape_csi_rs(p) for p in getattr(request, "csi_rs", ())),
        ssb_k0=tuple(cell.ssb_subc_offset + s.ssb_offset_pointa * 12
                     for s in request.ssb),
    )


def get_dl_slot_program(request: DlTtiRequest, cell) -> DlSlotProgram:
    return _cached_program(plan_key_for(request, cell), cell)


def build_dl_slot_inputs(program: DlSlotProgram, request: DlTtiRequest,
                         tx_data, slot: int):
    """Host-side per-slot VALUE inputs for one cell's DL slot: TB bits,
    DM-RS/PDCCH/SSB/CSI-RS pilot values.  Shared by the per-cell UpperPhy
    and the batched multi-cell DL path."""
    from ..ops.dmrs import dmrs_type1_sequence
    from ..utils.cplx import np_to_pair
    from . import pbch as pbch_mod
    from . import pdcch as pdcch_mod

    tb_bits, pdsch_dmrs = [], []
    for i, pdu in enumerate(request.pdsch):
        sch_cfg = program.pdsch_cfgs[i]
        tb = (tx_data.tb_bits[i] if tx_data is not None
              else np.zeros(sch_cfg.tbs, np.uint8))
        assert len(tb) == sch_cfg.tbs, f"TB size {len(tb)} != {sch_cfg.tbs}"
        tb_bits.append(jnp.asarray(np.asarray(tb, np.uint8)))
        ref = np.stack([
            dmrs_type1_sequence(slot, s, pdu.n_id, pdu.rb_size,
                                prb_start=pdu.rb_start)
            for s in pdu.dmrs_symbols
        ])
        pdsch_dmrs.append(jnp.asarray(np_to_pair(ref)))

    # PDCCH: data + DM-RS values combined and host-permuted into the
    # candidate's block order (the device assembly is then scatter-free:
    # reshape + one-hot PRB placement; see DlSlotProgram pdcch_layout).
    pdcch_syms, pdcch_dmrs = [], []
    for i, pdu in enumerate(request.pdcch):
        payload = getattr(pdu, "payload", None)
        if payload is None:
            payload = np.zeros(pdu.nof_dci_bits, np.uint8)
        syms = pdcch_mod.pdcch_modulate(
            pdcch_mod.PdcchCandidateConfig(
                nof_dci_bits=pdu.nof_dci_bits,
                aggregation_level=pdu.aggregation_level,
                rnti=pdu.rnti, n_id=pdu.n_id, n_rnti=pdu.n_rnti,
            ),
            np.asarray(payload, np.uint8),
        )
        pil = pdcch_mod.pdcch_dmrs_values(
            slot, pdu.start_symbol, pdu.duration, program.pdcch_prbs[i],
            pdu.n_id)
        combined = np.concatenate([np_to_pair(syms), np_to_pair(pil)])
        pdcch_syms.append(jnp.asarray(
            combined[program.pdcch_layout[i]["order"]]))

    ssb_grids = []
    for ssb in request.ssb:
        msg = pbch_mod.PbchMessage(
            sfn=ssb.sfn, ssb_idx=ssb.ssb_block_index,
            half_radio_frame=ssb.half_radio_frame, n_id=ssb.phys_cell_id,
            l_max=ssb.l_max, mib_payload=ssb.mib_payload,
        )
        ssb_grids.append(jnp.asarray(np_to_pair(pbch_mod.assemble_ssb(msg))))

    csi_vals = []
    for pdu in request.csi_rs:
        from ..ops.csi_rs import CsiRsConfig, csi_rs_pattern

        pat = csi_rs_pattern(CsiRsConfig(
            nof_rb=pdu.nof_rb, prb_start=pdu.prb_start, row=pdu.row,
            k_ref=pdu.k_ref, density=pdu.density, symbol=pdu.symbol,
            symbol_l1=getattr(pdu, "symbol_l1", 8),
            subcarrier_offset=pdu.subcarrier_offset,
            scrambling_id=pdu.scrambling_id, slot=slot,
        ))
        flat = np.concatenate([v.reshape(-1) for (_, _, v) in pat])
        csi_vals.append(jnp.asarray(np_to_pair(flat)))

    return (tb_bits, pdsch_dmrs, pdcch_syms, pdcch_dmrs, ssb_grids, csi_vals)
