"""Multi-cell du_low: FAPI PDU sets per cell, sharded over the (cell, sp) mesh.

The reference's du_low owns one independent upper_phy per cell
(reference: lib/du_low/du_low_impl.h:31-48), distributing cells across
executors/machines.  Here cells with the same slot *structure* batch
into ONE device program on the mesh's cell axis — per-cell parameters
(rnti/n_id/slot sequences) ride as inputs via PuschRxConfig.dynamic_params,
so heterogeneous RNTIs do not recompile.  Each per-cell HARQ pool stays
host-managed; the soft buffers live in the same sharded batch.

Heterogeneous slot structures degrade to per-cell dispatch through the plain
UpperPhy (same behavior, no batching win).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..fapi.pdus import UlTtiRequest, CrcIndication, RxDataIndication
from ..models.pusch_rx import (
    PuschRxConfig, cached_pusch_rx_from_grid, flatten_tb_bits)
from ..ops import ofdm as ofdm_mod
from ..ops import prg as prg_mod
from ..phy.harq import RxBufferPool
from ..phy.upper_phy import CellConfig, UpperPhy
from ..utils.cplx import np_to_pair
from .distributed import RanMesh, make_ran_mesh


def _static_key(pdu) -> tuple:
    """Shape-determining PUSCH PDU fields (params that may vary per cell ride
    as inputs instead).  The second-hop PRB and the part2 map are included so
    one batched grid slice / one host decision table serves every cell."""
    return (pdu.rb_start, pdu.rb_size, pdu.modulation, pdu.target_code_rate,
            pdu.rv, pdu.nof_layers, pdu.start_symbol, pdu.nof_symbols,
            tuple(pdu.dmrs_symbols), pdu.nof_harq_ack_bits,
            getattr(pdu, "nof_csi_part1_bits", 0),
            tuple(getattr(pdu, "part2_size_map", ()) or ()),
            getattr(pdu, "dmrs_config_type", 1),
            getattr(pdu, "hop_symbol", None),
            getattr(pdu, "second_hop_prb", None))


class MultiCellUpperPhy:
    """N same-carrier cells processed as one sharded slot program."""

    def __init__(self, cfg: CellConfig, nof_cells: int,
                 ran_mesh: RanMesh | None = None,
                 expert: "ExpertPhyConfig | None" = None):
        from ..phy.upper_phy import ExpertPhyConfig

        self.cfg = cfg
        self.nof_cells = nof_cells
        self.expert = expert or ExpertPhyConfig()
        self.rmesh = ran_mesh or make_ran_mesh()
        self.cell_phys = [UpperPhy(cfg, self.expert) for _ in range(nof_cells)]
        self.harq_pools = [RxBufferPool() for _ in range(nof_cells)]
        #: Retransmissions whose soft-combining history was lost to HARQ
        #: pool exhaustion (decoded against a zero buffer, store skipped) —
        #: the reference flags pool exhaustion rather than losing it silently.
        self.nof_dropped_harq_reservations = 0

    # ------------------------------------------------------------------ DL --

    def process_dl_slot(self, requests, tx_datas=None, fetch: bool = False):
        """Assemble one DL slot for every cell as ONE batched device program
        (cells on the mesh "cell" axis), when all cells share the slot
        structure; heterogeneous structures fall back to per-cell dispatch.

        Args:
          requests: one DlTtiRequest per cell.
          tx_datas: optional list of TxDataRequest per cell.

        Returns (grids (ncell, P, 14, nsubc, 2), samples
        (ncell, P, nsamples, 2)) device arrays (fetch=False) or numpy
        (fetch=True).
        """
        from jax.sharding import NamedSharding, PartitionSpec
        from ..phy import dl_slot as dl_mod

        assert len(requests) == self.nof_cells
        tx_datas = tx_datas or [None] * self.nof_cells
        slot = requests[0].slot
        keys = {dl_mod.plan_key_for(r, self.cfg) for r in requests}
        if len(keys) != 1:
            outs = [self.cell_phys[c].process_dl_slot(
                requests[c], tx_datas[c], fetch=fetch)
                for c in range(self.nof_cells)]
            grids = [g for g, _ in outs]
            samps = [s for _, s in outs]
            if fetch:
                return np.stack(grids), np.stack(samps)
            return jnp.stack(grids), jnp.stack(samps)

        program = dl_mod.get_dl_slot_program(requests[0], self.cfg)
        batch = []
        for c, (req, txd) in enumerate(zip(requests, tx_datas)):
            vals = dl_mod.build_dl_slot_inputs(program, req, txd, slot)
            batch.append(program._value_args(
                slot, *vals, tuple(req.pdsch), tuple(req.pdcch),
                tuple(req.ssb)))
        mesh = self.rmesh.mesh
        shard = lambda x: jax.device_put(
            x, NamedSharding(mesh, PartitionSpec(
                "cell", *([None] * (x.ndim - 1)))))
        grid, samples = program.run_batched(slot, batch, shard_fn=shard)
        if fetch:
            return np.asarray(grid), np.asarray(samples)
        return grid, samples

    # ------------------------------------------------------------------ UL --

    def process_ul_slot(self, requests: list[UlTtiRequest], samples: np.ndarray):
        """Process one UL slot across all cells.

        Args:
          requests: one UlTtiRequest per cell (len == nof_cells).
          samples: (nof_cells, nof_rx_ports, nsamples, 2) received baseband.

        Returns: list of per-cell indication lists.

        PUSCH PDUs with identical static structure across all cells run as
        ONE sharded program (cells on the mesh "cell" axis).  Everything else
        (PUCCH, PRACH, SRS, odd-shaped PUSCH) dispatches through the per-cell
        UpperPhy.
        """
        assert len(requests) == self.nof_cells
        cfg = self.cfg
        slot = requests[0].slot
        mesh = self.rmesh.mesh
        out: list[list] = [[] for _ in range(self.nof_cells)]

        # Identify PUSCH PDUs batchable across every cell: position i of each
        # request shares a static key.
        nof_pdus = {len(r.pusch) for r in requests}
        batchable = []
        if len(nof_pdus) == 1 and next(iter(nof_pdus)) > 0:
            n = next(iter(nof_pdus))
            for i in range(n):
                keys = {_static_key(r.pusch[i]) for r in requests}
                if len(keys) == 1:
                    batchable.append(i)

        if batchable:
            grid = ofdm_mod.ofdm_demodulate(
                jax.device_put(
                    jnp.asarray(samples),
                    NamedSharding(mesh, P("cell", None, None, None))),
                cfg.nof_subc, cfg.dft_size, cfg.numerology,
                slot % (1 << cfg.numerology),
            )  # (ncell, P, 14, nsubc, 2)
            for i in batchable:
                self._process_pusch_batched(slot, [r.pusch[i] for r in requests],
                                            grid, out)

        # Everything else per cell.
        for c, req in enumerate(requests):
            rest = dataclasses.replace(
                req,
                pusch=tuple(p for i, p in enumerate(req.pusch)
                            if i not in batchable),
            )
            if rest.pusch or rest.pucch or rest.prach or rest.srs:
                out[c].extend(self.cell_phys[c].process_ul_slot(
                    rest, samples[c], validate=False))
        return out

    def _process_pusch_batched(self, slot, pdus, grid, out):
        cfg = self.cfg
        p0 = pdus[0]
        nof_ack = getattr(p0, "nof_harq_ack_bits", 0)
        nof_csi1 = getattr(p0, "nof_csi_part1_bits", 0)
        p2map = tuple(getattr(p0, "part2_size_map", ()) or ())
        const_csi2 = 0
        two_phase = False
        if nof_csi1 and p2map:
            if len(set(p2map)) == 1:
                const_csi2 = p2map[0]
            else:
                two_phase = True
        # One shape-keyed dynamic config for the whole cell batch (shared
        # with the per-cell UpperPhy program cache).
        rx_cfg = self.cell_phys[0]._pusch_rx_cfg(
            slot, p0, nof_csi2=const_csi2, two_phase=two_phase)
        from ..phy.upper_phy import (
            extract_pusch_allocation, pusch_dmrs_ref_values)

        sub = extract_pusch_allocation(grid, p0)

        # Per-cell DM-RS references, descrambling signs (and, with UCI on
        # PUSCH, placeholder fix signs) as inputs.
        qm = None
        if nof_ack or nof_csi1:
            from ..models.pusch_rx import cached_demux_plan
            from ..ops.ulsch_demux import placeholder_fix_signs
            from ..ran.modulation import bits_per_symbol

            qm = bits_per_symbol(p0.modulation)
            plan, _ = cached_demux_plan(rx_cfg, 0 if two_phase else const_csi2)
        refs, signs, scrs = [], [], []
        ack_fixes, csi1_fixes, csi2_fixes = [], [], []
        for pdu in pdus:
            refs.append(np_to_pair(pusch_dmrs_ref_values(slot, pdu)))
            cinit = ((pdu.rnti << 15) + pdu.n_id) & 0x7FFFFFFF
            scr = prg_mod.gold_sequence_bits(cinit, rx_cfg.nof_codeword_bits)
            scrs.append(scr)
            signs.append(1 - 2 * scr.astype(np.int8))
            if nof_ack:
                ack_fixes.append(placeholder_fix_signs(
                    plan.ack_bit_idx, nof_ack, qm, scr))
            if nof_csi1:
                csi1_fixes.append(placeholder_fix_signs(
                    plan.csi1_bit_idx, nof_csi1, qm, scr))
            if const_csi2:
                csi2_fixes.append(placeholder_fix_signs(
                    plan.csi2_bit_idx, const_csi2, qm, scr))
        mesh = self.rmesh.mesh
        cell_sh = lambda x, nd: jax.device_put(
            x, NamedSharding(mesh, P("cell", *([None] * (nd - 1)))))
        ref_in = cell_sh(jnp.asarray(np.stack(refs)), 4)
        signs_in = cell_sh(jnp.asarray(np.stack(signs)), 2)
        uci_fix = None
        if nof_ack or nof_csi1:
            mk = lambda rows: (cell_sh(jnp.asarray(np.stack(rows)), 2)
                               if rows else None)
            uci_fix = (mk(ack_fixes), mk(csi1_fixes), mk(csi2_fixes))

        # HARQ riding the batch: retransmitting cells contribute their stored
        # soft bits, new-data cells an all-zero buffer (the promotion sum is
        # the identity on zeros, bit-exact with not combining), so ONE
        # program serves any new-data/retx mix
        # (reference: include/srsran/phy/upper/rx_buffer_pool.h:40-106).
        seg = rx_cfg.segmentation
        ncb, nbits = seg.nof_cb, seg.nof_cw_bits_per_cb
        buf_idxs = []
        harq_rows = []
        for c, pdu in enumerate(pdus):
            pool = self.harq_pools[c]
            bi = pool.reserve(slot, pdu.rnti, pdu.harq_id, ncb,
                              new_data=pdu.new_data)
            buf_idxs.append(bi)
            if bi is None and not pdu.new_data:
                self.nof_dropped_harq_reservations += 1
                import logging

                logging.getLogger("multi_cell_phy").warning(
                    "HARQ pool exhausted: cell=%d rnti=0x%x harq=%d "
                    "retransmission decodes without soft-combining history",
                    c, pdu.rnti, pdu.harq_id)
            if bi is not None and not pdu.new_data:
                harq_rows.append(pool.get_soft(bi, ncb, nbits))
            else:
                harq_rows.append(jnp.zeros((ncb, nbits), jnp.int8))
        harq_in = cell_sh(jnp.stack(harq_rows), 3)

        csi1_np = csi1_metric = None
        csi2_rows = csi2_metric = None
        if two_phase:
            # Batched part1->part2 protocol: ONE phase-A program over the
            # cell axis, then one phase-B dispatch per part2-size bucket on
            # that bucket's cell rows (a phase-B program compiles per
            # (size, bucket-cardinality) pair).
            from ..models.pusch_rx import cached_pusch_phase_b
            from ..phy.pusch_uci import (
                PuschUciConfig, PuschUciProcessor, _phase_b_cfg)

            proc = PuschUciProcessor(PuschUciConfig(rx=rx_cfg,
                                                    part2_size_map=p2map))
            a = proc._phase_a(sub, None, ref_in, signs_in, uci_fix)
            csi1_np = np.asarray(a["csi1_bits"])
            csi1_metric = np.asarray(a["csi1_metric"])
            sizes = proc.csi2_sizes(csi1_np)
            ncell = len(pdus)
            ok = np.zeros(ncell, bool)
            bits = [None] * ncell
            harq_soft = [None] * ncell
            csi2_rows = [None] * ncell
            csi2_metric = np.zeros(ncell, np.float32)
            cfg_b = _phase_b_cfg(rx_cfg)
            llr = a["codeword_llr"]
            for size in sorted(set(sizes)):
                idxs = [i for i, s in enumerate(sizes) if s == size]
                sel = jnp.asarray(idxs)
                pb = cached_pusch_phase_b(cfg_b, size)
                csi2_fix = (proc.csi2_fix_signs(size, [scrs[i] for i in idxs])
                            if size else None)
                bout = pb(llr[sel], harq_in[sel], csi2_fix)
                ok_b = np.asarray(bout["tb_crc_ok"])
                cb_b = np.asarray(bout["tb_bits_cb"])
                for row, i in enumerate(idxs):
                    ok[i] = bool(ok_b[row])
                    bits[i] = flatten_tb_bits(cb_b[row][None], rx_cfg.tbs)[0]
                    harq_soft[i] = bout["harq_soft"][row]
                    if size:
                        csi2_rows[i] = np.asarray(bout["csi2_bits"])[row]
                        csi2_metric[i] = float(np.asarray(bout["csi2_metric"])[row])
            ack_bits = np.asarray(a["harq_ack_bits"]) if nof_ack else None
            ack_metric = np.asarray(a["harq_ack_metric"]) if nof_ack else None
        else:
            rx = cached_pusch_rx_from_grid(rx_cfg)
            res = rx(sub, harq_in, ref_in, signs_in, uci_fix)
            ok = np.asarray(res["tb_crc_ok"])
            bits = flatten_tb_bits(np.asarray(res["tb_bits_cb"]), rx_cfg.tbs)
            harq_soft = res["harq_soft"]
            ack_bits = np.asarray(res["harq_ack_bits"]) if nof_ack else None
            ack_metric = np.asarray(res["harq_ack_metric"]) if nof_ack else None
            if nof_csi1:
                csi1_np = np.asarray(res["csi1_bits"])
                csi1_metric = np.asarray(res["csi1_metric"])
                if const_csi2:
                    csi2_rows = np.asarray(res["csi2_bits"])
                    csi2_metric = np.asarray(res["csi2_metric"])
        for c, pdu in enumerate(pdus):
            if buf_idxs[c] is not None:
                self.harq_pools[c].store(buf_idxs[c], ncb, nbits,
                                         harq_soft[c])
            out[c].append(CrcIndication(slot=slot, rnti=pdu.rnti,
                                        harq_id=pdu.harq_id,
                                        tb_crc_ok=bool(ok[c])))
            out[c].append(RxDataIndication(
                slot=slot, rnti=pdu.rnti, harq_id=pdu.harq_id,
                tb_bits=bits[c] if ok[c] else None))
            if nof_ack or nof_csi1:
                from ..fapi.pdus import UciIndication

                uci = UciIndication(
                    slot=slot, rnti=pdu.rnti,
                    harq_bits=(ack_bits[c] if nof_ack
                               else np.empty(0, np.uint8)),
                    uci_bits=None,
                    valid=bool(ack_metric[c] > 0.0) if nof_ack
                    else bool(csi1_metric[c] > 0.0))
                if nof_csi1:
                    uci.csi1_bits = csi1_np[c]
                    uci.csi1_valid = bool(csi1_metric[c] > 0.0)
                    if csi2_rows is not None and csi2_rows[c] is not None \
                            and np.size(csi2_rows[c]):
                        uci.csi2_bits = np.asarray(csi2_rows[c])
                        uci.csi2_valid = bool(csi2_metric[c] > 0.0)
                out[c].append(uci)
            if ok[c]:
                self.harq_pools[c].release(pdu.rnti, pdu.harq_id)
