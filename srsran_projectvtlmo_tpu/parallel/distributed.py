"""Multi-host execution: jax.distributed bring-up + the (cell, sp) mesh.

The reference distributes cells across machines through its executor topology
and the O-RAN 7.2 fronthaul split (reference: apps/services/worker_manager.h:59-82,
lib/du_low/du_low_impl.h:31-48 one upper_phy per cell).  Here cells ride the
"cell" mesh axis, laid out across processes first (pure data parallel, no
cross-cell collectives), while intra-cell axes (codeblock batches, baseband
samples with overlap-save halos) ride the "sp" axis over each process's own
devices, whose interconnect carries their collectives.

Single-process runs (tests, the virtual-device dryrun) degrade to the same
mesh over local devices — programs are single-source either way; only the
device matrix changes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import numpy as np
from jax.sharding import Mesh


def maybe_initialize_distributed() -> bool:
    """Initialize jax.distributed from the standard env when configured.

    Env contract (matches jax.distributed.initialize defaults):
      JAX_COORDINATOR_ADDRESS host:port of process 0,
      JAX_NUM_PROCESSES, JAX_PROCESS_ID  (or cluster auto-detection).
    Returns True when a multi-process runtime was initialized.
    """
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    if addr is None or nproc is None or int(nproc) <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=int(nproc),
        process_id=int(os.environ.get("JAX_PROCESS_ID", "0")),
    )
    return True


@dataclass(frozen=True)
class RanMesh:
    """The framework's canonical 2D mesh: ("cell", "sp").

    "cell" is the slot/cell data-parallel axis — laid out across *processes*
    first, so the network between hosts only ever carries per-cell inputs
    and outputs.  "sp" is the intra-cell sequence/codeblock axis — laid out
    within a process so its collectives (overlap-save ppermute halos,
    codeword allgather) stay on the host's device interconnect.
    """

    mesh: Mesh
    nof_cells: int
    nof_sp: int


def make_ran_mesh(nof_cell_shards: int | None = None,
                  nof_sp_shards: int | None = None,
                  devices=None) -> RanMesh:
    """Build the (cell, sp) mesh over `devices` (default: all of them).

    Default layout: the cell axis spans processes, the sp axis spans each
    process's local devices.  Single-process: cell x sp factor the device
    count.  Every device reaches every other one directly, so the matrix is
    the device list in order, with no topology to follow.
    """
    devs = list(jax.devices() if devices is None else devices)
    nproc = jax.process_count()
    ndev = len(devs)
    per_proc = ndev // nproc

    if nof_cell_shards is None and nof_sp_shards is None:
        nof_cell_shards = nproc if nproc > 1 else (2 if ndev % 2 == 0 and ndev >= 4 else 1)
        nof_sp_shards = ndev // nof_cell_shards
    elif nof_cell_shards is None:
        nof_cell_shards = ndev // nof_sp_shards
    elif nof_sp_shards is None:
        nof_sp_shards = ndev // nof_cell_shards
    assert nof_cell_shards * nof_sp_shards == ndev, \
        f"{nof_cell_shards} x {nof_sp_shards} != {ndev} devices"

    # Device matrix: processes vary along the cell axis (rows), local devices
    # along sp (columns) — jax.devices() orders by process then local id.
    matrix = np.array(devs).reshape(nof_cell_shards, nof_sp_shards)
    if nproc > 1:
        assert nof_cell_shards % nproc == 0 or nproc % nof_cell_shards == 0, \
            "cell axis must align with process boundaries"
    mesh = Mesh(matrix, axis_names=("cell", "sp"))
    return RanMesh(mesh=mesh, nof_cells=nof_cell_shards, nof_sp=nof_sp_shards)
