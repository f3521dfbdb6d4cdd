"""Multi-chip execution: device meshes for the FM-index engines.

Two sharding axes (the aligner analogues of dp/tp):
- "data": read batches (seed-scan lanes / locate rows) shard across
  chips — the throughput axis; reads are embarrassingly parallel (the
  reference's pthread chunk pool, Mapping.cpp:16,591-595, scaled to
  chips).
- "index": the merged FM gather table (occ blocks + packed genome +
  SA samples) range-shards by row across chips, for genomes whose
  index exceeds one device's memory. XLA GSPMD partitions every row
  gather with collectives between devices — the tensor-parallel
  analogue — so the SAME fast automaton programs (LUT init,
  locate/compare modes) run unchanged whether the index is replicated
  or sharded.

With index_shards == 1 the table is replicated and no collective runs
on the query path. The wide (64-bit) engine accepts the same mesh via
its index_mesh argument (ops/fm_jax_wide.py).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from ..index.loader import Index
from ..ops.fm_jax import FMIndexJax


def make_mesh(n_devices: int | None = None, index_shards: int = 1,
              backend: str | None = None) -> Mesh:
    """A (data, index) mesh over the first n_devices devices of the
    backend (default: JAX's default backend). Raises when the backend
    has fewer devices: a mesh never falls back to another backend."""
    devs = jax.devices(backend)
    if n_devices is None:
        n_devices = len(devs)
    if len(devs) < n_devices:
        raise ValueError(
            f"a mesh of {n_devices} devices needs {n_devices} "
            f"{devs[0].platform} devices; {len(devs)} found")
    if n_devices % index_shards:
        raise ValueError(f"{n_devices} devices do not divide into "
                         f"{index_shards} index shards")
    data = n_devices // index_shards
    grid = np.asarray(devs[:n_devices]).reshape(data, index_shards)
    return Mesh(grid, ("data", "index"))


class ShardedFMIndex(FMIndexJax):
    """The full device engine over a ("data", "index") mesh: read
    batches GSPMD-shard over "data", the gather table over "index"
    (see module docstring). Drop-in engine API: seed_reads /
    seed_submit_packed / seed_finish / mem_walks / locate take and return
    host NumPy arrays; device placement and collectives are internal.
    """

    def __init__(self, idx: Index, mesh: Mesh, max_dup_num: int = 100,
                 lut_k: int = 0):
        self.mesh = mesh
        super().__init__(idx, max_dup_num=max_dup_num, lut_k=lut_k,
                         data_mesh=mesh)
