"""Device mesh construction for multi-chip / multi-host runs.

The reference is single-node shared-memory (SURVEY.md §2.7); its thread-level
parallelism maps onto a JAX device mesh with two axes:

* ``data``  — read batches stream data-parallel (the analogue of the
  reference's byte-range worker sharding, /root/reference/src/hash.hpp:414-423);
* ``index`` — the sparse k-mer table is sharded by slot range (a 1-D tensor
  parallelism over the index dimension; the dense 13-mer table is replicated).

Count partials merge with psum over ``data``; sharded-table queries merge with
psum over ``index``. The cards of one host are joined all to all, so the mesh
follows the algorithm alone; across hosts ``data`` is the natural axis to
split (reads are independent).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
INDEX_AXIS = "index"


def make_mesh(n_data: int | None = None, n_index: int = 1,
              devices: list | None = None) -> Mesh:
    """(data, index) mesh over the available devices.

    With defaults, all devices go to the ``data`` axis. ``n_index > 1``
    carves an index-sharding axis (n_data * n_index must equal the device
    count used).
    """
    devs = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devs) // n_index
    use = n_data * n_index
    grid = np.asarray(devs[:use]).reshape(n_data, n_index)
    return Mesh(grid, (DATA_AXIS, INDEX_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-dim sharding over the data axis (reads, query batches)."""
    return NamedSharding(mesh, P(DATA_AXIS))


def index_sharding(mesh: Mesh) -> NamedSharding:
    """Slot-dim sharding over the index axis (tf / checker arrays)."""
    return NamedSharding(mesh, P(INDEX_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
