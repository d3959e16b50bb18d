"""Multi-host initialisation and global mesh construction.

The reference is strictly single-node (SURVEY.md §2.7); scaling beyond one
host is new capability in this rebuild. The model:

* every host runs the same program (SPMD) and calls :func:`initialize`
  once before any JAX computation;
* :func:`global_mesh` builds the (data, index) mesh over ALL devices in the
  job — ``data`` parallelism spans hosts (reads are independent, so
  host-local input pipelines shard naturally by host), ``index`` sharding
  stays within a host, where the psum merge is cheap;
* per-host input sharding: :func:`host_read_slice` tells each host which
  slice of an input file list it owns.

Single-process runs (tests, one card) work unchanged — ``initialize`` is a
no-op when no cluster is configured.
"""

from __future__ import annotations

import logging
import os

import jax

from aindex_tpu.parallel.mesh import make_mesh

logger = logging.getLogger(__name__)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the multi-host job (jax.distributed) if one is configured.

    With no arguments, reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID. A no-op for single-process runs.
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None

    if coordinator_address is None and num_processes is None:
        logger.debug("single-process run; skipping jax.distributed")
        return
    # the CPU backend needs an explicit cross-process collectives
    # implementation; GPU collectives go through NCCL regardless
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    logger.info("joined distributed job: process %d/%d, %d local / %d global devices",
                jax.process_index(), jax.process_count(),
                jax.local_device_count(), jax.device_count())


def global_mesh(n_index: int = 1):
    """(data, index) mesh over every device in the job.

    ``n_index`` devices shard the sparse table's slot dimension (keep these
    within one host so the query psum stays on the host's interconnect);
    the rest carry data parallelism. Device order follows ``jax.devices()``, which groups by
    process — so consecutive ``data`` rows map to whole hosts and read
    streaming stays host-local.
    """
    n_devices = jax.device_count()
    if n_devices % n_index:
        raise ValueError(f"n_index={n_index} must divide device count {n_devices}")
    return make_mesh(n_data=n_devices // n_index, n_index=n_index,
                     devices=jax.devices())


def host_read_slice(n_items: int) -> slice:
    """The slice of a length-``n_items`` input list this host should read —
    contiguous, balanced host-level data sharding for input pipelines."""
    p, np_ = jax.process_index(), jax.process_count()
    per = -(-n_items // np_)
    return slice(p * per, min((p + 1) * per, n_items))


# ---------------------------------------------------------------------------
# multi-process building blocks (used by the sharded build paths)
# ---------------------------------------------------------------------------

def is_multiprocess() -> bool:
    return jax.process_count() > 1


def should_write() -> bool:
    """True on the process that owns shared-filesystem artifact writes
    (process 0); every process computes identical results, exactly one
    persists them."""
    return jax.process_index() == 0


def local_data_rows(mesh) -> range:
    """The contiguous range of ``data``-axis rows whose devices belong to
    THIS process.

    Each data row d of the (data, index) grid uses the device block
    ``mesh.devices[d]``; a row is local when every device in it is
    addressable here. ``jax.devices()`` orders by process, so local rows
    are contiguous — asserted, because the host-sharded input feed
    (each host packs only its own rows) depends on it.
    """
    from aindex_tpu.parallel.mesh import DATA_AXIS
    p = jax.process_index()
    grid = mesh.devices  # [n_data, n_index]
    local = [d for d in range(mesh.shape[DATA_AXIS])
             if all(dev.process_index == p for dev in grid[d].flat)]
    if not local:
        raise ValueError(
            f"process {p} owns no complete data row of the mesh; use a "
            f"data-axis size that is a multiple of the process count")
    lo, hi = local[0], local[-1] + 1
    assert local == list(range(lo, hi)), "data rows must be process-contiguous"
    return range(lo, hi)


def put_row_sharded(rows_local: 'np.ndarray', sharding, n_rows_global: int):
    """Make a row-sharded global device array from per-process local rows.

    Single-process: a plain ``device_put`` (``rows_local`` is the whole
    array). Multi-process: each process passes only ITS data rows (see
    :func:`local_data_rows`) and the result is a global array spanning
    every host — the input half of the "never touch another host's bytes"
    contract.
    """
    if not is_multiprocess():
        return jax.device_put(rows_local, sharding)
    global_shape = (n_rows_global,) + tuple(rows_local.shape[1:])
    return jax.make_array_from_process_local_data(sharding, rows_local,
                                                  global_shape)


def local_row_shards(arr, mesh) -> dict[int, 'np.ndarray']:
    """{data-row -> host copy of that row} for the rows addressable here.

    The output half of the host-sharded contract: after a sharded build
    step, each process materialises only its own shards (a plain
    ``np.asarray`` of a partly-remote array would fail)."""
    import numpy as np
    out = {}
    for shard in arr.addressable_shards:
        if shard.replica_id != 0:
            continue
        row = shard.index[0].start if shard.index[0].start else 0
        out[row] = np.asarray(shard.data)[0]
    return out


def allgather_concat(local: 'np.ndarray'):
    """Concatenate per-process host arrays across all processes, in
    process order (variable first-dim sizes allowed).

    The cross-host merge step for host-side partial results (per-host spectrum
    shards, positional segments). Single-process: identity."""
    import numpy as np
    if not is_multiprocess():
        return local
    from jax.experimental import multihost_utils
    sizes = multihost_utils.process_allgather(
        np.array([local.shape[0]], np.int64))
    sizes = np.asarray(sizes).reshape(-1)
    cap = int(sizes.max())
    padded = np.zeros((cap,) + local.shape[1:], local.dtype)
    padded[:local.shape[0]] = local
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    return np.concatenate([gathered[p, :int(sizes[p])]
                           for p in range(len(sizes))])


def barrier(name: str) -> None:
    """Block until every process reaches this point (no-op single-process).
    Used to sequence shared-filesystem artifacts: process 0 writes, the
    rest wait here before reading."""
    if is_multiprocess():
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)
