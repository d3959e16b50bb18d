"""Host/device routing policy for ASCII-origin query batches.

A query batch that arrives as Python strings starts in host memory, so a
device lookup must pay host->device transfer of the encoded codes (>= 4
bytes per query) before the first gather can run. Whether that beats a
vectorised host-side lookup of the same table depends on one number: the
measured H2D bandwidth of this host/device link.

* On a PCIe-attached accelerator the transfer of a query batch takes
  microseconds, and the device gather wins for any non-trivial batch.
* On a slow link the transfer alone outlasts a host-side gather of the
  reference-scale tables (<= 256 MB, already resident for file-loaded
  and host-built indexes).

The policy below measures the link once per process and routes ASCII-batch
queries accordingly; device-resident inputs (coverage kernels, mesh-sharded
queries, build pipelines) always stay on device. Override with
``AINDEX_TPU_ASCII_QUERY=host|device`` (anything else = auto).

This replaces the reference's only strategy — per-kmer C++ loops on the
host (/root/reference/src/python_wrapper.cpp:594-608) — with the faster of
two batched engines, chosen by hardware measurement.
"""

from __future__ import annotations

import os
import time

import numpy as np

ASCII_QUERY_ENV = "AINDEX_TPU_ASCII_QUERY"

#: Below this measured link rate the host engine is chosen for ASCII
#: batches (and the host spectrum reduction, and the host encode).
H2D_THRESHOLD_MBPS = 256.0

_h2d_mbps: float | None = None


def h2d_bandwidth_mbps(probe_mb: int = 4, reps: int = 3) -> float:
    """Measured host->device bandwidth (MB/s); probed once per process.

    Each probe is fenced by pulling back a tiny on-device reduction of the
    transferred buffer, so the figure slightly *under*-estimates raw
    bandwidth by one dispatch round-trip — which only ever biases the
    policy toward the host path on slow links. The best-of-``reps``
    transfer is used: a single sample on a busy shared
    host can be 2-3x slow and would misroute every subsequent batch. Host
    buffers are allocated before the timers start (the memcpy is not part
    of the link).
    """
    global _h2d_mbps
    if _h2d_mbps is None:
        import jax
        import jax.numpy as jnp
        import logging
        # distinct host buffers per rep: device_put of an already-seen
        # buffer could be served from cache on some backends
        bufs = [np.zeros(probe_mb << 20, np.uint8) for _ in range(reps + 1)]
        fence = jax.jit(lambda x: x[:8].astype(jnp.uint32).sum())
        # warm with the SAME shape so the timed calls measure transfer +
        # dispatch only, never XLA compilation
        float(fence(jax.device_put(bufs.pop())))
        best = float("inf")
        for buf in bufs:
            t0 = time.perf_counter()
            float(fence(jax.device_put(buf)))
            best = min(best, time.perf_counter() - t0)
        _h2d_mbps = probe_mb / max(best, 1e-9)
        logging.getLogger(__name__).info(
            "hostdev: H2D link %.1f MB/s (best of %d x %d MB) -> ASCII "
            "batches via %s engine", _h2d_mbps, reps, probe_mb,
            "host" if _h2d_mbps < H2D_THRESHOLD_MBPS else "device")
    return _h2d_mbps


def prefer_host_ascii_queries() -> bool:
    """True when ASCII-batch lookups should run on the host engine."""
    mode = os.environ.get(ASCII_QUERY_ENV, "auto")
    if mode == "host":
        return True
    if mode == "device":
        return False
    return h2d_bandwidth_mbps() < H2D_THRESHOLD_MBPS


# ---------------------------------------------------------------------------
# device->host link + spectrum-reduce routing
# ---------------------------------------------------------------------------

SPECTRUM_REDUCE_ENV = "AINDEX_TPU_SPECTRUM_REDUCE"

_d2h_mbps: float | None = None


def d2h_bandwidth_mbps(probe_mb: int = 4, reps: int = 3) -> float:
    """Measured device->host bandwidth (MB/s); probed once per process.

    The same probe size and best-of-``reps`` rule as the H2D probe: a
    probe small enough to be all latency would under-report a PCIe link
    and send the spectrum reduction to the host.
    """
    global _d2h_mbps
    if _d2h_mbps is None:
        import jax
        import jax.numpy as jnp
        import logging
        n = probe_mb << 20
        make = jax.jit(lambda s: jnp.full((n,), s, jnp.uint8))
        np.asarray(make(jnp.uint8(0)))          # warm: compile + transfer
        best = float("inf")
        for rep in range(reps):
            arr = make(jnp.uint8(rep + 1))      # a fresh buffer per rep
            arr.block_until_ready()
            t0 = time.perf_counter()
            np.asarray(arr)                      # the D2H pull IS the fence
            best = min(best, time.perf_counter() - t0)
        _d2h_mbps = probe_mb / max(best, 1e-9)
        logging.getLogger(__name__).info(
            "hostdev: D2H link %.1f MB/s (best of %d x %d MB)", _d2h_mbps,
            reps, probe_mb)
    return _d2h_mbps


def spectrum_reduce_mode() -> str:
    """'device' or 'host': where the sparse k-mer spectrum reduction runs.

    The device sort/segment-reduce returns ~12 bytes per unique window
    device->host; when the D2H link is slower than the threshold, that
    pull-back dominates and the fully-host engine (shift-or windows +
    np.unique, zero link traffic) is chosen. Override with
    ``AINDEX_TPU_SPECTRUM_REDUCE=device|host``.
    """
    mode = os.environ.get(SPECTRUM_REDUCE_ENV, "auto")
    if mode in ("device", "host"):
        return mode
    return "device" if d2h_bandwidth_mbps() >= H2D_THRESHOLD_MBPS else "host"


# ---------------------------------------------------------------------------
# ASCII -> code encode routing
# ---------------------------------------------------------------------------

ENCODE_ROUTE_ENV = "AINDEX_TPU_DEVICE_ENCODE"

#: batch size from which the device encode engages on fast links: below
#: this, dispatch round trips outweigh the device encode's advantage over
#: the host's vectorised numpy pipeline.
DEVICE_ENCODE_MIN_BATCH = 1 << 14


def device_encode_min() -> int | None:
    """Batch size from which ASCII k-mer batches encode ON DEVICE; None =
    always encode on the host.

    Device encode ships raw ASCII (k bytes/query, ~2.9x the bytes of
    uint64 codes) and fuses windowing + validation on the device — chosen
    when the H2D link is PCIe-class AND device queries are the routed
    engine anyway; on a slow link the extra bytes cost more than the
    encode saves, so the policy keys off the same measured-link predicate
    as the query routing. Override with
    ``AINDEX_TPU_DEVICE_ENCODE=never|<min batch>``.
    """
    mode = os.environ.get(ENCODE_ROUTE_ENV, "auto")
    if mode == "never":
        return None
    if mode.isdigit():
        return int(mode)
    if prefer_host_ascii_queries():
        return None
    return DEVICE_ENCODE_MIN_BATCH
