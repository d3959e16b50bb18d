"""Device-side k-mer spectrum reduction (sort + segment-reduce).

The reference reduces k-mer multisets with per-thread ``unordered_map``s that
are merged under a lock (/root/reference/src/count_kmers.cpp:47-64,334-341).
This module does the reduction on the device in the classic sort-based
formulation (SURVEY.md section 2.7: "thread-local maps + merge" ->
sort/segment-reduce):

  extract canonical windows -> sort codes -> segment boundaries by
  neighbour-compare -> segment-id = prefix sum -> counts via scatter-add,
  keys via scatter-min.

On a GPU the scatters are integer atomics, whose order does not change
the exact result. A scatter-free variant (two multi-operand pair-sorts plus
scans) measured the same on an H100 at 2^22 and 2^24 windows, so only this
one is kept.

Everything is static-shaped: invalid windows sort to a sentinel tail and the
unique count comes back as a scalar alongside the padded arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

#: Sentinel sort key for invalid windows (> any 2k-bit k-mer code, k <= 31).
#: An np scalar so importing the module never initialises the XLA backend
#: (required for jax.distributed.initialize ordering).
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


@functools.partial(jax.jit, static_argnames=("k",))
def chunk_spectrum(ascii_chunk: jax.Array, k: int):
    """(keys, counts, n_unique) for all valid canonical k-mers of one chunk.

    ``keys``/``counts`` are padded to the window count of the chunk; entries
    at index >= n_unique are padding (key == SENTINEL, count == 0). The whole
    reduction runs on device; the host only slices off the padding.
    """
    from aindex_tpu.index.sparse23 import _extract_canonical

    canon, valid = _extract_canonical(ascii_chunk, k)
    keyed = jnp.where(valid, canon, SENTINEL).reshape(-1)
    return sorted_spectrum(keyed)


@functools.partial(jax.jit, static_argnames=("k",))
def chunk_spectrum_packed(packed: jax.Array, validbits: jax.Array, k: int):
    """``chunk_spectrum`` over the packed ingest format
    (codec.pack_ascii_chunk) — 2.67x less H2D per chunk."""
    from aindex_tpu.kernels.encode import (canonical_code64,
                                           unpack_base_codes, window_codes)
    base = unpack_base_codes(packed, validbits)
    codes, valid = window_codes(base, k, out_dtype=jnp.uint64)
    canon = canonical_code64(codes, k)
    keyed = jnp.where(valid, canon, SENTINEL).reshape(-1)
    return sorted_spectrum(keyed)


@jax.jit
def sorted_spectrum(keyed: jax.Array):
    """Segment-reduce a flat uint64 key array (SENTINEL = ignore).

    Returns (keys[N], counts[N], n_unique) with unique keys sorted ascending
    in the first ``n_unique`` entries.
    """
    n = keyed.shape[0]
    s = jnp.sort(keyed)
    is_new = jnp.concatenate(
        [jnp.ones((1,), bool), s[1:] != s[:-1]])
    seg = jnp.cumsum(is_new.astype(jnp.int32)) - 1  # segment id per element
    live = s != SENTINEL
    counts = jnp.zeros((n,), jnp.uint32).at[seg].add(
        live.astype(jnp.uint32), mode="drop")
    keys = jnp.full((n,), SENTINEL, dtype=jnp.uint64).at[seg].min(
        jnp.where(live, s, SENTINEL), mode="drop")
    n_unique = jnp.sum(is_new & live).astype(jnp.int32)
    return keys, counts, n_unique


@jax.jit
def sorted_spectrum_weighted(keys: jax.Array, weights: jax.Array):
    """Segment-reduce (key, count) pairs (SENTINEL key = ignore).

    The merge step of the sharded multi-device spectrum: inputs are
    already-reduced partial spectra, so each key carries a count. Returns
    (keys[N], counts[N], n_unique) with unique keys sorted ascending.
    """
    n = keys.shape[0]
    order = jnp.argsort(keys)
    s = keys[order]
    w = weights[order].astype(jnp.uint64)
    is_new = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    seg = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    live = s != SENTINEL
    counts = jnp.zeros((n,), jnp.uint64).at[seg].add(
        jnp.where(live, w, jnp.uint64(0)), mode="drop")
    keys_out = jnp.full((n,), SENTINEL, dtype=jnp.uint64).at[seg].min(
        jnp.where(live, s, SENTINEL), mode="drop")
    n_unique = jnp.sum(is_new & live).astype(jnp.int32)
    return keys_out, counts, n_unique


def host_window_codes(ascii_chunk: np.ndarray, k: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(codes, valid) for every window of an ASCII byte chunk — numpy twin
    of kernels.encode.window_codes (same k-step shift-or formulation), for
    the zero-link-traffic host spectrum engine."""
    from aindex_tpu.core import codec
    base = codec.bytes_to_base_codes(ascii_chunk)
    n_win = base.size - k + 1
    if n_win <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    invalid = (base >= 4).astype(np.int32)
    csum = np.concatenate([np.zeros(1, np.int32), np.cumsum(invalid,
                                                            dtype=np.int32)])
    valid = (csum[k:] - csum[:-k]) == 0
    b = (base & 3).astype(np.uint64)
    acc = b[:n_win].copy()
    for j in range(1, k):
        acc <<= np.uint64(2)
        acc |= b[j:j + n_win]
    return acc, valid


def host_chunk_spectrum(ascii_chunk: np.ndarray, k: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """(unique canonical keys, counts) of one chunk, entirely on the host.

    The spectrum engine for slow device links (core.hostdev
    spectrum_reduce_mode): no H2D, no D2H. The fast path is one native C
    pass chain (rolling encode + incremental revcomp + LSD radix sort +
    run-length, native.host_spectrum_ascii, threaded); the numpy fallback
    is the shift-or scan above + np.unique.
    """
    from aindex_tpu.core import codec
    from aindex_tpu import native
    out = native.host_spectrum_ascii(ascii_chunk, k) \
        if native.available() else None
    if out is not None:
        return out
    codes, valid = host_window_codes(ascii_chunk, k)
    live = codes[valid]
    if not live.size:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    return np.unique(codec.canonical_code(live, k), return_counts=True)


def merge_spectra(parts: list[tuple[np.ndarray, np.ndarray]]
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Merge per-chunk (sorted unique keys, counts) partial spectra.

    Each part is already unique-sorted, so the merge works on far less data
    than the raw window stream. Host-side numpy: the partial spectra are the
    natural host<->device boundary (they are also what crosses hosts in the
    multi-host build, aindex_tpu/parallel/distributed.py).
    """
    if not parts:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    if len(parts) == 1:
        return parts[0][0].astype(np.uint64), parts[0][1].astype(np.uint64)
    all_keys = np.concatenate([p[0] for p in parts])
    all_counts = np.concatenate([p[1] for p in parts]).astype(np.uint64)
    keys, inv = np.unique(all_keys, return_inverse=True)
    counts = np.zeros(keys.size, dtype=np.uint64)
    np.add.at(counts, inv, all_counts)
    return keys, counts
