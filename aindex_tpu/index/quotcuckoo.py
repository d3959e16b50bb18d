"""Quotiented split-half cuckoo table: the device query engine for the
sparse index.

A redesign of :mod:`aindex_tpu.index.cuckoo` around the gathers a query
needs: two 8-byte rows, one per cuckoo half, each consumed whole (a
gather of one column of a row can be narrowed by XLA to 4-byte elements).
Each half lives in its OWN ``uint32[m, 2]`` array of ``(fp, tf)`` rows,
so the verified two-probe query reads 16 bytes per key (the reference
loop this replaces is get_freq, /root/reference/src/hash.hpp:123-140).
Whether these layout choices still pay on a GPU, whose random access
moves 32-byte sectors through a 50 MB L2, is not measured yet.

8 bytes cannot hold a 46-bit key + tf, so keys are *quotiented*: each
half has its own invertible mixer (an xorshift-multiply bijection on the
2k-bit code space), the row index consumes the hash's low ``lb`` bits and
the row stores the remaining ``2k - lb`` bits as a fingerprint. Row index
+ fingerprint reconstruct the full hash, and the bijection then
reconstructs the full key — a fingerprint match IS an exact key match, no
false positives. Per half ``h``:

    row  = bij_h(key) & (m - 1)
    fp   = bij_h(key) >> lb               (<= 31 bits; u32 lane)
    cell = (fp, tf)                        8 bytes, gathered as [B, 2]

Slot ids (needed only by position/pfid paths) live in parallel ``[m]``
int32 columns gathered once more via the winning row — tf-only queries
(the hot codes-in path) never touch them. The builder works on one
contiguous ``[2m, 2]`` array (native random-walk insertion); the device
arrays are views of its halves.

Eligibility: fp must fit 31 bits (0xFFFFFFFF is the empty marker), i.e.
``lb >= 2k - 31``. For k <= 23 that minimum table is <= 2^15 rows per
half (512 KB) — always worth it; for larger k the wide CuckooTable
remains the fallback (Sparse23Index picks per index).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_EMPTY_FP = np.uint32(0xFFFFFFFF)

# base odd multipliers for the two bijections (public splitmix64/murmur
# mixing constants; any good odd constants work — rebuilds re-derive)
_M1A = 0x9E3779B97F4A7C15
_M1B = 0xBF58476D1CE4E5B9
_M2A = 0xC2B2AE3D27D4EB4F
_M2B = 0x94D049BB133111EB


def _mix64_np(x: np.ndarray | int) -> np.ndarray:
    x = np.uint64(x) if np.isscalar(x) else x.copy()
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(33)
        x = x * np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(33)
        x = x * np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(33)
    return x


def derive_mults(attempt: int, w: int) -> tuple[int, int, int, int]:
    """The four odd multipliers (masked to w bits) for a build attempt."""
    mask = (1 << w) - 1
    out = []
    for i, base in enumerate((_M1A, _M1B, _M2A, _M2B)):
        m = int(_mix64_np(np.uint64(base + 2 * attempt * (i + 1)))) if attempt \
            else base
        out.append((m | 1) & mask)
    return tuple(out)


def _bij_np(x: np.ndarray, ma: int, mb: int, w: int) -> np.ndarray:
    """xorshift-multiply bijection on the low w bits (numpy, mod-2^w)."""
    mask = np.uint64((1 << w) - 1)
    s = np.uint64((w + 1) // 2)
    x = np.asarray(x, dtype=np.uint64) & mask
    with np.errstate(over="ignore"):
        x = x ^ (x >> s)
        x = (x * np.uint64(ma)) & mask
        x = x ^ (x >> s)
        x = (x * np.uint64(mb)) & mask
        x = x ^ (x >> s)
    return x


def _bij_jnp(x: jax.Array, ma, mb, w: int) -> jax.Array:
    mask = jnp.uint64((1 << w) - 1)
    s = jnp.uint64((w + 1) // 2)
    x = x.astype(jnp.uint64) & mask
    x = x ^ (x >> s)
    x = (x * ma.astype(jnp.uint64)) & mask
    x = x ^ (x >> s)
    x = (x * mb.astype(jnp.uint64)) & mask
    x = x ^ (x >> s)
    return x


def natural_lb(n: int, w: int) -> int:
    """Per-half log2 row count for n keys: total load n/(2m) <= ~0.467
    (safely under the 1-slot 2-choice cuckoo threshold of 0.5) and fp <=
    31 bits."""
    lb = 1
    while (1 << lb) < max(1, int(np.ceil(n * 1.07))):
        lb += 1
    return max(lb, w - 31, 1)


def eligible(n: int, k: int) -> bool:
    """Quotient layout is used when the fp-width floor doesn't force a
    table more than ~4x the natural size or larger than ~32 MB."""
    w = 2 * k
    if w - 31 <= 0:
        return True
    lb_nat = natural_lb(n, 0)  # size-driven part only
    return (w - 31) <= max(lb_nat + 2, 20)


class QuotCuckoo:
    """Built table: ``fp_tf`` uint32[2m, 2] + ``slot`` int32[2m] host-side;
    on device each half is a separate array (see module docstring)."""

    def __init__(self, fp_tf: np.ndarray, slot: np.ndarray, m: int, lb: int,
                 w: int, mults: tuple[int, int, int, int]):
        self.fp_tf_host = fp_tf
        self.slot_host = slot
        self.m = m
        self.lb = lb
        self.w = w
        self.mults = tuple(np.uint64(mu) for mu in mults)
        self._halves: tuple[jax.Array, jax.Array] | None = None
        self._slot_halves: tuple[jax.Array, jax.Array] | None = None

    @property
    def device(self) -> tuple[jax.Array, jax.Array]:
        """The two half-tables as SEPARATE device arrays, one gather
        operand per half."""
        if self._halves is None:
            # concrete even when first touched inside a jit trace (e.g. a
            # resolve closure inside the mesh positional build) — caching
            # a traced constant would leak the tracer into later calls
            with jax.ensure_compile_time_eval():
                self._halves = (jnp.asarray(self.fp_tf_host[:self.m]),
                                jnp.asarray(self.fp_tf_host[self.m:]))
        return self._halves

    @property
    def slot_device(self) -> tuple[jax.Array, jax.Array]:
        if self._slot_halves is None:
            with jax.ensure_compile_time_eval():
                self._slot_halves = (jnp.asarray(self.slot_host[:self.m]),
                                     jnp.asarray(self.slot_host[self.m:]))
        return self._slot_halves

    def release_device(self) -> None:
        self._halves = None
        self._slot_halves = None

    @property
    def nbytes(self) -> int:
        return self.fp_tf_host.nbytes + self.slot_host.nbytes

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, keys: np.ndarray, tf: np.ndarray, slot: np.ndarray,
              k: int, max_rebuilds: int = 10) -> "QuotCuckoo":
        """Build from parallel arrays of distinct 2k-bit codes."""
        w = 2 * k
        n = len(keys)
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        tf = np.ascontiguousarray(tf, dtype=np.uint32)
        slot = np.ascontiguousarray(slot, dtype=np.int32)
        lb = natural_lb(n, w)
        attempt = 0
        while attempt < max_rebuilds:
            mults = derive_mults(attempt, w)
            out = cls._try_build(keys, tf, slot, 1 << lb, lb, w, mults)
            if out is not None:
                return cls(out[0], out[1], 1 << lb, lb, w, mults)
            attempt += 1
            if attempt % 2 == 0:
                lb += 1  # grow after two failed multiplier sets
        raise RuntimeError(
            f"quotient cuckoo build failed after {max_rebuilds} attempts "
            f"(n={n}, m=2^{lb})")

    @staticmethod
    def _try_build(keys, tf, slot, m, lb, w, mults):
        from aindex_tpu import native as native_mod
        if native_mod.available():
            return native_mod.quot_build(keys, tf, slot, m, lb, w, mults)
        # pure-python fallback (tests / tiny n)
        fp_tf = np.zeros((2 * m, 2), dtype=np.uint32)
        fp_tf[:, 0] = _EMPTY_FP
        slot_col = np.zeros(2 * m, dtype=np.int32)
        side_key = np.zeros(2 * m, dtype=np.uint64)  # evictee recovery
        mask = np.uint64(m - 1)
        ma = (np.uint64(mults[0]), np.uint64(mults[2]))
        mb = (np.uint64(mults[1]), np.uint64(mults[3]))
        max_kicks = 512
        rng = np.uint64(mults[0]) ^ np.uint64(0x9E3779B97F4A7C15)
        for i in range(len(keys)):
            key, etf, eslot = keys[i], tf[i], slot[i]
            half = 0
            kicks = 0
            while True:
                h = _bij_np(np.uint64(key), int(ma[half]), int(mb[half]), w)
                row = int(h & mask) + (m if half else 0)
                if fp_tf[row, 0] == _EMPTY_FP:
                    fp_tf[row, 0] = np.uint32(h >> np.uint64(lb))
                    fp_tf[row, 1] = etf
                    slot_col[row] = eslot
                    side_key[row] = key
                    break
                okey = side_key[row]
                otf, oslot = fp_tf[row, 1], slot_col[row]
                fp_tf[row, 0] = np.uint32(h >> np.uint64(lb))
                fp_tf[row, 1] = etf
                slot_col[row] = eslot
                side_key[row] = key
                key, etf, eslot = okey, otf, oslot
                half ^= 1
                kicks += 1
                if kicks > max_kicks:
                    return None
                rng = _mix64_np(rng)
                if (kicks & 63) == 0 and (int(rng) & 1):
                    half ^= 1
        return fp_tf, slot_col

    # -- host lookup -------------------------------------------------------

    def lookup_host(self, keys: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(found, tf, slot) host-side mirror of the device kernel; the
        second row is gathered only for first-probe misses."""
        keys = np.asarray(keys, dtype=np.uint64)
        mask = np.uint64(self.m - 1)
        lbs = np.uint64(self.lb)
        h1 = _bij_np(keys, int(self.mults[0]), int(self.mults[1]), self.w)
        r1 = (h1 & mask).astype(np.int64)
        c1 = self.fp_tf_host[r1]
        found = c1[:, 0] == (h1 >> lbs).astype(np.uint32)
        tf = np.where(found, c1[:, 1], np.uint32(0))
        slot = np.where(found, self.slot_host[r1], -1).astype(np.int32)
        idx = np.nonzero(~found)[0]
        if idx.size:
            h2 = _bij_np(keys[idx], int(self.mults[2]), int(self.mults[3]),
                         self.w)
            r2 = (h2 & mask).astype(np.int64) + self.m
            c2 = self.fp_tf_host[r2]
            hit2 = c2[:, 0] == (h2 >> lbs).astype(np.uint32)
            found[idx] = hit2
            tf[idx] = np.where(hit2, c2[:, 1], np.uint32(0))
            slot[idx] = np.where(hit2, self.slot_host[r2], -1).astype(np.int32)
        return found, tf, slot


# ---------------------------------------------------------------------------
# device kernels — each takes the halves as separate arrays
# ---------------------------------------------------------------------------

def _probe(half0, half1, keys, mults, m: int, lb: int, w: int):
    """Shared probe body. Returns per-half (tf_or_0, hit, row)."""
    keys = keys.astype(jnp.uint64)
    mask = jnp.uint64(m - 1)
    out = []
    for half, tbl in ((0, half0), (1, half1)):
        h = _bij_jnp(keys, mults[2 * half], mults[2 * half + 1], w)
        r = (h & mask).astype(jnp.int32)
        fp = (h >> jnp.uint64(lb)).astype(jnp.uint32)
        c = tbl[r]                       # [B, 2] — full row, never sliced
        hit = c[:, 0] == fp
        out.append((jnp.where(hit, c[:, 1], 0), hit, r))
    return out


@functools.partial(jax.jit, static_argnames=("m", "lb", "w"))
def quot_query_tf(half0: jax.Array, half1: jax.Array, keys: jax.Array,
                  valid, m1a, m1b, m2a, m2b, *, m: int, lb: int, w: int
                  ) -> jax.Array:
    """tf per key — the hot tf-only path: exactly two [B, 2]-u32 row
    gathers. ``valid=None`` (trace-time) skips the mask."""
    (tf1, hit1, _), (tf2, hit2, _) = _probe(half0, half1, keys,
                                            (m1a, m1b, m2a, m2b), m, lb, w)
    tf = jnp.where(hit1, tf1, jnp.where(hit2, tf2, 0))
    if valid is not None:
        tf = jnp.where(valid, tf, 0)
    return tf.astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("k", "m", "lb", "w"))
def quot_tf_canonical(half0: jax.Array, half1: jax.Array, codes: jax.Array,
                      valid, m1a, m1b, m2a, m2b, *, k: int, m: int, lb: int,
                      w: int) -> jax.Array:
    """tf per LITERAL code on a canonical-keyed index — revcomp +
    canonicalise + both probes fused in one compiled kernel (one dispatch,
    no HBM round-trips for intermediates). The end-to-end form of the
    north-star codes-in query."""
    from aindex_tpu.kernels.encode import revcomp_code64
    codes = codes.astype(jnp.uint64)
    canon = jnp.minimum(codes, revcomp_code64(codes, k))
    (tf1, hit1, _), (tf2, hit2, _) = _probe(half0, half1, canon,
                                            (m1a, m1b, m2a, m2b), m, lb, w)
    tf = jnp.where(hit1, tf1, jnp.where(hit2, tf2, 0))
    if valid is not None:
        tf = jnp.where(valid, tf, 0)
    return tf.astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("k", "m", "lb", "w"))
def quot_tf_windows(half0: jax.Array, half1: jax.Array, mat: jax.Array,
                    m1a, m1b, m2a, m2b, *, k: int, m: int, lb: int, w: int
                    ) -> jax.Array:
    """[B, L] ASCII rows -> [B, L-k+1] verified tf — the whole 23-mer
    coverage path (window extraction + canonicalise + both probes) in ONE
    compiled kernel: no HBM round-trips for the window/validity
    intermediates and a single dispatch per length bucket (the r4 path
    paid two dispatches and materialised the uint64 window tensor)."""
    from aindex_tpu.kernels.encode import (ascii_to_base_codes,
                                           revcomp_code64, window_codes)
    base = ascii_to_base_codes(mat)
    codes, valid = window_codes(base, k, out_dtype=jnp.uint64)
    shape = codes.shape
    codes = codes.reshape(-1)
    canon = jnp.minimum(codes, revcomp_code64(codes, k))
    (tf1, hit1, _), (tf2, hit2, _) = _probe(
        half0, half1, canon, (m1a, m1b, m2a, m2b), m, lb, w)
    tf = jnp.where(hit1, tf1, jnp.where(hit2, tf2, 0))
    tf = jnp.where(valid.reshape(-1), tf, 0)
    return tf.reshape(shape).astype(jnp.uint32)


@functools.partial(jax.jit,
                   static_argnames=("k", "m", "lb", "w", "rows", "stride"))
def quot_tf_windows_packed(half0: jax.Array, half1: jax.Array,
                           packed: jax.Array, vbits: jax.Array,
                           m1a, m1b, m2a, m2b, *, k: int, m: int, lb: int,
                           w: int, rows: int, stride: int) -> jax.Array:
    """Packed-ingest twin of quot_tf_windows: the caller flattens the
    [rows, stride-1] ASCII matrix with a newline column (plus >= k
    newline tail) and ships it in the 0.375 B/base packed format — 2.7x
    fewer wire bytes than raw ASCII, which is what bounds coverage on
    slow links. Returns [rows, stride-k] verified tf (the caller slices
    off the separator-invalidated tail windows)."""
    from aindex_tpu.kernels.encode import packed_window_codes, revcomp_code64
    codes, valid = packed_window_codes(packed, vbits, k,
                                       out_dtype=jnp.uint64)
    need = rows * stride
    codes = codes[:need]
    valid = valid[:need]
    canon = jnp.minimum(codes, revcomp_code64(codes, k))
    (tf1, hit1, _), (tf2, hit2, _) = _probe(
        half0, half1, canon, (m1a, m1b, m2a, m2b), m, lb, w)
    tf = jnp.where(hit1, tf1, jnp.where(hit2, tf2, 0))
    tf = jnp.where(valid, tf, 0)
    return tf.reshape(rows, stride)[:, : stride - k].astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("m", "lb", "w"))
def quot_query(half0: jax.Array, half1: jax.Array, slot0: jax.Array,
               slot1: jax.Array, keys: jax.Array, valid,
               m1a, m1b, m2a, m2b, *, m: int, lb: int, w: int
               ) -> tuple[jax.Array, jax.Array]:
    """(tf, slot) per key; slot -1 when absent/invalid. Adds the winning
    row's slot-column gathers to the tf-only kernel."""
    (tf1, hit1, r1), (tf2, hit2, r2) = _probe(half0, half1, keys,
                                              (m1a, m1b, m2a, m2b), m, lb, w)
    if valid is not None:
        hit1 = hit1 & valid
        hit2 = hit2 & valid
    tf = jnp.where(hit1, tf1, jnp.where(hit2, tf2, 0))
    slot = jnp.where(hit1, slot0[r1], jnp.where(hit2, slot1[r2], -1))
    return tf.astype(jnp.uint32), slot.astype(jnp.int32)
