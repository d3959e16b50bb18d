"""Cuckoo hash table: the device query accelerator for the sparse index.

The MPHF is the *artifact/build* structure (compact, reference-parity); for
device queries its lookup walk costs seven scattered gathers per key (3
g-values + node->slot + 2x checker halves + tf). This table re-packages the
verified (key -> tf, slot) mapping so a query is exactly TWO 16-byte row
gathers plus register compares — a trade of memory for gather count.

Layout: ``table[2m, 4]`` uint32 rows ``(key_lo, key_hi, tf, slot)``; row
index = ``mix64(key ^ seed_h) & (m-1)`` (+``m`` for the second half); empty
marker ``key_hi = 0xFFFFFFFF`` (valid keys are < 2^62, i.e. k <= 30).
Classic 2-choice cuckoo with random-walk eviction at build time; query never
probes more than the two candidate rows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aindex_tpu.kernels.lookup import mix64

_EMPTY_HI = np.uint32(0xFFFFFFFF)
_SEED1 = 0x1B873593_9E3779B9
_SEED2 = 0x85EBCA6B_C2B2AE35


def _mix64_np(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    with np.errstate(over="ignore"):  # mod-2^64 wraparound is the hash
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(33)
    return x


class CuckooTable:
    def __init__(self, table: np.ndarray, m: int, seed1: int, seed2: int):
        self.table_host = table           # uint32[2m, 4]
        self.m = m
        # np.uint64, not Python int: seeds exceed int64 range, which a jitted
        # call would otherwise overflow while parsing the argument.
        self.seed1 = np.uint64(seed1)
        self.seed2 = np.uint64(seed2)
        self._device: jax.Array | None = None

    @property
    def device(self) -> jax.Array:
        if self._device is None:
            # concrete even when first touched inside a jit trace (see
            # QuotCuckoo.device) — never cache a traced constant
            with jax.ensure_compile_time_eval():
                self._device = jnp.asarray(self.table_host)
        return self._device

    @classmethod
    def build(cls, keys: np.ndarray, tf: np.ndarray, slot: np.ndarray,
              max_rebuilds: int = 8) -> "CuckooTable":
        """Build from parallel arrays (distinct uint64 keys < 2^62)."""
        n = len(keys)
        m = 1
        while m < max(1, int(np.ceil(n * 1.05 / 2))):
            m <<= 1
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        tf = np.ascontiguousarray(tf, dtype=np.uint32)
        slot = np.ascontiguousarray(slot, dtype=np.int32)
        s1, s2 = _SEED1, _SEED2
        for attempt in range(max_rebuilds):
            table = cls._try_build(keys, tf, slot, m, s1, s2)
            if table is not None:
                return cls(table, m, s1, s2)
            s1 = int(_mix64_np(np.uint64(s1 + 1)))
            s2 = int(_mix64_np(np.uint64(s2 + 3)))
            if attempt >= 1:
                m <<= 1  # grow after two failed seed sets
        raise RuntimeError(f"cuckoo build failed after {max_rebuilds} attempts "
                           f"(n={n}, m={m})")

    @staticmethod
    def _try_build(keys, tf, slot, m, s1, s2) -> np.ndarray | None:
        from aindex_tpu import native as native_mod
        if native_mod.available():
            return native_mod.cuckoo_build(keys, tf, slot, m, s1, s2)
        # pure-Python fallback (slow; fine for tests / small n)
        table = np.zeros((2 * m, 4), dtype=np.uint32)
        table[:, 1] = _EMPTY_HI
        mask = np.uint64(m - 1)
        for i in range(len(keys)):
            e = (np.uint32(keys[i] & np.uint64(0xFFFFFFFF)),
                 np.uint32(keys[i] >> np.uint64(32)), tf[i], np.uint32(slot[i]))
            half = 0
            for kick in range(512):
                k64 = (np.uint64(e[1]) << np.uint64(32)) | np.uint64(e[0])
                seed = np.uint64(s1 if half == 0 else s2)
                row = int(_mix64_np(k64 ^ seed) & mask) + (m if half else 0)
                if table[row, 1] == _EMPTY_HI:
                    table[row] = e
                    break
                old = tuple(table[row])
                table[row] = e
                e = old
                half ^= 1
            else:
                return None
        return table

    def lookup_host(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(found, tf, slot) host-side — mirror of the device kernel.

        Two-stage probe: the second candidate row is gathered only for
        first-row misses (~half the keys for a resident set), cutting the
        dominant cost — random 16-byte row gathers — by ~25% end to end.
        """
        keys = np.asarray(keys, dtype=np.uint64)
        lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (keys >> np.uint64(32)).astype(np.uint32)
        mask = np.uint64(self.m - 1)
        row1 = (_mix64_np(keys ^ self.seed1) & mask).astype(np.int64)
        cells = self.table_host[row1]
        found = (cells[:, 0] == lo) & (cells[:, 1] == hi)
        tf = np.where(found, cells[:, 2], np.uint32(0))
        slot = np.where(found, cells[:, 3], np.uint32(0)).astype(np.int32)
        idx = np.nonzero(~found)[0]
        if idx.size:
            sub = keys[idx]
            row2 = (_mix64_np(sub ^ self.seed2) & mask).astype(np.int64) + self.m
            c2 = self.table_host[row2]
            hit2 = (c2[:, 0] == lo[idx]) & (c2[:, 1] == hi[idx])
            found[idx] = hit2
            tf[idx] = np.where(hit2, c2[:, 2], np.uint32(0))
            slot[idx] = np.where(hit2, c2[:, 3], np.uint32(0)).astype(np.int32)
        return found, tf, slot


@functools.partial(jax.jit, static_argnames=("m",))
def cuckoo_query(table: jax.Array, keys: jax.Array, valid, seed1, seed2,
                 *, m: int):
    """(tf, slot) per key; slot = -1 when absent/invalid.

    Two [B, 4]-row gathers + register compares — the whole verified
    lookup: one row gather brings key and payload together.
    ``valid=None`` asserts every key is
    a real k-mer code and skips the mask entirely — the codes-in fast
    path; resolved at trace time.
    """
    keys = keys.astype(jnp.uint64)
    lo = (keys & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (keys >> 32).astype(jnp.uint32)
    mask = jnp.uint64(m - 1)

    tf = jnp.zeros(keys.shape, jnp.uint32)
    slot = jnp.full(keys.shape, -1, jnp.int32)
    for half, seed in ((0, seed1), (1, seed2)):
        row = (mix64(keys ^ jnp.uint64(seed)) & mask).astype(jnp.int32)
        if half:
            row = row + jnp.int32(m)
        cells = table[row]  # [B, 4]
        hit = (cells[:, 0] == lo) & (cells[:, 1] == hi)
        if valid is not None:
            hit = hit & valid
        tf = jnp.where(hit, cells[:, 2], tf)
        slot = jnp.where(hit, cells[:, 3].astype(jnp.int32), slot)
    return tf, slot
