"""Device-side batched query kernels (gathers).

The reference answers each query with 1-2 Jenkins hashes plus rank pointer
chasing per k-mer (/root/reference/src/emphf/mphf.hpp:79-89, README's "batch"
API is a plain per-element C++ loop, src/python_wrapper.cpp:548-563). Here
a batch of queries is one or two device-memory gathers (BASELINE.md's
>=100M q/s target).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aindex_tpu.kernels.encode import revcomp_code13


@jax.jit
def gather_tf(table: jax.Array, codes: jax.Array) -> jax.Array:
    """tf[i] = table[codes[i]] — forward-strand lookup (dense mode).

    Equivalent of get_tf_value_13mer (/root/reference/src/python_wrapper.cpp:482-503)
    over a whole batch.
    """
    return table[codes.astype(jnp.int32)]


@jax.jit
def gather_tf_valid(table: jax.Array, codes: jax.Array, valid: jax.Array) -> jax.Array:
    """Forward lookup with invalid queries forced to 0."""
    tf = table[codes.astype(jnp.int32)]
    return jnp.where(valid, tf, jnp.zeros((), tf.dtype))


@functools.partial(jax.jit, static_argnames=("k",))
def gather_tf_total_13(table: jax.Array, codes: jax.Array, valid: jax.Array,
                       k: int = 13) -> jax.Array:
    """fwd + revcomp tf sum (get_total_tf_value_13mer,
    /root/reference/src/python_wrapper.cpp:522-543): two gathers + add."""
    rc = revcomp_code13(codes.astype(jnp.uint32), k)
    tf = table[codes.astype(jnp.int32)] + table[rc.astype(jnp.int32)]
    return jnp.where(valid, tf, jnp.zeros((), tf.dtype))


@functools.partial(jax.jit, static_argnames=("k",))
def gather_tf_both_13(table: jax.Array, codes: jax.Array, valid: jax.Array,
                      k: int = 13) -> tuple[jax.Array, jax.Array]:
    """(fwd, rc) tf pair (get_tf_both_directions_13mer,
    /root/reference/src/python_wrapper.cpp:567-588)."""
    rc = revcomp_code13(codes.astype(jnp.uint32), k)
    fwd_tf = table[codes.astype(jnp.int32)]
    rc_tf = table[rc.astype(jnp.int32)]
    zero = jnp.zeros((), fwd_tf.dtype)
    return jnp.where(valid, fwd_tf, zero), jnp.where(valid, rc_tf, zero)


# ---------------------------------------------------------------------------
# 64-bit mixing for the sparse 23-mer index
# ---------------------------------------------------------------------------

# np scalars, not jnp: creating a jnp scalar at import time would
# initialise the XLA backend before jax.distributed.initialize can run
_MIX_M1 = np.uint64(0xFF51AFD7ED558CCD)
_MIX_M2 = np.uint64(0xC4CEB9FE1A85EC53)


def mix64(x: jax.Array) -> jax.Array:
    """Murmur3 fmix64 finaliser — the avalanche primitive behind the MPHF
    triple hash (role of jenkins64 in /root/reference/src/emphf/base_hash.hpp:38-91;
    the mixing constants are the public MurmurHash3 ones, not copied code)."""
    x = x.astype(jnp.uint64)
    x ^= x >> 33
    x *= _MIX_M1
    x ^= x >> 33
    x *= _MIX_M2
    x ^= x >> 33
    return x


def hash_triple(keys: jax.Array, seed, domain) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Three independent node indices in [0, domain) per key.

    The MPHF places node i of a key in partition i (node id = i*domain + h_i),
    mirroring the 3-partition hypergraph construction of emphf
    (/root/reference/src/emphf/mphf.hpp:21-67).
    """
    seed = jnp.uint64(seed)
    domain = jnp.uint64(domain)
    h = mix64(keys ^ seed)
    h0 = h % domain
    h1 = mix64(h ^ jnp.uint64(0x9E3779B97F4A7C15)) % domain
    h2 = mix64(h + jnp.uint64(0x165667B19E3779F9)) % domain
    return h0, h1 + domain, h2 + jnp.uint64(2) * domain


@jax.jit
def mphf_lookup(g_packed: jax.Array, slots: jax.Array, keys: jax.Array,
                seed: jax.Array, domain: jax.Array) -> jax.Array:
    """Batched MPHF slot lookup: 4 gathers per key.

    ``g_packed`` holds 2-bit g-values packed 16 per uint32 word (value 3 =
    node unassigned); ``slots`` maps owner node -> slot id directly, trading
    memory for the block-rank walk of the reference
    (/root/reference/src/emphf/ranked_bitpair_vector.hpp:47-62) — a direct
    int32 gather is one HBM access instead of rank arithmetic.
    Returns int32 slot ids (unverified — caller checks against the checker
    array per /root/reference/src/hash.hpp:123-140).
    """
    n0, n1, n2 = hash_triple(keys, seed, domain)

    def gval(node):
        word = g_packed[(node >> jnp.uint64(4)).astype(jnp.int32)]
        shift = ((node & jnp.uint64(15)) * jnp.uint64(2)).astype(jnp.uint32)
        return (word >> shift) & jnp.uint32(3)

    v = (gval(n0) + gval(n1) + gval(n2)) % 3
    node = jnp.where(v == 0, n0, jnp.where(v == 1, n1, n2))
    return slots[node.astype(jnp.int32)]


def mphf_owner_node(g_packed: jax.Array, keys: jax.Array, seed: jax.Array,
                    domain: jax.Array) -> jax.Array:
    """Owner node per key WITHOUT the node->slot gather (int32).

    The sharded query engine shards the node->slot table by node range
    (parallel/query23.py) — only the 2-bit g-values (~1 bit/key) stay
    replicated, so per-device index memory actually falls with mesh size.
    """
    n0, n1, n2 = hash_triple(keys, seed, domain)

    def gval(node):
        word = g_packed[(node >> jnp.uint64(4)).astype(jnp.int32)]
        shift = ((node & jnp.uint64(15)) * jnp.uint64(2)).astype(jnp.uint32)
        return (word >> shift) & jnp.uint32(3)

    v = (gval(n0) + gval(n1) + gval(n2)) % 3
    node = jnp.where(v == 0, n0, jnp.where(v == 1, n1, n2))
    return node.astype(jnp.int32)
