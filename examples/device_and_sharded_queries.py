"""The device fast paths: device-resident codes-in queries, the
mesh-sharded engine, and the statistics/dump surface.

* codes-in queries are the full-rate path: encode once, keep the 2-bit
  codes on device, query at gather rate (no string handling, no host
  round-trip);
* `shard_to(mesh)` moves the sparse index onto a device mesh — the MPHF
  slots shard by node range, tf/checker by slot range, per-device memory
  falls with mesh size, and EVERY query family keeps working;
* `set_stats` / `save_values` mirror the reference's coverage-profile
  histogram and slot-ordered text dump.

Run: python examples/device_and_sharded_queries.py
(one GPU skips the mesh demo; several GPUs, or a CPU-only box with
 JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8,
 shard over every device)
"""

import numpy as np

from aindex_tpu import AIndex


def main():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = [bytes(bases[rng.integers(0, 4, size=120)]).decode()
             for _ in range(300)]
    idx = AIndex.build_from_sequences(reads, kmer_size=23)

    # --- codes-in device queries ------------------------------------------
    from aindex_tpu.core import codec
    kmers = [r[i:i + 23] for r in reads[:50] for i in (0, 31, 62)]
    codes, _ = codec.encode_kmers(kmers, 23)       # encode once (host)
    codes_dev = jnp.asarray(codes)                 # ... to device, once
    tf_dev = idx.get_tf_values_codes_23mer(codes_dev)   # device in, device out
    print(f"codes-in tf: device array {tf_dev.shape} {tf_dev.dtype}, "
          f"first 8 = {np.asarray(tf_dev)[:8].tolist()}")

    # --- statistics + dump -------------------------------------------------
    s = idx.set_stats(coverage=4)
    print(f"stats: unique={s['unique']} distinct={s['distinct']} "
          f"total={s['total']} max={s['max_count']}")
    print(f"coverage profile: {s['profile'].tolist()}")
    import tempfile, os
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "dump.dat")
        zeros, ones, other = idx.save_values(path)
        print(f"save_values: {ones} singletons, {other} repeated "
              f"-> {sum(1 for _ in open(path))} lines")

    # --- mesh-sharded engine ----------------------------------------------
    n_dev = len(jax.devices())
    if n_dev > 1:
        from aindex_tpu.parallel.mesh import make_mesh
        mesh = make_mesh(n_data=1, n_index=n_dev)
        before = list(idx.get_tf_values(kmers))
        idx.shard_to(mesh)                    # releases unsharded replicas
        assert list(idx.get_tf_values(kmers)) == before
        print(f"sharded over {n_dev} devices: "
              f"{idx._sharded23.per_device_bytes} bytes/device, "
              f"tf/De Bruijn/coverage all served sharded")
        print(f"debruijn_next = {idx.debruijn_next(kmers[0])}")
    else:
        print("single device: shard_to demo skipped "
              "(run with xla_force_host_platform_device_count=8)")


if __name__ == "__main__":
    main()
