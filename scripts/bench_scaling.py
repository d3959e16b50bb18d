"""Multi-device scaling benchmark: count throughput + query qps vs mesh size.

Runs the PUBLIC mesh paths (Dense13Index.build_from_blob(mesh=),
AIndex.build_from_sequences(mesh=) -> sharded queries) at 1/2/4/8 devices
and prints a JSON scaling table (also written to the --out file).

On a multi-GPU host the devices are distinct cards and the table measures
true scaling over their links. On a CPU host with
XLA_FLAGS=--xla_force_host_platform_device_count=8 the "devices" share the
same physical cores, so wall-clock is NOT expected to improve — that run
validates functional scaling (bit-exact parity at every mesh size), which
is what CI uses it for.

Usage:
  PYTHONPATH=. JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python scripts/bench_scaling.py --mb 4 --out scaling.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=4.0,
                    help="size of the synthetic reads blob in MiB")
    ap.add_argument("--queries", type=int, default=1 << 18)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from aindex_tpu.core.reads import ReadsStore
    from aindex_tpu.index.dense13 import Dense13Index
    from aindex_tpu.index.sparse23 import Sparse23Index
    from aindex_tpu.parallel.mesh import make_mesh
    from aindex_tpu.parallel.query23 import ShardedSparse23

    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_bytes = int(args.mb * (1 << 20))
    read_len = 150
    n_reads = n_bytes // (read_len + 1)
    reads = ["".join(map(chr, bases[rng.integers(0, 4, size=read_len)]))
             for _ in range(n_reads)]
    store = ReadsStore.from_sequences(reads)
    print(f"# blob: {store.reads_size / 1e6:.1f} MB, {n_reads} reads, "
          f"backend={jax.default_backend()}, devices={len(jax.devices())}")

    index = Sparse23Index.build_from_blob(store.blob)
    q_kmers = [reads[i % n_reads][j:j + 23]
               for i, j in enumerate(rng.integers(0, read_len - 23,
                                                  size=args.queries))]
    baseline_tf = None

    rows = []
    sizes = [n for n in (1, 2, 4, 8) if n <= len(jax.devices())]
    for n in sizes:
        mesh = make_mesh(n_data=n, devices=jax.devices()[:n])

        # -- dense 13-mer count throughput (bytes/s through the counter) --
        Dense13Index.build_from_blob(store.blob, chunk=1 << 20, mesh=mesh)
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            dense = Dense13Index.build_from_blob(store.blob, chunk=1 << 20,
                                                 mesh=mesh)
            best = min(best, time.perf_counter() - t0)
        count_mbps = store.reads_size / best / 1e6

        # -- sharded 23-mer query qps --
        qmesh = make_mesh(n_data=1, n_index=n, devices=jax.devices()[:n])
        sharded = ShardedSparse23(index, qmesh)
        tf = sharded.get_tf_values(q_kmers)  # warm + compile
        if baseline_tf is None:
            baseline_tf = tf
        else:
            assert (tf == baseline_tf).all(), f"parity broke at n={n}"
        bestq = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            sharded.get_tf_values(q_kmers)
            bestq = min(bestq, time.perf_counter() - t0)
        qps = args.queries / bestq

        row = {"devices": n, "count_MB_per_s": round(count_mbps, 1),
               "query_qps": round(qps, 1)}
        rows.append(row)
        print(json.dumps(row))

    table = {"backend": jax.default_backend(),
             "blob_mb": round(store.reads_size / 1e6, 1),
             "queries": args.queries, "parity": "bit-exact at all sizes",
             "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f, indent=2)
        print(f"# wrote {args.out}")


if __name__ == "__main__":
    main()
