"""Subprocess worker for the 2-process jax.distributed build test.

Launched by tests/test_multihost.py: each worker joins the localhost
coordinator, builds the full pipeline over the GLOBAL (cross-process) mesh,
and exits. Process 0 writes the artifacts; the test then compares them
byte-for-byte with a single-process build.
"""

import os
import sys


def main() -> None:
    port, pid, nproc, fasta, prefix23, prefix13 = sys.argv[1:7]
    import jax
    jax.config.update("jax_platforms", "cpu")
    from aindex_tpu.parallel import distributed
    distributed.initialize(f"localhost:{port}", int(nproc), int(pid))
    assert jax.process_count() == int(nproc), jax.process_count()
    mesh = distributed.global_mesh()

    from aindex_tpu.pipeline.build import BuildConfig, build_all
    # full sparse pipeline: reads prep (proc 0 + barrier), key-sharded
    # spectrum with the cross-process allgather merge, MPHF, slot-range-
    # sharded positional fill with the cross-process segment concat
    build_all([fasta], BuildConfig(prefix=prefix23, k=23, chunk=512,
                                   mesh=mesh))
    # dense 13-mer count (psum over data across processes), positional skipped to
    # keep the CPU-mesh memory footprint of the test small
    build_all([fasta], BuildConfig(prefix=prefix13, k=13, chunk=512,
                                   mesh=mesh, build_aindex=False))
    print(f"worker {pid}: ok "
          f"(process {jax.process_index()}/{jax.process_count()}, "
          f"{jax.local_device_count()} local / {jax.device_count()} global "
          f"devices)", flush=True)


if __name__ == "__main__":
    main()
