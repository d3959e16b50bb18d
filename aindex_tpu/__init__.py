"""aindex-tpu: a k-mer indexing engine in JAX/XLA.

A from-scratch JAX/XLA rebuild of the capabilities of ad3002/aindex
(reference surveyed in SURVEY.md): dense 13-mer and sparse canonical 23-mer
frequency indexes, positional (k-mer -> read position) indexes, sequence
coverage profiling, De Bruijn continuation queries, and a build pipeline —
all formulated as batched device kernels instead of per-k-mer hashing.
"""

import os as _os

import jax as _jax

# The sparse (k<=32) index packs k-mer codes into uint64; enable 64-bit
# types before any array is created. The dense 13-mer fast path is pure
# 32-bit and unaffected.
_jax.config.update("jax_enable_x64", True)


def _compile_cache_dir() -> str | None:
    """Where this package keeps JAX's persistent compile cache: None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then uses it as is), else
    ``.jax_cache`` beside the package. The path is fixed because it is
    part of every cache key."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


if (_cache := _compile_cache_dir()) is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache)

__version__ = "0.1.0"

from aindex_tpu.api import AIndex  # noqa: E402
from aindex_tpu.core.codec import hamming_distance, revcomp as get_revcomp  # noqa: E402

#: Drop-in name for users porting from the reference's pybind module
#: (``from aindex_cpp import AindexWrapper``): AIndex carries the wrapper's
#: full ~46-method surface (PARITY.md §L2), so the alias is exact.
AindexWrapper = AIndex

__all__ = ["AIndex", "AindexWrapper", "get_revcomp", "hamming_distance",
           "__version__"]
