"""Host-side (numpy) 2-bit DNA codecs.

Vectorised equivalents of the reference string<->bit converters
(/root/reference/src/kmers.cpp:12-114 string<->uint conversions,
:288-352 string revcomp, :355-388 bit revcomp). All functions operate on
whole batches at once; scalar wrappers are provided for API parity.

Encoding: A=00, C=01, G=10, T=11 (/root/reference/src/kmers.hpp:15-20).
"""

from __future__ import annotations

import numpy as np

from aindex_tpu.constants import ALPHABET, INVALID_CODE

# ---------------------------------------------------------------------------
# Base-level LUTs
# ---------------------------------------------------------------------------

#: 256-entry ASCII -> 2-bit code table; non-ACGT (incl. lowercase handled
#: separately) map to INVALID_CODE.
BASE_LUT = np.full(256, INVALID_CODE, dtype=np.uint8)
for _i, _b in enumerate(ALPHABET):
    BASE_LUT[ord(_b)] = _i
    BASE_LUT[ord(_b.lower())] = _i

#: ASCII -> uppercased ASCII for ACGT, preserved otherwise.
UPPER_LUT = np.arange(256, dtype=np.uint8)
for _b in ALPHABET:
    UPPER_LUT[ord(_b.lower())] = ord(_b)

#: string revcomp translation (preserves '~' pair separator semantics,
#: /root/reference/src/kmers.cpp:302-303 and aindex/core/aindex.py:34-42).
_REVCOMP_TRANS = str.maketrans("ATCGNatcgn~[]", "TAGCNtagcn~][")

_PACK4 = np.array([64, 16, 4, 1], dtype=np.uint8)  # 4 bases -> 1 byte
_LUT_BYTES = BASE_LUT.tobytes()  # bytes.translate table (C-speed decode)


def revcomp(sequence: str) -> str:
    """Reverse-complement of a DNA string (N preserved, '~' preserved,
    brackets mirrored)."""
    return sequence.translate(_REVCOMP_TRANS)[::-1]


def hamming_distance(s1: str, s2: str) -> int:
    """Hamming distance ignoring positions where either string has 'N'."""
    return sum(a != b for a, b in zip(s1, s2) if a != "N" and b != "N")


# ---------------------------------------------------------------------------
# Sequence bytes -> base codes
# ---------------------------------------------------------------------------

def seq_to_bytes(seq: str | bytes) -> np.ndarray:
    """ASCII bytes of a sequence as a uint8 array (no copy for bytes)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return np.frombuffer(seq, dtype=np.uint8)


def bytes_to_base_codes(ascii_bytes: np.ndarray) -> np.ndarray:
    """Map ASCII bytes to 2-bit base codes (INVALID_CODE for non-ACGT)."""
    return BASE_LUT[ascii_bytes]


# ---------------------------------------------------------------------------
# K-mer strings <-> uint64 codes (batched)
# ---------------------------------------------------------------------------

def encode_kmers(kmers: list[str] | np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Encode a batch of equal-length k-mer strings to uint64 codes.

    Returns ``(codes, valid)`` where ``valid[i]`` is False if kmer i contains
    a non-ACGT character (its code is then unspecified but in-range).

    Vectorised version of get_dna23_bitset / get_dna13_bitset
    (/root/reference/src/kmers.cpp:12-55).
    """
    if k > 32:
        raise ValueError(f"k={k} exceeds the 32-base uint64 code capacity")
    if isinstance(kmers, np.ndarray) and kmers.dtype == np.uint8:
        raw = kmers.tobytes()
    else:
        raw = "".join(kmers).encode("ascii")
    if len(raw) % k:
        raise ValueError(
            f"batch byte length {len(raw)} is not a multiple of k={k} "
            "(mixed-length or ragged k-mer batch)")
    # bytes.translate is the fastest decode on the host (single C pass,
    # ~1.5x a numpy LUT fancy-index); INVALID_CODE marks non-ACGT bases.
    # (A scalar-C native encoder was benchmarked and loses to this
    # vectorised pipeline at batch sizes >= ~100K; native pays off only
    # fused with the cuckoo probes — native.sparse_query_ascii.)
    mat = np.frombuffer(raw.translate(_LUT_BYTES), dtype=np.uint8).reshape(-1, k)
    # max-reduce: INVALID_CODE is the uint8 maximum
    valid = mat.max(axis=1) != INVALID_CODE
    # Pack 4 bases/byte with a uint8 matmul (max 255, exact), then view the
    # big-endian byte strips as one uint64 per k-mer — ~2x the float64
    # BLAS matmul this replaces (no 8-byte-per-base temporary). Invalid
    # bases contribute in-range junk (& 3) under a cleared ``valid``.
    n_bytes = (k + 3) // 4
    padded = np.zeros((mat.shape[0], n_bytes * 4), np.uint8)
    padded[:, :k] = mat & 3
    b4 = padded.reshape(-1, n_bytes, 4) @ _PACK4
    by = np.zeros((mat.shape[0], 8), np.uint8)
    by[:, :n_bytes] = b4[:, ::-1]  # little-endian view => byte 0 is LSB
    codes = by.view("<u8").astype(np.uint64).reshape(-1) \
        >> np.uint64(2 * (4 * n_bytes - k))
    return codes, valid


_PACK4_LE = np.array([1, 4, 16, 64], dtype=np.uint8)


def pack_ascii_chunk(chunk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """ASCII uint8[..., L] (L % 16 == 0) -> (uint32[..., L/16] packed base
    codes, uint8[..., L/8] validity bitmap).

    The device-ingest wire format: 2 bits/base + 1 validity bit/base =
    0.375 bytes/base instead of 1 for raw ASCII — a 2.67x cut of the
    host->device transfer that bounds build throughput (the reference
    streams raw bytes to its workers, /root/reference/src/
    count_kmers13.cpp:166-183; a device build is ingest-bound instead).
    Layout (little-endian both levels): base i sits at bits 2*(i%16) of
    word i//16; its validity at bit i%8 of byte i//8 — so the device
    unpack (kernels.encode.unpack_base_codes) is pure broadcast shifts.
    """
    if chunk.shape[-1] % 16:
        # pad to a word boundary with newline (= invalid) bytes; the extra
        # windows are invalid and masked by every consumer
        pad = 16 - chunk.shape[-1] % 16
        chunk = np.concatenate(
            [chunk, np.full((*chunk.shape[:-1], pad), ord("\n"), np.uint8)],
            axis=-1)
    base = np.frombuffer(chunk.tobytes().translate(_LUT_BYTES),
                         np.uint8).reshape(chunk.shape)
    validbits = np.packbits(base != INVALID_CODE, axis=-1, bitorder="little")
    by = (base & 3).reshape(*chunk.shape[:-1], -1, 4) @ _PACK4_LE
    packed = np.ascontiguousarray(by).view("<u4")
    return packed.reshape(*chunk.shape[:-1], -1), validbits


def encode_kmer(kmer: str) -> int:
    """Single k-mer string -> integer code. Raises on invalid bases."""
    codes, valid = encode_kmers([kmer], len(kmer))
    if not valid[0]:
        raise ValueError(f"k-mer contains non-ACGT characters: {kmer!r}")
    return int(codes[0])


def decode_kmers(codes: np.ndarray, k: int) -> list[str]:
    """Decode uint64 codes back to k-mer strings (batch).

    Vectorised version of get_bitset_dna23 (/root/reference/src/kmers.cpp:89-114).
    """
    codes = np.asarray(codes, dtype=np.uint64).reshape(-1, 1)
    shifts = np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)
    bases = ((codes >> shifts) & np.uint64(3)).astype(np.uint8)
    ascii_mat = np.frombuffer(ALPHABET.encode(), dtype=np.uint8)[bases]
    flat = ascii_mat.tobytes().decode("ascii")
    return [flat[i * k:(i + 1) * k] for i in range(len(codes))]


def decode_kmer(code: int, k: int) -> str:
    return decode_kmers(np.array([code], dtype=np.uint64), k)[0]


# ---------------------------------------------------------------------------
# Bit-level reverse complement (batched, branch-free)
# ---------------------------------------------------------------------------

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_M8 = np.uint64(0x00FF00FF00FF00FF)
_M16 = np.uint64(0x0000FFFF0000FFFF)


def revcomp_code(codes: np.ndarray | int, k: int) -> np.ndarray | int:
    """Reverse complement of 2-bit packed k-mer codes (vectorised).

    Equivalent to reverseDNA (/root/reference/src/kmers.cpp:355-388) but
    branch-free: complement is a bitwise NOT of every 2-bit field (A<->T,
    C<->G are complements under XOR 0b11), then the 2-bit fields of the
    64-bit word are mirrored and shifted down to the low 2k bits.
    """
    scalar = np.isscalar(codes) or (isinstance(codes, np.ndarray) and codes.ndim == 0)
    x = np.asarray(codes, dtype=np.uint64)
    x = ~x  # complement every 2-bit field
    x = ((x >> np.uint64(2)) & _M2) | ((x & _M2) << np.uint64(2))
    x = ((x >> np.uint64(4)) & _M4) | ((x & _M4) << np.uint64(4))
    x = ((x >> np.uint64(8)) & _M8) | ((x & _M8) << np.uint64(8))
    x = ((x >> np.uint64(16)) & _M16) | ((x & _M16) << np.uint64(16))
    x = (x >> np.uint64(32)) | (x << np.uint64(32))
    x = x >> np.uint64(64 - 2 * k)
    return int(x) if scalar else x


def canonical_code(codes: np.ndarray, k: int) -> np.ndarray:
    """min(code, revcomp(code)) — canonical form used by the sparse index
    (/root/reference/src/count_kmers.cpp:132-136)."""
    rc = revcomp_code(codes, k)
    return np.minimum(codes, rc)
