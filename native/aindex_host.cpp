// aindex_host: native host-side runtime for aindex-tpu.
//
// The device owns all data-parallel compute (counting, gathers, coverage); this
// library owns the inherently-serial / file-I/O phases the reference
// implements as C++ binaries (SURVEY.md §2.2-2.3):
//
//   * reads preparation: FASTQ/FASTA/plain -> .reads blob + .ridx offsets
//     (role of compute_reads, /root/reference/src/compute_reads.cpp — fresh
//     implementation: single buffered pass, no line-length limits)
//   * newline index scan over an existing blob (role of READS::INDEXER,
//     /root/reference/src/read.hpp:884-954)
//   * MPHF hypergraph peeling (role of emphf's hypergraph_sorter_seq,
//     /root/reference/src/emphf/hypergraph_sorter_seq.hpp:29-102 — same
//     3-partite XOR-trick algorithm family [BDZ/emphf, public], written
//     from scratch against a Murmur-style mixer that is bit-identical to
//     the JAX/numpy twin in aindex_tpu.index.mphf)
//
// C ABI only (loaded via ctypes).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// MPHF peeling
// ---------------------------------------------------------------------------

static inline uint64_t mix64(uint64_t x) {
  // Murmur3 fmix64 finaliser (public constants), matching
  // aindex_tpu/index/mphf.py:_mix64 bit for bit.
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDULL;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ULL;
  x ^= x >> 33;
  return x;
}

static const uint64_t C1 = 0x9E3779B97F4A7C15ULL;
static const uint64_t C2 = 0x165667B19E3779F9ULL;

// Attempt one seed trial of the 3-partite hypergraph peeling.
//
// keys:      n distinct uint64 keys
// domain:    nodes per partition (3*domain nodes total)
// g_out:     uint8[3*domain]; on success holds g-values (3 = unassigned)
// owner_out: int64[n]; on success, owner_out[i] = the node that owns key i
//            (its peel-time free node) — rank(owner) over assigned nodes is
//            the key's slot, so callers can fill slot-ordered tables
//            without a second lookup pass over every key.
// returns 1 on success (fully peelable), 0 on failure.
int32_t mphf_try_build(const uint64_t* keys, int64_t n, uint64_t seed,
                       uint64_t domain, uint8_t* g_out, int64_t* owner_out) {
  const uint64_t n_nodes = 3 * domain;
  if (n_nodes >= (1ULL << 32) || (uint64_t)n >= (1ULL << 32)) return 0;

  // Cache-tight adjacency: ONE uint64 per node packing (degree << 32 |
  // xor-of-edge-ids) — a node touch is one 8-byte random access instead
  // of two. Every phase is blocked with software prefetch: the walk is
  // memory-latency bound (random touches over a multi-MB adjacency), and
  // staging ~32 independent misses per block instead of 3 dependent ones
  // measured 3x on the peel and 6x on the assignment (r5).
  std::vector<uint64_t> adj(n_nodes, 0);
  auto nodes_of = [&](int64_t e, uint32_t nv[3]) {
    uint64_t h = mix64(keys[e] ^ seed);
    nv[0] = (uint32_t)(h % domain);
    nv[1] = (uint32_t)(mix64(h ^ C1) % domain + domain);
    nv[2] = (uint32_t)(mix64(h + C2) % domain + 2 * domain);
  };
  const uint64_t ONE_DEG = 1ULL << 32;
  enum { BL = 32 };
  {
    uint32_t bnod[BL][3];
    for (int64_t e0 = 0; e0 < n; e0 += BL) {
      int cnt = (int)((n - e0 < BL) ? n - e0 : BL);
      for (int i = 0; i < cnt; ++i) {
        nodes_of(e0 + i, bnod[i]);
        __builtin_prefetch(&adj[bnod[i][0]], 1, 1);
        __builtin_prefetch(&adj[bnod[i][1]], 1, 1);
        __builtin_prefetch(&adj[bnod[i][2]], 1, 1);
      }
      for (int i = 0; i < cnt; ++i) {
        uint64_t e = (uint64_t)(e0 + i);
        adj[bnod[i][0]] += ONE_DEG; adj[bnod[i][0]] ^= e;
        adj[bnod[i][1]] += ONE_DEG; adj[bnod[i][1]] ^= e;
        adj[bnod[i][2]] += ONE_DEG; adj[bnod[i][2]] ^= e;
      }
    }
  }

  // Frontier-batched peel: drain the degree-1 stack in blocks; stage 1
  // resolves each entry's edge + node triple and prefetches the adjacency
  // lines, stage 2 re-validates under the current state (an earlier entry
  // in the same block may have consumed the edge) and applies updates.
  // The peel-time node triples are kept for the assignment pass — a
  // sequential re-read beats recomputing 3 hashes per edge there.
  std::vector<uint32_t> stack;
  stack.reserve(n_nodes / 2);
  for (uint64_t v = 0; v < n_nodes; ++v)
    if ((adj[v] >> 32) == 1) stack.push_back((uint32_t)v);

  std::vector<uint32_t> peel_node(n);
  std::vector<uint32_t> peel_nodes3(3 * (size_t)n);
  int64_t n_peeled = 0;
  uint32_t be[BL], bv[BL], bnod[BL][3];
  while (!stack.empty()) {
    int cnt = 0;
    while (cnt < BL && !stack.empty()) {
      uint32_t v = stack.back();
      stack.pop_back();
      if ((adj[v] >> 32) != 1) continue;  // stale entry
      uint32_t e = (uint32_t)adj[v];
      be[cnt] = e; bv[cnt] = v;
      nodes_of(e, bnod[cnt]);
      __builtin_prefetch(&adj[bnod[cnt][0]], 1, 1);
      __builtin_prefetch(&adj[bnod[cnt][1]], 1, 1);
      __builtin_prefetch(&adj[bnod[cnt][2]], 1, 1);
      ++cnt;
    }
    for (int i = 0; i < cnt; ++i) {
      uint32_t v = bv[i];
      if ((adj[v] >> 32) != 1 || (uint32_t)adj[v] != be[i])
        continue;  // consumed by an earlier entry of this block
      uint32_t e = be[i];
      peel_node[n_peeled] = v;
      peel_nodes3[3 * n_peeled] = bnod[i][0];
      peel_nodes3[3 * n_peeled + 1] = bnod[i][1];
      peel_nodes3[3 * n_peeled + 2] = bnod[i][2];
      owner_out[e] = (int64_t)v;  // the free node is the edge's owner
      ++n_peeled;
      for (int j = 0; j < 3; ++j) {
        uint64_t a = adj[bnod[i][j]] - ONE_DEG;
        a ^= (uint64_t)e;
        adj[bnod[i][j]] = a;
        if ((a >> 32) == 1) stack.push_back(bnod[i][j]);
      }
    }
  }
  if (n_peeled != n) return 0;

  // Reverse-order assignment from the stored triples (sequential read +
  // prefetched g touches): for each peeled edge, set the free node's g so
  // that (g[v0]+g[v1]+g[v2]) % 3 == index-of-free-node-in-edge.
  memset(g_out, 3, (size_t)n_nodes);
  for (int64_t i = n - 1; i >= 0; --i) {
    if (i >= 8) {
      __builtin_prefetch(&g_out[peel_nodes3[3 * (i - 8)]], 1, 1);
      __builtin_prefetch(&g_out[peel_nodes3[3 * (i - 8) + 1]], 1, 1);
      __builtin_prefetch(&g_out[peel_nodes3[3 * (i - 8) + 2]], 1, 1);
    }
    uint32_t v = peel_node[i];
    const uint32_t* nv = &peel_nodes3[3 * i];
    int64_t sum = 0;
    int32_t j = 0;
    for (int t = 0; t < 3; ++t) {
      uint32_t u = nv[t];
      if (u == v) j = t;
      else if (g_out[u] != 3) sum += g_out[u];
    }
    g_out[v] = (uint8_t)(((j - sum) % 3 + 3) % 3);
  }
  return 1;
}

// Cuckoo hash table build (2-table, random-walk eviction).
//
// Query-time accelerator for the sparse k-mer index: the device answers a
// verified (key -> tf, slot) lookup with exactly two 16-byte row gathers
// instead of the MPHF walk's seven element gathers. Layout: table[2m][4]
// uint32 rows = (key_lo, key_hi, tf, slot); half 0 = rows [0, m), half 1 =
// rows [m, 2m); empty marker key_hi = 0xFFFFFFFF (keys are < 2^62).
//
// Returns 1 on success, 0 if an insertion path exceeded max_kicks (caller
// retries with new seeds or a larger m).
int32_t cuckoo_build(const uint64_t* keys, const uint32_t* tf,
                     const int32_t* slot, int64_t n, uint64_t m,
                     uint64_t seed1, uint64_t seed2, uint32_t* table) {
  const uint64_t mask = m - 1;  // m is a power of two
  for (uint64_t r = 0; r < 2 * m; ++r) {
    table[r * 4 + 0] = 0;
    table[r * 4 + 1] = 0xFFFFFFFFu;
    table[r * 4 + 2] = 0;
    table[r * 4 + 3] = 0;
  }
  const int max_kicks = 512;
  uint64_t rng = seed1 ^ 0x9E3779B97F4A7C15ULL;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t key = keys[i];
    uint32_t e0 = (uint32_t)(key & 0xFFFFFFFFULL);
    uint32_t e1 = (uint32_t)(key >> 32);
    uint32_t e2 = tf[i];
    uint32_t e3 = (uint32_t)slot[i];
    int half = 0;
    int kicks = 0;
    for (;;) {
      uint64_t k64 = ((uint64_t)e1 << 32) | e0;
      uint64_t h = half == 0 ? mix64(k64 ^ seed1) : mix64(k64 ^ seed2);
      uint64_t row = (h & mask) + (half ? m : 0);
      uint32_t* cell = table + row * 4;
      if (cell[1] == 0xFFFFFFFFu) {
        cell[0] = e0; cell[1] = e1; cell[2] = e2; cell[3] = e3;
        break;
      }
      // evict the occupant, place ours, continue with the evictee
      uint32_t t0 = cell[0], t1 = cell[1], t2 = cell[2], t3 = cell[3];
      cell[0] = e0; cell[1] = e1; cell[2] = e2; cell[3] = e3;
      e0 = t0; e1 = t1; e2 = t2; e3 = t3;
      // evictee came from `half`; try its other half next
      half ^= 1;
      if (++kicks > max_kicks) return 0;
      // occasional random restart of half choice to break rare cycles
      rng = mix64(rng);
      if ((kicks & 63) == 0 && (rng & 1)) half ^= 1;
    }
  }
  return 1;
}

// Quotiented cuckoo build (round-5 engine; see aindex_tpu/index/quotcuckoo.py).
//
// Each half-table has its own xorshift-multiply bijection on the 2k-bit code
// space; a row stores (fingerprint = hash >> lb, tf) in 8 bytes plus the slot
// id in a parallel int32 column. Row index + fingerprint reconstruct the full
// hash, hence (bijection) the full key — fingerprint match is exact. The
// builder keeps a transient side array of full keys so evictees can be
// re-hashed without inverting the bijection.
//
// Returns 1 on success, 0 if an insertion path exceeded max_kicks.

static inline uint64_t bij2k(uint64_t x, uint64_t ma, uint64_t mb, int w) {
  const uint64_t mask = (w >= 64) ? ~0ULL : ((1ULL << w) - 1);
  const int s = (w + 1) / 2;
  x &= mask;
  x ^= x >> s;
  x = (x * ma) & mask;
  x ^= x >> s;
  x = (x * mb) & mask;
  x ^= x >> s;
  return x;
}

int32_t quot_build(const uint64_t* keys, const uint32_t* tf,
                   const int32_t* slot, int64_t n, uint64_t m, int32_t lb,
                   int32_t w, uint64_t m1a, uint64_t m1b, uint64_t m2a,
                   uint64_t m2b, uint32_t* fp_tf, int32_t* slot_col) {
  const uint64_t mask = m - 1;
  for (uint64_t r = 0; r < 2 * m; ++r) {
    fp_tf[r * 2 + 0] = 0xFFFFFFFFu;  // empty marker (fp < 2^31)
    fp_tf[r * 2 + 1] = 0;
    slot_col[r] = 0;
  }
  std::vector<uint64_t> side(2 * m, 0);
  const int max_kicks = 512;
  uint64_t rng = m1a ^ 0x9E3779B97F4A7C15ULL;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t key = keys[i];
    uint32_t etf = tf[i];
    int32_t eslot = slot[i];
    int half = 0;
    int kicks = 0;
    for (;;) {
      uint64_t h = half == 0 ? bij2k(key, m1a, m1b, w)
                             : bij2k(key, m2a, m2b, w);
      uint64_t row = (h & mask) + (half ? m : 0);
      uint32_t* cell = fp_tf + row * 2;
      if (cell[0] == 0xFFFFFFFFu) {
        cell[0] = (uint32_t)(h >> lb);
        cell[1] = etf;
        slot_col[row] = eslot;
        side[row] = key;
        break;
      }
      uint64_t okey = side[row];
      uint32_t otf = cell[1];
      int32_t oslot = slot_col[row];
      cell[0] = (uint32_t)(h >> lb);
      cell[1] = etf;
      slot_col[row] = eslot;
      side[row] = key;
      key = okey; etf = otf; eslot = oslot;
      half ^= 1;
      if (++kicks > max_kicks) return 0;
      rng = mix64(rng);
      if ((kicks & 63) == 0 && (rng & 1)) half ^= 1;
    }
  }
  return 1;
}

// ---------------------------------------------------------------------------
// reads preparation
// ---------------------------------------------------------------------------

static inline char comp_base(char c) {
  switch (c) {
    case 'A': return 'T'; case 'T': return 'A';
    case 'C': return 'G'; case 'G': return 'C';
    case 'a': return 't'; case 't': return 'a';
    case 'c': return 'g'; case 'g': return 'c';
    default:  return c;  // N etc.
  }
}

namespace {

struct LineReader {
  FILE* f;
  std::vector<char> buf;
  explicit LineReader(FILE* f_) : f(f_) { buf.reserve(1 << 12); }
  // Read one line (without trailing newline) into buf; false on EOF.
  bool next() {
    buf.clear();
    int c;
    while ((c = getc_unlocked(f)) != EOF) {
      if (c == '\n') return true;
      buf.push_back((char)c);
    }
    return !buf.empty();
  }
};

struct RidxWriter {
  FILE* f;
  int64_t rid = 0, start = 0;
  void record(int64_t len) {
    fprintf(f, "%lld\t%lld\t%lld\n", (long long)rid, (long long)start,
            (long long)(start + len));
    start += len + 1;  // +1 for the newline separator
    ++rid;
  }
};

}  // namespace

// FASTQ (paired) -> .reads (+.ridx): each pair becomes r1 + '~' + revcomp(r2)
// on one line (semantics of /root/reference/src/compute_reads.cpp:89-96).
// in2 == NULL -> single-end. Returns number of reads, or -1 on error.
int64_t compute_reads_fastq(const char* in1, const char* in2,
                            const char* out_prefix) {
  FILE* f1 = fopen(in1, "rb");
  if (!f1) return -1;
  FILE* f2 = in2 ? fopen(in2, "rb") : nullptr;
  if (in2 && !f2) { fclose(f1); return -1; }

  std::string reads_path = std::string(out_prefix) + ".reads";
  std::string ridx_path = std::string(out_prefix) + ".ridx";
  FILE* fr = fopen(reads_path.c_str(), "wb");
  FILE* fx = fopen(ridx_path.c_str(), "wb");
  if (!fr || !fx) { if (fr) fclose(fr); if (fx) fclose(fx);
                    fclose(f1); if (f2) fclose(f2); return -1; }

  LineReader r1(f1);
  RidxWriter ridx{fx};
  std::vector<char> rc;
  if (f2) {
    LineReader r2(f2);
    while (true) {
      // record = header / seq / + / qual
      if (!r1.next()) break;
      if (!r1.next()) break;
      std::vector<char> s1 = r1.buf;
      r1.next(); r1.next();
      if (!r2.next()) break;
      if (!r2.next()) break;
      std::vector<char> s2 = r2.buf;
      r2.next(); r2.next();

      rc.resize(s2.size());
      for (size_t i = 0; i < s2.size(); ++i)
        rc[i] = comp_base(s2[s2.size() - 1 - i]);

      fwrite(s1.data(), 1, s1.size(), fr);
      putc_unlocked('~', fr);
      fwrite(rc.data(), 1, rc.size(), fr);
      putc_unlocked('\n', fr);
      ridx.record((int64_t)(s1.size() + 1 + rc.size()));
    }
    fclose(f2);
  } else {
    while (true) {
      if (!r1.next()) break;
      if (!r1.next()) break;
      fwrite(r1.buf.data(), 1, r1.buf.size(), fr);
      putc_unlocked('\n', fr);
      ridx.record((int64_t)r1.buf.size());
      r1.next(); r1.next();
    }
  }
  fclose(f1); fclose(fr); fclose(fx);
  return ridx.rid;
}

// FASTA -> .reads (+.ridx, .header). Multi-line records are concatenated
// (semantics of /root/reference/src/compute_reads.cpp:170-217).
int64_t compute_reads_fasta(const char* in, const char* out_prefix) {
  FILE* f = fopen(in, "rb");
  if (!f) return -1;
  std::string reads_path = std::string(out_prefix) + ".reads";
  std::string ridx_path = std::string(out_prefix) + ".ridx";
  std::string head_path = std::string(out_prefix) + ".header";
  FILE* fr = fopen(reads_path.c_str(), "wb");
  FILE* fx = fopen(ridx_path.c_str(), "wb");
  FILE* fh = fopen(head_path.c_str(), "wb");
  if (!fr || !fx || !fh) { if (fr) fclose(fr); if (fx) fclose(fx);
                           if (fh) fclose(fh); fclose(f); return -1; }

  LineReader lr(f);
  RidxWriter ridx{fx};
  std::string header;
  std::vector<char> seq;
  bool have = false;
  auto flush = [&]() {
    if (!have) return;
    fprintf(fh, "%s\t%lld\t%lld\n", header.c_str(), (long long)ridx.start,
            (long long)seq.size());
    fwrite(seq.data(), 1, seq.size(), fr);
    putc_unlocked('\n', fr);
    ridx.record((int64_t)seq.size());
    seq.clear();
  };
  while (lr.next()) {
    if (!lr.buf.empty() && lr.buf[0] == '>') {
      flush();
      header.assign(lr.buf.begin() + 1, lr.buf.end());
      have = true;
    } else {
      seq.insert(seq.end(), lr.buf.begin(), lr.buf.end());
    }
  }
  flush();
  fclose(f); fclose(fr); fclose(fx); fclose(fh);
  return ridx.rid;
}

// Plain reads file -> .ridx (and optional copy). Returns n_reads.
int64_t compute_reads_plain(const char* in, const char* out_prefix,
                            int32_t copy) {
  FILE* f = fopen(in, "rb");
  if (!f) return -1;
  std::string ridx_path = std::string(out_prefix) + ".ridx";
  FILE* fx = fopen(ridx_path.c_str(), "wb");
  FILE* fr = nullptr;
  if (copy) {
    std::string reads_path = std::string(out_prefix) + ".reads";
    fr = fopen(reads_path.c_str(), "wb");
    if (!fr) { fclose(f); fclose(fx); return -1; }
  }
  if (!fx) { fclose(f); if (fr) fclose(fr); return -1; }
  LineReader lr(f);
  RidxWriter ridx{fx};
  while (lr.next()) {
    if (fr) {
      fwrite(lr.buf.data(), 1, lr.buf.size(), fr);
      putc_unlocked('\n', fr);
    }
    ridx.record((int64_t)lr.buf.size());
  }
  fclose(f); fclose(fx); if (fr) fclose(fr);
  return ridx.rid;
}

// Newline scan of a memory blob: fills starts/ends (caller-allocated,
// capacity max_reads). Returns number of reads found (lines), or -1 if
// capacity is insufficient.
int64_t scan_newlines(const uint8_t* blob, int64_t size, int64_t* starts,
                      int64_t* ends, int64_t max_reads) {
  int64_t n = 0, start = 0;
  const uint8_t* p = blob;
  const uint8_t* end = blob + size;
  while (p < end) {
    const uint8_t* nl = (const uint8_t*)memchr(p, '\n', (size_t)(end - p));
    int64_t stop = nl ? (int64_t)(nl - blob) : size;
    if (n >= max_reads) return -1;
    starts[n] = start;
    ends[n] = stop;
    ++n;
    if (!nl) break;
    start = stop + 1;
    p = blob + start;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Jenkins lookup8 triple over 2-bit k-mer codes (k <= 32)
// ---------------------------------------------------------------------------
//
// Scalar C twin of aindex_tpu/index/emphf.py:jenkins_triple_codes (itself a
// vectorised reimplementation of the public Jenkins lookup8 hash the emphf
// format specifies) — ~10x the numpy path for the 4^13-scale batches of
// dense reference loads and exact emphf builds.

static inline void jmix(uint64_t& a, uint64_t& b, uint64_t& c) {
  a -= b; a -= c; a ^= c >> 43;
  b -= c; b -= a; b ^= a << 9;
  c -= a; c -= b; c ^= b >> 8;
  a -= b; a -= c; a ^= c >> 38;
  b -= c; b -= a; b ^= a << 23;
  c -= a; c -= b; c ^= b >> 5;
  a -= b; a -= c; a ^= c >> 35;
  b -= c; b -= a; b ^= a << 49;
  c -= a; c -= b; c ^= b >> 11;
  a -= b; a -= c; a ^= c >> 12;
  b -= c; b -= a; b ^= a << 18;
  c -= a; c -= b; c ^= b >> 22;
}

void jenkins_triple_codes(const uint64_t* codes, int64_t n, int32_t k,
                          uint64_t seed, uint64_t* h0, uint64_t* h1,
                          uint64_t* h2) {
  static const char BASES[4] = {'A', 'C', 'G', 'T'};
  for (int64_t i = 0; i < n; ++i) {
    uint8_t buf[32] = {0};
    const uint64_t code = codes[i];
    for (int32_t j = 0; j < k; ++j)
      buf[j] = BASES[(code >> (2 * (k - 1 - j))) & 3];
    uint64_t w[4];
    memcpy(w, buf, 32);  // little-endian text words, zero-padded past k
    uint64_t a = seed, b = seed, c = 0x9E3779B97F4A7C13ULL;
    int32_t col = 0, rem = k;
    if (k >= 24) {
      a += w[0]; b += w[1]; c += w[2];
      jmix(a, b, c);
      rem -= 24; col = 3;
    }
    c += (uint64_t)k;
    if (rem > 0) a += w[col];
    if (rem > 8) b += w[col + 1];
    if (rem > 16) c += w[col + 2] << 8;
    jmix(a, b, c);
    h0[i] = a; h1[i] = b; h2[i] = c;
  }
}

// ---------------------------------------------------------------------------
// Bit-exact emphf construction (peel + assign)
// ---------------------------------------------------------------------------
//
// Reproduces the reference builder's peeling ORDER and assignment exactly
// (hypergraph_sorter_seq.hpp:29-102 + mphf.hpp:53-64), so that — given the
// same key set and seed — the resulting g-vector is byte-identical to what
// compute_mphf_seq writes. The XOR-trick adjacency is order-independent,
// but the ASSIGNMENT depends on the sequential peel order, which the
// vectorised round-synchronous peel above cannot reproduce; this one can.
//
// nodes0/1/2: per-edge node ids, already partition-offset
//             (n0 < domain <= n1 < 2*domain <= n2 < 3*domain), uint32.
// g_out:      uint8[3*domain], caller-zeroed; unassigned nodes stay 0.
// returns 1 when fully peelable, 0 otherwise.
int32_t emphf_peel_assign(const uint32_t* nodes0, const uint32_t* nodes1,
                          const uint32_t* nodes2, int64_t n, uint64_t domain,
                          uint8_t* g_out) {
  const uint64_t m = 3 * domain;
  std::vector<uint32_t> deg(m, 0), v1s(m, 0), v2s(m, 0);
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t a = nodes0[i], b = nodes1[i], c = nodes2[i];
    deg[a]++; v1s[a] ^= b; v2s[a] ^= c;   // (a, b, c)
    deg[b]++; v1s[b] ^= a; v2s[b] ^= c;   // (b, a, c)
    deg[c]++; v1s[c] ^= a; v2s[c] ^= b;   // (c, a, b)
  }
  std::vector<uint32_t> o0, o1, o2;       // peeling order (v0, v1, v2)
  o0.reserve(n); o1.reserve(n); o2.reserve(n);

  auto visit = [&](uint32_t v) {
    if (deg[v] != 1) return;
    const uint32_t e1 = v1s[v], e2 = v2s[v];
    o0.push_back(v); o1.push_back(e1); o2.push_back(e2);
    // canonicalise (x0 < x1 < x2) and delete from all three adj lists
    uint32_t x0 = v, x1 = e1, x2 = e2;
    if (x0 > x2) { uint32_t t = x0; x0 = x2; x2 = t; }
    if (x0 > x1) { uint32_t t = x0; x0 = x1; x1 = t; }
    deg[x0]--; v1s[x0] ^= x1; v2s[x0] ^= x2;
    deg[x1]--; v1s[x1] ^= x0; v2s[x1] ^= x2;
    deg[x2]--; v1s[x2] ^= x0; v2s[x2] ^= x1;
  };

  size_t qp = 0;
  for (uint64_t v = 0; v < m; ++v) {
    visit((uint32_t)v);
    while (qp < o0.size()) {
      // o1/o2 may reallocate inside visit — copy before the calls
      const uint32_t a = o1[qp], b = o2[qp];
      visit(a);
      visit(b);
      ++qp;
    }
  }
  if ((int64_t)o0.size() < n) return 0;

  // reverse assignment, emphf convention (mphf.hpp:57-64)
  for (int64_t i = n - 1; i >= 0; --i) {
    const uint32_t v0 = o0[i], v1 = o1[i], v2 = o2[i];
    const uint64_t target = (uint64_t)(v0 > v1) + (uint64_t)(v0 > v2);
    const uint64_t assigned = (uint64_t)g_out[v1] + (uint64_t)g_out[v2];
    const uint64_t val = (target - assigned + 9) % 3;
    g_out[v0] = (uint8_t)(val ? val : 3);
  }
  return 1;
}

}  // extern "C" (reopened below — the templated helpers need C++ linkage)

// ---------------------------------------------------------------------------
// Host query fast paths (the ASCII-batch engine, core/hostdev.py)
// ---------------------------------------------------------------------------

// One k-mer: ASCII -> packed big-endian 2-bit code + validity. The 2<->3
// swap trick: x = (c >> 1) & 3 gives A=0 C=1 G=3 T=2; x ^ (x >> 1) fixes
// G/T. Templated on K so the compiler fully unrolls the dependency chain.
template <int K>
static inline uint64_t encode_one(const uint8_t* s, uint8_t* ok_out) {
  uint64_t code = 0;
  uint8_t ok = 1;
  for (int32_t j = 0; j < K; ++j) {
    uint8_t c = s[j];
    uint8_t up = c & 0xDF;
    ok &= (uint8_t)(up == 'A' || up == 'C' || up == 'G' || up == 'T');
    uint8_t x = (c >> 1) & 3;
    code = (code << 2) | (uint8_t)(x ^ (x >> 1));
  }
  *ok_out = ok;
  return code;
}

static inline uint64_t encode_one_rt(const uint8_t* s, int32_t k,
                                     uint8_t* ok_out) {
  switch (k) {  // common k's get unrolled bodies
    case 13: return encode_one<13>(s, ok_out);
    case 23: return encode_one<23>(s, ok_out);
    default: {
      uint64_t code = 0;
      uint8_t ok = 1;
      for (int32_t j = 0; j < k; ++j) {
        uint8_t c = s[j];
        uint8_t up = c & 0xDF;
        ok &= (uint8_t)(up == 'A' || up == 'C' || up == 'G' || up == 'T');
        uint8_t x = (c >> 1) & 3;
        code = (code << 2) | (uint8_t)(x ^ (x >> 1));
      }
      *ok_out = ok;
      return code;
    }
  }
}

extern "C" {

// ASCII -> 2-bit codes for a flat run of n equal-length k-mers.
// codes[i] gets the packed big-endian 2-bit code (junk but in-range when the
// k-mer has a non-ACGT base); valid[i] = 1 iff all k bases are ACGT/acgt.
int64_t encode_kmers_2bit(const uint8_t* raw, int64_t n, int32_t k,
                          uint64_t* codes, uint8_t* valid) {
  for (int64_t i = 0; i < n; ++i)
    codes[i] = encode_one_rt(raw + (size_t)i * k, k, &valid[i]);
  return n;
}

static inline uint64_t revcomp_code(uint64_t x, int32_t k) {
  x = ~x;
  x = ((x >> 2) & 0x3333333333333333ULL) | ((x & 0x3333333333333333ULL) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((x & 0x0F0F0F0F0F0F0F0FULL) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFULL) | ((x & 0x00FF00FF00FF00FFULL) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFULL) | ((x & 0x0000FFFF0000FFFFULL) << 16);
  x = (x >> 32) | (x << 32);
  return x >> (64 - 2 * k);
}

// Host spectrum engine: ASCII chunk -> sorted unique canonical k-mer
// codes + counts, entirely on the host (the zero-link-traffic counting
// path for slow device links, kernels/spectrum.py host_chunk_spectrum).
// Rolling 2-bit encode with incremental reverse complement, LSD radix
// sort (16-bit digits), then run-length reduction. Threaded like the
// reference counters (/root/reference/src/count_kmers.cpp byte-range
// workers): each thread encodes + sorts its own byte range (k-1 overlap,
// windows attributed to the range their start falls in), one final pass
// T-way-merges the sorted runs straight into the output.
// keys_out/counts_out must hold n-k+1 entries. Returns n_unique, or -1
// for unsupported k.

static void spectrum_encode_range(const uint8_t* ascii, int64_t lo,
                                  int64_t hi, int64_t n, int32_t k,
                                  std::vector<uint64_t>& out) {
  const uint64_t mask = (1ULL << (2 * k)) - 1;
  const int32_t rc_shift = 2 * (k - 1);
  const int64_t stop = hi + k - 1 < n ? hi + k - 1 : n;
  out.reserve((size_t)(hi - lo));
  uint64_t code = 0, rc = 0;
  int32_t run = 0;
  for (int64_t i = lo; i < stop; ++i) {
    uint8_t c = ascii[i];
    uint8_t up = c & 0xDF;
    if (up == 'A' || up == 'C' || up == 'G' || up == 'T') {
      uint8_t x = (c >> 1) & 3;
      uint8_t b = (uint8_t)(x ^ (x >> 1));
      code = ((code << 2) | b) & mask;
      rc = (rc >> 2) | ((uint64_t)(3 - b) << rc_shift);
      if (++run >= k && i - k + 1 < hi)
        out.push_back(code < rc ? code : rc);
    } else {
      run = 0;
    }
  }
}

static void spectrum_radix_sort(std::vector<uint64_t>& v, int32_t k) {
  const int64_t m = (int64_t)v.size();
  if (m <= 1) return;
  std::vector<uint64_t> tmp((size_t)m);
  std::vector<int64_t> count(65537);
  uint64_t* a = v.data();
  uint64_t* b = tmp.data();
  const int passes = (2 * k + 15) / 16;
  for (int p = 0; p < passes; ++p) {
    std::fill(count.begin(), count.end(), 0);
    const int shift = 16 * p;
    for (int64_t i = 0; i < m; ++i) count[((a[i] >> shift) & 0xFFFF) + 1]++;
    for (int d = 0; d < 65536; ++d) count[d + 1] += count[d];
    for (int64_t i = 0; i < m; ++i)
      b[count[(a[i] >> shift) & 0xFFFF]++] = a[i];
    uint64_t* t = a; a = b; b = t;
  }
  if (a != v.data()) v.swap(tmp);  // odd pass count ends in tmp
}

int64_t host_spectrum_ascii(const uint8_t* ascii, int64_t n, int32_t k,
                            int32_t nthreads, uint64_t* keys_out,
                            uint64_t* counts_out) {
  if (k < 1 || k > 31) return -1;
  if (n < k) return 0;
  int T = nthreads > 0 ? nthreads : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  const int64_t n_starts = n - k + 1;
  if (n_starts < 4 * 65536) T = 1;  // threading overhead not worth it
  if ((int64_t)T > n_starts) T = 1;

  std::vector<std::vector<uint64_t>> parts((size_t)T);
  if (T == 1) {
    spectrum_encode_range(ascii, 0, n_starts, n, k, parts[0]);
    spectrum_radix_sort(parts[0], k);
  } else {
    std::vector<std::thread> threads;
    const int64_t per = (n_starts + T - 1) / T;
    for (int t = 0; t < T; ++t) {
      int64_t lo = (int64_t)t * per;
      int64_t hi = lo + per < n_starts ? lo + per : n_starts;
      threads.emplace_back([&, t, lo, hi]() {
        spectrum_encode_range(ascii, lo, hi, n, k, parts[t]);
        spectrum_radix_sort(parts[t], k);
      });
    }
    for (auto& th : threads) th.join();
  }

  // T-way merge of sorted runs + run-length reduce in one pass
  std::vector<size_t> pos((size_t)T, 0);
  int64_t u = 0;
  uint64_t cur = 0, cnt = 0;
  for (;;) {
    int best = -1;
    uint64_t best_v = 0;
    for (int t = 0; t < T; ++t) {
      if (pos[t] < parts[t].size()) {
        uint64_t v = parts[t][pos[t]];
        if (best < 0 || v < best_v) { best = t; best_v = v; }
      }
    }
    if (best < 0) break;
    pos[best]++;
    if (cnt && best_v == cur) {
      ++cnt;
    } else {
      if (cnt) { keys_out[u] = cur; counts_out[u] = cnt; ++u; }
      cur = best_v; cnt = 1;
    }
  }
  if (cnt) { keys_out[u] = cur; counts_out[u] = cnt; ++u; }
  return u;
}

// Fused dense 13-mer ASCII batch query: encode + one prefetched table
// gather per key (two for both-directions), threaded over batch slices —
// the dense twin of sparse_query_ascii for the host engine
// (Dense13Index._query_host_ascii). ``table`` is whichever uint32 host
// table serves the call (tf for forward, the fused fwd+rc tf_total for
// totals); mode 2 gathers tf[code] and tf[revcomp(code)] into out1/out2.

static void dense_query_range(const uint8_t* raw, int64_t lo, int64_t hi,
                              int32_t k, const uint32_t* table, int32_t mode,
                              uint32_t* out1, uint32_t* out2) {
  enum { BLOCK = 1024 };
  uint64_t idx1[BLOCK], idx2[BLOCK];
  uint8_t okb[BLOCK];
  for (int64_t b0 = lo; b0 < hi; b0 += BLOCK) {
    int64_t bn = hi - b0 < BLOCK ? hi - b0 : BLOCK;
    for (int64_t t = 0; t < bn; ++t) {
      uint8_t ok;
      uint64_t code = encode_one_rt(raw + (size_t)(b0 + t) * k, k, &ok);
      okb[t] = ok;
      idx1[t] = code;
      __builtin_prefetch(table + code, 0, 1);
      if (mode == 2) {
        uint64_t rc = revcomp_code(code, k);
        idx2[t] = rc;
        __builtin_prefetch(table + rc, 0, 1);
      }
    }
    for (int64_t t = 0; t < bn; ++t) {
      int64_t i = b0 + t;
      out1[i] = okb[t] ? table[idx1[t]] : 0;
      if (mode == 2) out2[i] = okb[t] ? table[idx2[t]] : 0;
    }
  }
}

int64_t dense_query_ascii(const uint8_t* raw, int64_t n, int32_t k,
                          const uint32_t* table, int32_t mode,
                          int32_t nthreads, uint32_t* out1, uint32_t* out2) {
  int T = nthreads > 0 ? nthreads : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if (n < 1 << 16) T = 1;
  if (T == 1) {
    dense_query_range(raw, 0, n, k, table, mode, out1, out2);
    return n;
  }
  std::vector<std::thread> threads;
  const int64_t per = (n + T - 1) / T;
  for (int t = 0; t < T; ++t) {
    int64_t lo = (int64_t)t * per;
    int64_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    threads.emplace_back(dense_query_range, raw, lo, hi, k, table, mode,
                         out1, out2);
  }
  for (auto& th : threads) th.join();
  return n;
}

// Fused sparse-index ASCII batch query: encode + canonicalise + verified
// cuckoo probes + strand (the whole get_tf_values host hot path; mirrors
// Sparse23Index._resolve_host exactly).
//
// The probes are the cost: two dependent random reads of a table far
// bigger than cache. Processing in blocks with software prefetch keeps
// many misses in flight instead of serialising them — measured ~3x the
// naive per-key loop on 1M-key batches.
//
// canonical_keys != 0: probe min(code, rc), strand = 1 if code <= rc else 2.
// canonical_keys == 0: probe forward then revcomp (reference get_freq rule,
// /root/reference/src/hash.hpp:123-140).
static void sparse_query_range(const uint8_t* raw, int64_t lo, int64_t n,
                               int32_t k, int32_t canonical_keys,
                               const uint32_t* table, uint64_t m,
                               uint64_t seed1, uint64_t seed2,
                               uint32_t* tf_out, int32_t* slot_out,
                               int32_t* strand_out) {
  const uint64_t mask = m - 1;
  enum { BLOCK = 1024 };
  uint64_t key1[BLOCK], key2[BLOCK];   // probe keys (fwd or canonical; rc)
  uint64_t row[BLOCK];
  int64_t pend[BLOCK];                 // indices needing the second probe

  for (int64_t b0 = lo; b0 < n; b0 += BLOCK) {
    int64_t bn = n - b0 < BLOCK ? n - b0 : BLOCK;
    // stage 1: encode + canonicalise; issue first-row prefetches
    for (int64_t t = 0; t < bn; ++t) {
      int64_t i = b0 + t;
      uint8_t ok;
      uint64_t code = encode_one_rt(raw + (size_t)i * k, k, &ok);
      uint64_t rc = revcomp_code(code, k);
      if (!ok) {
        tf_out[i] = 0; slot_out[i] = -1; strand_out[i] = 0;
        key1[t] = ~0ULL;  // never matches (cells store keys < 2^62)
        key2[t] = ~0ULL;
        row[t] = 0;
        continue;
      }
      if (canonical_keys) {
        uint64_t canon = code < rc ? code : rc;
        key1[t] = canon; key2[t] = canon;
        strand_out[i] = code <= rc ? 1 : 2;  // provisional; 0 on miss below
      } else {
        key1[t] = code; key2[t] = rc;
        strand_out[i] = 1;                   // provisional
      }
      row[t] = mix64(key1[t] ^ seed1) & mask;
      __builtin_prefetch(table + row[t] * 4, 0, 1);
    }
    // stage 2: first probe; collect misses, prefetch their second row.
    // For canonical tables the second probe reuses the same key with the
    // other hash; for reference tables it probes the revcomp key's FIRST
    // hash (then its second) — handled by a two-round pend loop below.
    int64_t np_ = 0;
    for (int64_t t = 0; t < bn; ++t) {
      int64_t i = b0 + t;
      if (key1[t] == ~0ULL) continue;
      const uint32_t* c = table + row[t] * 4;
      uint32_t lo = (uint32_t)(key1[t] & 0xFFFFFFFFULL);
      uint32_t hi = (uint32_t)(key1[t] >> 32);
      if (c[0] == lo && c[1] == hi) {
        tf_out[i] = c[2]; slot_out[i] = (int32_t)c[3];
      } else {
        pend[np_] = t;
        row[t] = (mix64(key1[t] ^ seed2) & mask) + m;
        __builtin_prefetch(table + row[t] * 4, 0, 1);
        ++np_;
      }
    }
    // stage 3: second probe of key1 (other half)
    int64_t nmiss = 0;
    for (int64_t p = 0; p < np_; ++p) {
      int64_t t = pend[p];
      int64_t i = b0 + t;
      const uint32_t* c = table + row[t] * 4;
      uint32_t lo = (uint32_t)(key1[t] & 0xFFFFFFFFULL);
      uint32_t hi = (uint32_t)(key1[t] >> 32);
      if (c[0] == lo && c[1] == hi) {
        tf_out[i] = c[2]; slot_out[i] = (int32_t)c[3];
      } else if (!canonical_keys && key2[t] != key1[t]) {
        pend[nmiss] = t;                 // fall through to revcomp probes
        row[t] = mix64(key2[t] ^ seed1) & mask;
        __builtin_prefetch(table + row[t] * 4, 0, 1);
        ++nmiss;
      } else {
        tf_out[i] = 0; slot_out[i] = -1; strand_out[i] = 0;
      }
    }
    // stages 4+5 (reference-keyed only): revcomp key, both halves
    for (int round = 0; round < 2 && nmiss; ++round) {
      int64_t nm2 = 0;
      for (int64_t p = 0; p < nmiss; ++p) {
        int64_t t = pend[p];
        int64_t i = b0 + t;
        const uint32_t* c = table + row[t] * 4;
        uint32_t lo = (uint32_t)(key2[t] & 0xFFFFFFFFULL);
        uint32_t hi = (uint32_t)(key2[t] >> 32);
        if (c[0] == lo && c[1] == hi) {
          tf_out[i] = c[2]; slot_out[i] = (int32_t)c[3]; strand_out[i] = 2;
        } else if (round == 0) {
          pend[nm2] = t;
          row[t] = (mix64(key2[t] ^ seed2) & mask) + m;
          __builtin_prefetch(table + row[t] * 4, 0, 1);
          ++nm2;
        } else {
          tf_out[i] = 0; slot_out[i] = -1; strand_out[i] = 0;
        }
      }
      nmiss = nm2;
    }
  }
}

// Threaded like the reference's batch loops would be if they were not
// per-element pybind calls: each worker owns a contiguous slice of the
// query batch (outputs are per-index, so no synchronisation).
int64_t sparse_query_ascii(const uint8_t* raw, int64_t n, int32_t k,
                           int32_t canonical_keys, const uint32_t* table,
                           uint64_t m, uint64_t seed1, uint64_t seed2,
                           int32_t nthreads, uint32_t* tf_out,
                           int32_t* slot_out, int32_t* strand_out) {
  int T = nthreads > 0 ? nthreads : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if (n < 1 << 16) T = 1;  // threading overhead not worth it
  if (T == 1) {
    sparse_query_range(raw, 0, n, k, canonical_keys, table, m, seed1, seed2,
                       tf_out, slot_out, strand_out);
    return n;
  }
  std::vector<std::thread> threads;
  const int64_t per = (n + T - 1) / T;
  for (int t = 0; t < T; ++t) {
    int64_t lo = (int64_t)t * per;
    int64_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    threads.emplace_back(sparse_query_range, raw, lo, hi, k, canonical_keys,
                         table, m, seed1, seed2, tf_out, slot_out,
                         strand_out);
  }
  for (auto& th : threads) th.join();
  return n;
}

// Quotient-layout twin of sparse_query_range (see quot_build above): encode
// + canonical + two 8-byte probes per key, blocked with software prefetch.
// A probe verifies by fingerprint compare — exact by quotient
// reconstruction, no key bytes in the row.
static void sparse_query_range_quot(
    const uint8_t* raw, int64_t lo_i, int64_t n, int32_t k,
    int32_t canonical_keys, const uint32_t* fp_tf, const int32_t* slot_col,
    uint64_t m, int32_t lb, int32_t w, uint64_t m1a, uint64_t m1b,
    uint64_t m2a, uint64_t m2b, uint32_t* tf_out, int32_t* slot_out,
    int32_t* strand_out) {
  const uint64_t mask = m - 1;
  enum { BLOCK = 1024 };
  uint64_t key1[BLOCK], key2[BLOCK];
  uint64_t row[BLOCK], fp[BLOCK];
  int64_t pend[BLOCK];

  for (int64_t b0 = lo_i; b0 < n; b0 += BLOCK) {
    int64_t bn = n - b0 < BLOCK ? n - b0 : BLOCK;
    for (int64_t t = 0; t < bn; ++t) {
      int64_t i = b0 + t;
      uint8_t ok;
      uint64_t code = encode_one_rt(raw + (size_t)i * k, k, &ok);
      uint64_t rc = revcomp_code(code, k);
      if (!ok) {
        tf_out[i] = 0; slot_out[i] = -1; strand_out[i] = 0;
        key1[t] = ~0ULL; key2[t] = ~0ULL; row[t] = 0; fp[t] = ~0ULL;
        continue;
      }
      if (canonical_keys) {
        uint64_t canon = code < rc ? code : rc;
        key1[t] = canon; key2[t] = canon;
        strand_out[i] = code <= rc ? 1 : 2;
      } else {
        key1[t] = code; key2[t] = rc;
        strand_out[i] = 1;
      }
      uint64_t h = bij2k(key1[t], m1a, m1b, w);
      row[t] = h & mask;
      fp[t] = h >> lb;
      __builtin_prefetch(fp_tf + row[t] * 2, 0, 1);
    }
    int64_t np_ = 0;
    for (int64_t t = 0; t < bn; ++t) {
      int64_t i = b0 + t;
      if (key1[t] == ~0ULL) continue;
      const uint32_t* c = fp_tf + row[t] * 2;
      if (c[0] == (uint32_t)fp[t]) {
        tf_out[i] = c[1]; slot_out[i] = slot_col[row[t]];
      } else {
        pend[np_] = t;
        uint64_t h = bij2k(key1[t], m2a, m2b, w);
        row[t] = (h & mask) + m;
        fp[t] = h >> lb;
        __builtin_prefetch(fp_tf + row[t] * 2, 0, 1);
        ++np_;
      }
    }
    int64_t nmiss = 0;
    for (int64_t p = 0; p < np_; ++p) {
      int64_t t = pend[p];
      int64_t i = b0 + t;
      const uint32_t* c = fp_tf + row[t] * 2;
      if (c[0] == (uint32_t)fp[t]) {
        tf_out[i] = c[1]; slot_out[i] = slot_col[row[t]];
      } else if (!canonical_keys && key2[t] != key1[t]) {
        pend[nmiss] = t;
        uint64_t h = bij2k(key2[t], m1a, m1b, w);
        row[t] = h & mask;
        fp[t] = h >> lb;
        __builtin_prefetch(fp_tf + row[t] * 2, 0, 1);
        ++nmiss;
      } else {
        tf_out[i] = 0; slot_out[i] = -1; strand_out[i] = 0;
      }
    }
    for (int round = 0; round < 2 && nmiss; ++round) {
      int64_t nm2 = 0;
      for (int64_t p = 0; p < nmiss; ++p) {
        int64_t t = pend[p];
        int64_t i = b0 + t;
        const uint32_t* c = fp_tf + row[t] * 2;
        if (c[0] == (uint32_t)fp[t]) {
          tf_out[i] = c[1]; slot_out[i] = slot_col[row[t]];
          strand_out[i] = 2;
        } else if (round == 0) {
          pend[nm2] = t;
          uint64_t h = bij2k(key2[t], m2a, m2b, w);
          row[t] = (h & mask) + m;
          fp[t] = h >> lb;
          __builtin_prefetch(fp_tf + row[t] * 2, 0, 1);
          ++nm2;
        } else {
          tf_out[i] = 0; slot_out[i] = -1; strand_out[i] = 0;
        }
      }
      nmiss = nm2;
    }
  }
}

int64_t sparse_query_ascii_quot(
    const uint8_t* raw, int64_t n, int32_t k, int32_t canonical_keys,
    const uint32_t* fp_tf, const int32_t* slot_col, uint64_t m, int32_t lb,
    int32_t w, uint64_t m1a, uint64_t m1b, uint64_t m2a, uint64_t m2b,
    int32_t nthreads, uint32_t* tf_out, int32_t* slot_out,
    int32_t* strand_out) {
  int T = nthreads > 0 ? nthreads : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if (n < 1 << 16) T = 1;
  if (T == 1) {
    sparse_query_range_quot(raw, 0, n, k, canonical_keys, fp_tf, slot_col,
                            m, lb, w, m1a, m1b, m2a, m2b, tf_out, slot_out,
                            strand_out);
    return n;
  }
  std::vector<std::thread> threads;
  const int64_t per = (n + T - 1) / T;
  for (int t = 0; t < T; ++t) {
    int64_t lo = (int64_t)t * per;
    int64_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    threads.emplace_back(sparse_query_range_quot, raw, lo, hi, k,
                         canonical_keys, fp_tf, slot_col, m, lb, w, m1a,
                         m1b, m2a, m2b, tf_out, slot_out, strand_out);
  }
  for (auto& th : threads) th.join();
  return n;
}

}  // extern "C"
