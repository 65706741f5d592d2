// Native GF(256) Reed-Solomon kernels + CRC32C.
//
// The reference gets these from vendored native code:
// klauspost/reedsolomon's AVX2/SSSE3 assembly (used at
// weed/storage/erasure_coding/ec_encoder.go:202) and the
// hardware Castagnoli CRC in hash/crc32 (weed/storage/needle/crc.go:12).
// This file re-implements both for the host-side CPU path: the same
// split-nibble PSHUFB trick for GF(256) multiply (16-entry low/high
// tables per coefficient, 16 bytes per instruction) with a portable
// table fallback, and CRC32C via SSE4.2 crc32
// instructions with a slicing-by-8 software fallback.
//
// Field: poly 0x11d, generator 2 — matches seaweedfs_tpu_torch/ops/gf256.py
// and klauspost, so shard bytes interoperate.
//
// Build: seaweedfs_tpu_torch/native/build.py -> _build/libgf256_codec-<hash>.so
// (ctypes). A copy of seaweedfs_tpu/native/gf256_codec.cc.

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#define HAVE_AVX2 1
#endif
#if defined(__SSSE3__)
#include <tmmintrin.h>
#define HAVE_SSSE3 1
#endif
#if defined(__SSE4_2__)
#include <nmmintrin.h>
#define HAVE_SSE42 1
#endif

namespace {

constexpr unsigned kPoly = 0x11d;

uint8_t MUL[256][256];
// Per-coefficient split-nibble tables: product of c with (low nibble)
// and with (high nibble << 4). c*b = LOW[c][b&15] ^ HIGH[c][b>>4].
alignas(16) uint8_t LOW[256][16];
alignas(16) uint8_t HIGH[256][16];

uint8_t gf_mul_slow(unsigned a, unsigned b) {
  unsigned r = 0;
  while (b) {
    if (b & 1) r ^= a;
    a <<= 1;
    if (a & 0x100) a ^= kPoly;
    b >>= 1;
  }
  return static_cast<uint8_t>(r);
}

struct TableInit {
  TableInit() {
    for (unsigned a = 0; a < 256; ++a)
      for (unsigned b = 0; b < 256; ++b) MUL[a][b] = gf_mul_slow(a, b);
    for (unsigned c = 0; c < 256; ++c)
      for (unsigned n = 0; n < 16; ++n) {
        LOW[c][n] = MUL[c][n];
        HIGH[c][n] = MUL[c][n << 4];
      }
  }
} table_init;

// dst ^= c * src over n bytes.
void mul_xor_row(uint8_t c, const uint8_t* src, uint8_t* dst, size_t n) {
  if (c == 0) return;
  size_t i = 0;
  if (c == 1) {
    for (; i + 8 <= n; i += 8) {
      uint64_t a, b;
      std::memcpy(&a, dst + i, 8);
      std::memcpy(&b, src + i, 8);
      a ^= b;
      std::memcpy(dst + i, &a, 8);
    }
    for (; i < n; ++i) dst[i] ^= src[i];
    return;
  }
#if HAVE_AVX2
  {
    const __m256i lo_tbl = _mm256_broadcastsi128_si256(
        _mm_load_si128(reinterpret_cast<const __m128i*>(LOW[c])));
    const __m256i hi_tbl = _mm256_broadcastsi128_si256(
        _mm_load_si128(reinterpret_cast<const __m128i*>(HIGH[c])));
    const __m256i nib = _mm256_set1_epi8(0x0f);
    for (; i + 32 <= n; i += 32) {
      __m256i s =
          _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src + i));
      __m256i d =
          _mm256_loadu_si256(reinterpret_cast<const __m256i*>(dst + i));
      __m256i lo = _mm256_and_si256(s, nib);
      __m256i hi = _mm256_and_si256(_mm256_srli_epi64(s, 4), nib);
      __m256i prod = _mm256_xor_si256(_mm256_shuffle_epi8(lo_tbl, lo),
                                      _mm256_shuffle_epi8(hi_tbl, hi));
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + i),
                          _mm256_xor_si256(d, prod));
    }
  }
#endif
#if HAVE_SSSE3
  const __m128i lo_tbl =
      _mm_load_si128(reinterpret_cast<const __m128i*>(LOW[c]));
  const __m128i hi_tbl =
      _mm_load_si128(reinterpret_cast<const __m128i*>(HIGH[c]));
  const __m128i nib = _mm_set1_epi8(0x0f);
  for (; i + 16 <= n; i += 16) {
    __m128i s =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i));
    __m128i d =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(dst + i));
    __m128i lo = _mm_and_si128(s, nib);
    __m128i hi = _mm_and_si128(_mm_srli_epi64(s, 4), nib);
    __m128i prod = _mm_xor_si128(_mm_shuffle_epi8(lo_tbl, lo),
                                 _mm_shuffle_epi8(hi_tbl, hi));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + i),
                     _mm_xor_si128(d, prod));
  }
#endif
  const uint8_t* row = MUL[c];
  for (; i < n; ++i) dst[i] ^= row[src[i]];
}

// 8x8 bit-matrix transpose (Hacker's Delight 7-3). With byte i of the
// little-endian word as matrix row i, byte s of the result packs bit s
// of every input byte — the bytes<->bit-planes pivot of the scheduled
// XOR kernel below.
uint64_t bit_transpose8(uint64_t x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAULL;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCULL;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ULL;
  x = x ^ t ^ (t << 28);
  return x;
}

// ---- CRC32C (Castagnoli, reflected poly 0x82f63b78) ------------------
uint32_t CRC_TBL[8][256];

struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0x82f63b78u ^ (c >> 1) : c >> 1;
      CRC_TBL[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int t = 1; t < 8; ++t)
        CRC_TBL[t][i] =
            CRC_TBL[t - 1][i] >> 8 ^ CRC_TBL[0][CRC_TBL[t - 1][i] & 0xff];
  }
} crc_init;

}  // namespace

extern "C" {

// out[i,:] = XOR_j coef[i,j] * shards[j,:]  over GF(256).
// coef: m*k row-major; shards: k*n row-major; out: m*n row-major
// (zeroed here).
void gf256_coded_matmul(const uint8_t* coef, int m, int k,
                        const uint8_t* shards, int64_t n, uint8_t* out) {
  std::memset(out, 0, static_cast<size_t>(m) * n);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < k; ++j)
      mul_xor_row(coef[i * k + j], shards + static_cast<size_t>(j) * n,
                  out + static_cast<size_t>(i) * n, n);
}

// dst ^= c * src (exposed for incremental/streaming encode).
void gf256_mul_xor(uint8_t c, const uint8_t* src, uint8_t* dst,
                   int64_t n) {
  mul_xor_row(c, src, dst, static_cast<size_t>(n));
}

// Walk a .dat image record-by-record — the hot loop of offline .idx
// reconstruction (`weed fix`, storage/volume.py rebuild_index) and the
// torn-tail integrity check, natively. Header layout per
// storage/needle.py: cookie u32be, id u64be, size u32be (signed;
// <=0 marks a tombstone); record disk size = 16 + size + 4 checksum
// (+8 timestamp for v3), padded to the next multiple of 8 with at
// least one pad byte.
//
// Emits per-record (id, byte offset, signed size) into caller arrays
// of capacity `cap`; returns the record count and stores the byte
// offset after the last whole record in *end_off (a caller seeing
// *end_off < dat_size knows the tail is torn and truncates there).
int64_t dat_scan(const uint8_t* dat, int64_t dat_size, int64_t start,
                 int version, uint64_t* ids, int64_t* offsets,
                 int32_t* sizes, int64_t cap, int64_t* end_off) {
  int64_t off = start, count = 0;
  const int64_t extra = (version >= 3) ? 8 : 0;
  while (off + 16 <= dat_size && count < cap) {
    uint64_t nid = 0;
    for (int b = 0; b < 8; ++b) nid = (nid << 8) | dat[off + 4 + b];
    uint32_t szu = (static_cast<uint32_t>(dat[off + 12]) << 24) |
                   (static_cast<uint32_t>(dat[off + 13]) << 16) |
                   (static_cast<uint32_t>(dat[off + 14]) << 8) |
                   static_cast<uint32_t>(dat[off + 15]);
    int32_t nsize = static_cast<int32_t>(szu);
    int64_t body = (nsize < 0) ? 0 : nsize;
    int64_t total = 16 + body + 4 + extra;
    int64_t disk = total + (8 - (total % 8));  // pad is always 1..8
    if (off + disk > dat_size) break;
    ids[count] = nid;
    offsets[count] = off;
    sizes[count] = nsize;
    ++count;
    off += disk;
  }
  *end_off = off;
  return count;
}

uint32_t crc32c_update(uint32_t crc, const uint8_t* data, int64_t len) {
  crc = ~crc;
  size_t n = static_cast<size_t>(len);
  size_t i = 0;
#if HAVE_SSE42
  for (; i + 8 <= n; i += 8) {
    uint64_t v;
    std::memcpy(&v, data + i, 8);
    crc = static_cast<uint32_t>(_mm_crc32_u64(crc, v));
  }
  for (; i < n; ++i) crc = _mm_crc32_u8(crc, data[i]);
#else
  for (; i + 8 <= n; i += 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data + i, 4);
    std::memcpy(&hi, data + i + 4, 4);
    lo ^= crc;
    crc = CRC_TBL[7][lo & 0xff] ^ CRC_TBL[6][(lo >> 8) & 0xff] ^
          CRC_TBL[5][(lo >> 16) & 0xff] ^ CRC_TBL[4][lo >> 24] ^
          CRC_TBL[3][hi & 0xff] ^ CRC_TBL[2][(hi >> 8) & 0xff] ^
          CRC_TBL[1][(hi >> 16) & 0xff] ^ CRC_TBL[0][hi >> 24];
  }
  for (; i < n; ++i)
    crc = crc >> 8 ^ CRC_TBL[0][(crc ^ data[i]) & 0xff];
#endif
  return ~crc;
}

// Batched CRC32C: m rows of n bytes each -> m crcs (the batched scrub
// pipeline's host-side check, BASELINE.json batched-scrub config).
void crc32c_batch(const uint8_t* rows, int m, int64_t n, uint32_t* out) {
  for (int i = 0; i < m; ++i)
    out[i] = crc32c_update(0, rows + static_cast<size_t>(i) * n, n);
}

// Scheduled bit-plane XOR program (ops/schedule.py `flatten` layout):
// prog = [n_in, n_out, n_ops, (dst, a, b) * n_ops, out_var * n_out]
// with n_in = 8k input bit-planes (bit s of shard row j is var 8j+s)
// and n_out = 8m output planes. Columns are processed in cache-sized
// chunks: bytes pivot to packed bit-planes (bit_transpose8), the op
// list runs as word-wide XORs over plane rows, planes pivot back to
// bytes. Bit-identical with gf256_coded_matmul by construction — the
// schedule rewrites the XOR program, never the shard byte layout.
void gf256_scheduled_matmul(const int32_t* prog, const uint8_t* shards,
                            int k, int64_t n, uint8_t* out) {
  const int n_in = prog[0], n_out = prog[1], n_ops = prog[2];
  const int32_t* ops = prog + 3;
  const int32_t* outs = ops + 3 * static_cast<int64_t>(n_ops);
  const int m = n_out / 8;
  constexpr int64_t kChunk = 4096;       // column bytes per pass
  constexpr int64_t kPlane = kChunk / 8; // packed plane bytes
  constexpr int64_t kWords = kPlane / 8;
  std::vector<uint64_t> pool(
      static_cast<size_t>(n_in + n_ops) * kWords);
  uint8_t* cells = reinterpret_cast<uint8_t*>(pool.data());
  for (int64_t c0 = 0; c0 < n; c0 += kChunk) {
    const int64_t w = std::min(kChunk, n - c0);
    const int64_t wcells = (w + 7) / 8;
    for (int j = 0; j < k; ++j) {
      const uint8_t* src = shards + static_cast<size_t>(j) * n + c0;
      uint8_t* pl = cells + static_cast<size_t>(8 * j) * kPlane;
      for (int64_t i = 0; i < wcells; ++i) {
        uint64_t x = 0;
        const int64_t rem = w - i * 8;
        std::memcpy(&x, src + i * 8,
                    rem >= 8 ? 8 : static_cast<size_t>(rem));
        x = bit_transpose8(x);
        for (int s = 0; s < 8; ++s)
          pl[static_cast<size_t>(s) * kPlane + i] =
              static_cast<uint8_t>(x >> (8 * s));
      }
    }
    for (int o = 0; o < n_ops; ++o) {
      const int32_t* op = ops + 3 * o;
      uint64_t* d = pool.data() + static_cast<size_t>(op[0]) * kWords;
      const uint64_t* a =
          pool.data() + static_cast<size_t>(op[1]) * kWords;
      const uint64_t* b =
          pool.data() + static_cast<size_t>(op[2]) * kWords;
      for (int64_t i = 0; i < kWords; ++i) d[i] = a[i] ^ b[i];
    }
    for (int i = 0; i < m; ++i) {
      const int32_t* ov = outs + 8 * i;
      uint8_t* dst = out + static_cast<size_t>(i) * n + c0;
      for (int64_t j = 0; j < wcells; ++j) {
        uint64_t x = 0;
        for (int s = 0; s < 8; ++s) {
          const int32_t v = ov[s];
          const uint8_t byte =
              v < 0 ? 0 : cells[static_cast<size_t>(v) * kPlane + j];
          x |= static_cast<uint64_t>(byte) << (8 * s);
        }
        x = bit_transpose8(x);
        const int64_t rem = w - j * 8;
        std::memcpy(dst + j * 8, &x,
                    rem >= 8 ? 8 : static_cast<size_t>(rem));
      }
    }
  }
}

int native_simd_level() {
#if HAVE_AVX2
  return 3;
#elif HAVE_SSE42 && HAVE_SSSE3
  return 2;
#elif HAVE_SSSE3
  return 1;
#else
  return 0;
#endif
}

// ---------------------------------------------------------------------------
// Whole-file EC encode — the reference's encodeDatFile hot loop
// (ec_encoder.go:198-235) as one native call. The Python loop (read ->
// gather -> codec -> write) kept a third of the disk idle even with a
// writer thread pool: producer-side numpy copies and ctypes dispatch
// share the GIL with the writers. Here worker threads claim stripe
// rows off an atomic counter and do pread -> GF(256) parity -> pwrite
// at computed offsets with no interpreter anywhere — shard offsets are
// deterministic (row r of `block` bytes lands at r*block in every
// shard file), so workers need no ordering or shared buffers.
//
// Layout identical to ec/geometry.py row_layout: large rows of
// `large_block` while remaining > k*large_block, then small rows of
// `small_block`, the last zero-padded. coef is the m*k parity matrix
// from ops/rs_matrix (klauspost-compatible), so shard bytes are
// byte-identical with every other backend.
// Returns 0 or -errno.
int64_t ec_encode_file(const char* dat_path,
                       const char* const* shard_paths, int n_shards,
                       const uint8_t* coef, int k, int m,
                       int64_t large_block, int64_t small_block,
                       int64_t chunk, int n_threads) {
  if (n_shards != k + m || k <= 0 || m <= 0) return -EINVAL;
  int dat_fd = open(dat_path, O_RDONLY);
  if (dat_fd < 0) return -errno;
  struct stat st;
  if (fstat(dat_fd, &st) != 0) {
    int e = errno;
    close(dat_fd);
    return -e;
  }
  const int64_t dat_size = st.st_size;
  // row layout (must match geometry.row_layout exactly)
  int64_t remaining = dat_size, n_large = 0, n_small = 0;
  while (remaining > large_block * k) {
    n_large++;
    remaining -= large_block * k;
  }
  while (remaining > 0) {
    n_small++;
    remaining -= small_block * k;
  }
  const int64_t shard_size = n_large * large_block + n_small * small_block;
  std::vector<int> fds(n_shards, -1);
  int rc = 0;
  for (int i = 0; i < n_shards && rc == 0; i++) {
    fds[i] = open(shard_paths[i], O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fds[i] < 0 || ftruncate(fds[i], shard_size) != 0) rc = -errno;
  }
  struct Row {
    int64_t dat_start;   // byte offset of the row's first data block
    int64_t shard_off;   // byte offset of the row inside every shard
    int64_t block;
  };
  std::vector<Row> rows;
  rows.reserve((size_t)(n_large + n_small));
  for (int64_t r = 0; r < n_large; r++)
    rows.push_back({r * large_block * k, r * large_block, large_block});
  const int64_t small0 = n_large * large_block * k;
  for (int64_t r = 0; r < n_small; r++)
    rows.push_back({small0 + r * small_block * k,
                    n_large * large_block + r * small_block, small_block});

  if (chunk <= 0) chunk = 2 << 20;
  chunk = std::min<int64_t>(chunk, 4 << 20);  // bounds worker buffers
  std::atomic<size_t> next{0};
  std::atomic<int> err{0};

  auto worker = [&]() {
    const int64_t wmax =
        std::min<int64_t>(chunk, std::max(large_block, small_block));
    std::vector<uint8_t> data((size_t)k * wmax);
    std::vector<uint8_t> parity((size_t)m * wmax);
    while (!err.load(std::memory_order_relaxed)) {
      size_t ri = next.fetch_add(1);
      if (ri >= rows.size()) return;
      const Row& row = rows[ri];
      for (int64_t c0 = 0; c0 < row.block; c0 += wmax) {
        const int64_t w = std::min(wmax, row.block - c0);
        for (int i = 0; i < k; i++) {
          uint8_t* buf = data.data() + (size_t)i * w;
          const int64_t off = row.dat_start + i * row.block + c0;
          const int64_t avail =
              std::max<int64_t>(0, std::min(w, dat_size - off));
          int64_t got = 0;
          while (got < avail) {
            ssize_t r2 = pread(dat_fd, buf + got, avail - got, off + got);
            if (r2 <= 0) {
              err.store(errno ? errno : EIO);
              return;
            }
            got += r2;
          }
          if (avail < w) memset(buf + avail, 0, w - avail);
        }
        memset(parity.data(), 0, (size_t)m * w);
        for (int i = 0; i < m; i++)
          for (int j = 0; j < k; j++)
            mul_xor_row(coef[i * k + j], data.data() + (size_t)j * w,
                        parity.data() + (size_t)i * w, w);
        for (int i = 0; i < n_shards; i++) {
          const uint8_t* src = i < k
                                   ? data.data() + (size_t)i * w
                                   : parity.data() + (size_t)(i - k) * w;
          if (pwrite(fds[i], src, w, row.shard_off + c0) != w) {
            err.store(errno ? errno : EIO);
            return;
          }
        }
      }
    }
  };

  if (rc == 0) {
    if (n_threads < 1) n_threads = 4;
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
    if (err.load()) rc = -err.load();
  }
  close(dat_fd);
  for (int fd : fds)
    if (fd >= 0) close(fd);
  return rc;
}

}  // extern "C"
