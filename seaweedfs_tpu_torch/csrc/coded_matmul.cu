// GF(256) coded matmul for Hopper (sm_90a):
//
//     out[i, c] = XOR_j  coef[i, j] * x[j, c]        (GF(256) products)
//
// Replaces the Pallas TPU kernel seaweedfs_tpu/ops/codec_pallas.py:43
// (`_kernel`, launched by `_coded_matmul_pallas_pm_impl`), which computes
// the same bytes as a bf16 bit-plane matmul laid out for the MXU.
//
// What bounds it on an H100. The least time is the bytes: (k + m) * n
// at 3.35 TB/s, 0.1402 ms for RS(10,4) parity over 32 Mi columns. Above
// that bound sit three limits, which held the previous design (one
// 256-byte table per output row, register loads) to 39% of it:
//
//   * Shared-memory wavefronts. A lookup is a warp-wide shared load at
//     32 data-dependent addresses. A per-output 256-byte table spans 64
//     words, two per bank, and random bytes hit both words of some bank
//     in almost every load: ~2 wavefronts per lookup, one lookup per
//     input byte per output row. At m = 4 that is 8 wavefronts per 32
//     input bytes, ~8.4e7 per 32 Mi-column launch, ~6.4e5 cycles per SM:
//     0.32-0.36 ms at 1.98-1.755 GHz, more than twice the byte bound.
//   * Instruction issue. At the byte bound the card issues ~12 thread
//     instructions per input byte (132 SMs x 4 schedulers x ~1.8 GHz x
//     0.1402 ms x 32 lanes / 335.5 MB). Byte lookups per output row cost
//     ~14 at m = 4 (extract, address, 4 x (load, shift, XOR)).
//   * Bytes in flight. A thread that loads input row j, uses it, then
//     loads row j + 1 keeps one 16-byte load in flight; HBM needs ~15-20
//     KB in flight per SM to stream at 3.35 TB/s.
//
// What this design does about each:
//
//   * Packed product tables. For each group g of up to 4 output rows the
//     wrapper hands over a (k, 256) uint32 table,
//         T[g][j][v] = OR_o (coef[4g + o, j] * v) << 8o,
//     a zero byte for each row missing when m % 4 != 0. A block stages
//     its group's table in shared memory (k KB: 10 KB for RS(10,4)), and
//     one lookup per input byte yields the products for all 4 outputs.
//     The 256-word table puts ~3.15 wavefronts on a warp-wide lookup, so
//     m = 4 costs ~3.15 wavefronts per 32 input bytes instead of 8
//     (~2.5e5 cycles per SM, ~0.14 ms), at ~5.5 instructions per input
//     byte (extract, index, address, load, half a 3-input XOR; read off
//     the SASS). Each thread keeps one packed accumulator word per column
//     (16 columns, 16 words) and transposes them into 4 x 16 output bytes
//     with __byte_perm at the end of a tile (32 PRMT per thread per tile).
//   * Bulk-async input ring. One producer thread (a warp of its own)
//     copies each (rows, 4096-column) stage of the input into shared
//     memory with cp.async.bulk, one copy per input row, completing on
//     the stage's mbarrier (expect_tx). 256 consumer threads read their
//     16 bytes per row with one 16-byte shared load, look up and XOR,
//     then release the stage on its "empty" mbarrier. The grid is
//     persistent (one block per SM walks 4096-column tiles), and each SM
//     keeps ~120 KB of stages in flight (3 of 40 KB for RS(10,4))
//     whatever the register count.
//   * Wide codes. m <= 4 (every RS(10,4) encode and rebuild) reads each
//     input byte once. m > 4 walks output groups in grid.y and reads the
//     input once per group. One launch keeps at most kMaxK table rows
//     resident; the wrapper splits larger k into launches that XOR into
//     the output (`accumulate`). A stage holds at most kMaxRowsPerStage
//     rows; larger k walks a tile's rows over several stages.
//   * Edges. Bulk copies need 16-byte-aligned addresses and sizes. The
//     ring carries every full tile when the input pointer and row stride
//     are multiples of 16 (`ring`); the ragged last tile, and every tile
//     of a misaligned input, go through a direct-load path of this same
//     kernel (16-byte loads when aligned, bytes otherwise). Stores are
//     16-byte vectors when `vec_out`, bytes otherwise; nothing is padded.
//
// On the card (PERF.md): 0.167 ms at the encode shape, 84% of the byte
// bound and ~2.8 TB/s, near the ~3.0 TB/s a device-to-device tensor copy
// reaches there; 0.153 ms at rebuild m = 1. Variants with half the
// wavefronts (16-entry nibble tables) or fewer address instructions ran
// within 3% of this design in the same call, so what is left above the
// bound is the memory system, not the lookups.
//
// Why not tensor cores: a wgmma bit-plane product expands each input
// byte into 8 int8 values in shared memory, ~2.7 GB written and read per
// RS(10,4) launch, ~0.16-0.18 ms at 128 B/clk/SM (1.98-1.755 GHz)
// before any product, more than the whole byte bound.
//
// C interface (bound with ctypes): coded_matmul_launch returns the
// cudaError_t of the launch as an int, 0 on success.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;   // 256 consumer threads
constexpr int kThreads = kConsumers + 32;         // + one producer warp
constexpr int kCols = 16;                         // columns per thread
constexpr int kTile = kConsumers * kCols;         // 4096 columns per tile
constexpr int kMaxStages = 8;
constexpr int kInFlight = 120 * 1024;             // ring bytes per block
constexpr int kMaxRowsPerStage = 16;
constexpr int kMaxK = 64;                         // table rows per launch
constexpr int kHeader = 2 * kMaxStages * 8;       // mbarriers
constexpr int kSmemPerBlock = 227 * 1024;

struct Params {
  const uint32_t* tables;  // group g, row j at tables[g * tab_ld + j * 256]
  long long tab_ld;
  const uint8_t* x;        // (k, n), row stride ldx
  long long ldx;
  uint8_t* out;            // (m, n), row stride ldo
  long long ldo;
  long long n;
  int m, k;
  int kc;                  // input rows per ring stage
  int stages;              // ring depth
  int ring;                // x and ldx 16-byte aligned: full tiles by bulk copy
  int vec_out;             // out and ldo 16-byte aligned
  int accumulate;          // out ^= product instead of out = product
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One input row's 16 bytes into the 16 packed accumulators.
__device__ __forceinline__ void lookup_row(const uint32_t* t, uint4 v,
                                           uint32_t acc[kCols]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      acc[4 * q + b] ^= t[(w[q] >> (8 * b)) & 0xffu];
    }
  }
}

__device__ __forceinline__ uint4 load16(const uint8_t* p, long long avail,
                                        bool vec) {
  if (vec && avail >= kCols) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int c = 0; c < kCols; ++c) {
    if (c < avail) w[c >> 2] |= uint32_t(p[c]) << (8 * (c & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(uint8_t* p, long long avail, bool vec,
                                        bool accumulate, uint4 v) {
  if (vec && avail >= kCols) {
    uint4* q = reinterpret_cast<uint4*>(p);
    if (accumulate) {
      const uint4 old = *q;
      v.x ^= old.x; v.y ^= old.y; v.z ^= old.z; v.w ^= old.w;
    }
    *q = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  for (int c = 0; c < kCols; ++c) {
    if (c < avail) {
      const uint8_t b = uint8_t(w[c >> 2] >> (8 * (c & 3)));
      p[c] = accumulate ? uint8_t(p[c] ^ b) : b;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
coded_matmul_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + kHeader);
  uint8_t* ring = smem + kHeader + p.k * 1024;

  const int g = blockIdx.y;
  const int mo = min(4, p.m - 4 * g);

  // Stage this group's (k, 256) table: k * 64 16-byte words.
  const uint4* src = reinterpret_cast<const uint4*>(p.tables + g * p.tab_ld);
  for (int i = threadIdx.x; i < p.k * 64; i += kThreads) {
    reinterpret_cast<uint4*>(tab)[i] = __ldg(src + i);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_addr(full + s), 1);
      mbar_init(smem_addr(empty + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const long long n_tiles = (p.n + kTile - 1) / kTile;
  const long long n_ring = p.ring ? p.n / kTile : 0;  // full tiles
  const int chunks = (p.k + p.kc - 1) / p.kc;
  const int stage_bytes = p.kc * kTile;

  if (threadIdx.x >= kConsumers) {
    // Producer: one thread walks the block's ring tiles, chunk by chunk.
    if (threadIdx.x == kConsumers) {
      int s = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < n_ring; t += gridDim.x) {
        for (int c = 0; c < chunks; ++c) {
          const int j0 = c * p.kc;
          const int kt = min(p.kc, p.k - j0);
          mbar_wait(smem_addr(empty + s), phase ^ 1u);
          const uint32_t bar = smem_addr(full + s);
          mbar_expect_tx(bar, uint32_t(kt) * kTile);
          const uint32_t dst = smem_addr(ring + s * stage_bytes);
          const uint8_t* row = p.x + (long long)j0 * p.ldx + t * kTile;
          for (int j = 0; j < kt; ++j) {
            bulk_copy_g2s(dst + j * kTile, row + (long long)j * p.ldx, kTile,
                          bar);
          }
          if (++s == p.stages) { s = 0; phase ^= 1u; }
        }
      }
    }
    return;
  }

  // Consumers: 16 columns per thread.
  const int tid = threadIdx.x;
  int s = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long col = t * kTile + (long long)tid * kCols;
    const long long avail = p.n - col;   // columns this thread owns, if > 0
    uint32_t acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0u;

    if (t < n_ring) {
      for (int c = 0; c < chunks; ++c) {
        const int j0 = c * p.kc;
        const int kt = min(p.kc, p.k - j0);
        mbar_wait(smem_addr(full + s), phase);
        const uint8_t* st = ring + s * stage_bytes + tid * kCols;
        const uint32_t* tb = tab + j0 * 256;
#pragma unroll 2
        for (int j = 0; j < kt; ++j) {
          const uint4 v = *reinterpret_cast<const uint4*>(st + j * kTile);
          lookup_row(tb + j * 256, v, acc);
        }
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(smem_addr(empty + s));
        if (++s == p.stages) { s = 0; phase ^= 1u; }
      }
    } else if (avail > 0) {
      // Direct path: the ragged last tile, or a misaligned input.
      const uint8_t* xc = p.x + col;
      for (int j = 0; j < p.k; ++j) {
        lookup_row(tab + j * 256, load16(xc + (long long)j * p.ldx, avail,
                                         p.ring != 0), acc);
      }
    }

    if (avail > 0) {
      // Transpose the 16 packed words into 4 rows of 16 bytes:
      // r[o][q] = byte o of acc[4q .. 4q + 3].
      uint32_t r[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t t0 = __byte_perm(acc[4 * q], acc[4 * q + 1], 0x5140);
        const uint32_t t1 = __byte_perm(acc[4 * q + 2], acc[4 * q + 3], 0x5140);
        const uint32_t t2 = __byte_perm(acc[4 * q], acc[4 * q + 1], 0x7362);
        const uint32_t t3 = __byte_perm(acc[4 * q + 2], acc[4 * q + 3], 0x7362);
        r[0][q] = __byte_perm(t0, t1, 0x5410);
        r[1][q] = __byte_perm(t0, t1, 0x7632);
        r[2][q] = __byte_perm(t2, t3, 0x5410);
        r[3][q] = __byte_perm(t2, t3, 0x7632);
      }
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        if (o < mo) {
          store16(p.out + (long long)(4 * g + o) * p.ldo + col, avail,
                  p.vec_out != 0, p.accumulate != 0,
                  make_uint4(r[o][0], r[o][1], r[o][2], r[o][3]));
        }
      }
    }
  }
}

// Per-device caches, filled by whichever thread launches first on a
// device (one thread per card may launch at once); every thread writes
// the same value, so relaxed atomics suffice.
std::atomic<int> g_sm_count[64];
std::atomic<int> g_smem_set[64];

int sm_count(int device) {
  if (device < 0 || device >= 64) return 132;
  int cached = g_sm_count[device].load(std::memory_order_relaxed);
  if (cached == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess || sms <= 0) {
      return 132;
    }
    g_sm_count[device].store(sms, std::memory_order_relaxed);
    cached = sms;
  }
  return cached;
}

// Makes `device` current for one launch and gives the calling thread its
// own current device back on every return path: the caller's later
// allocations (torch's "cuda" without an index) must not move to the
// card of the last launch.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err != cudaSuccess || prev == device) {
      prev = -1;
    } else {
      err = cudaSetDevice(device);
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

extern "C" {

// tables: uint32 words, group g's (k, 256) table at tables + g * tab_ld,
// rows contiguous, 16-byte aligned. x: (k, n) uint8, row stride ldx.
// out: (m, n) uint8, row stride ldo. k <= kMaxK. ring != 0 promises that
// x and ldx (when k > 1) are multiples of 16 bytes; vec_out that out and
// ldo are. accumulate != 0 XORs the product into out. Launches on
// `stream` of `device`; does not synchronise.
int coded_matmul_launch(const void* tables, long long tab_ld, const void* x,
                        long long ldx, void* out, long long ldo, int m, int k,
                        long long n, int ring, int vec_out, int accumulate,
                        int device, void* stream) {
  if (m <= 0 || k <= 0 || k > kMaxK || n < 0) {
    return int(cudaErrorInvalidValue);
  }
  if (n == 0) return int(cudaSuccess);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  cudaError_t err = cudaSuccess;

  Params p;
  p.tables = static_cast<const uint32_t*>(tables);
  p.tab_ld = tab_ld;
  p.x = static_cast<const uint8_t*>(x);
  p.ldx = ldx;
  p.out = static_cast<uint8_t*>(out);
  p.ldo = ldo;
  p.n = n;
  p.m = m;
  p.k = k;
  p.ring = ring;
  p.vec_out = vec_out;
  p.accumulate = accumulate;
  const int chunks = (k + kMaxRowsPerStage - 1) / kMaxRowsPerStage;
  p.kc = (k + chunks - 1) / chunks;

  // One block per SM, with enough stages to keep ~kInFlight bytes of
  // input in flight (3 of 40 KB for RS(10,4)), as many as fit beside the
  // table (at least two for k <= kMaxK).
  const int fixed = kHeader + k * 1024;
  const int stage_bytes = p.kc * kTile;
  const int fit = (kSmemPerBlock - fixed) / stage_bytes;
  const int want = (kInFlight + stage_bytes - 1) / stage_bytes;
  p.stages = std::min(kMaxStages, std::min(fit, want));
  if (!ring) p.stages = 0;   // every tile takes the direct path
  const int smem = fixed + p.stages * stage_bytes;

  if (device >= 0 && device < 64 &&
      g_smem_set[device].load(std::memory_order_relaxed) < kSmemPerBlock) {
    err = cudaFuncSetAttribute(coded_matmul_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemPerBlock);
    if (err != cudaSuccess) return int(err);
    g_smem_set[device].store(kSmemPerBlock, std::memory_order_relaxed);
  }

  const int groups = (m + 3) / 4;
  const long long n_tiles = (n + kTile - 1) / kTile;
  long long cap = (sm_count(device) + groups - 1) / groups;
  if (cap < 1) cap = 1;
  dim3 grid((unsigned)(n_tiles < cap ? n_tiles : cap), (unsigned)groups);
  coded_matmul_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

const char* coded_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
