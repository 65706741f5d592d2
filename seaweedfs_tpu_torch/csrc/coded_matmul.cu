// GF(256) coded matmul for Hopper (sm_90a):
//
//     out[i, c] = XOR_j  coef[i, j] * x[j, c]        (GF(256) products)
//
// Replaces the Pallas TPU kernel seaweedfs_tpu/ops/codec_pallas.py:43
// (`_kernel`, launched by `_coded_matmul_pallas_pm_impl`), which computes
// the same bytes as a bf16 bit-plane matmul laid out for the MXU.
//
// Bound on this card: memory. Each output byte costs k table lookups and
// XORs, and the kernel moves (k + m) * n bytes, so at RS(10,4) it does
// ~3 integer operations per byte moved; HBM at 3.35 TB/s is the limit
// long before the ALUs are. The design therefore reads every input byte
// once, in 16-byte vector loads, and writes every output byte once:
//
//   * The wrapper hands over a (m, k, 256) uint8 product table,
//     tables[i][j][v] = coef[i, j] * v. A block stages the slice of it for
//     its kOutRows outputs in shared memory (kOutRows * kKTile * 256 bytes,
//     32 KB), so a product is one shared-memory byte load. Wider codes
//     walk k in tiles of kKTile rows, reloading the table slice per tile.
//   * Each thread owns 16 contiguous columns: one 16-byte load per input
//     row, up to kOutRows 16-byte accumulators in registers, one 16-byte
//     store per output row. grid.y walks groups of kOutRows outputs, so
//     m = 4 (encode) reads each input byte exactly once.
//   * Blocks stride over 4096-column tiles (grid-stride loop) so the table
//     is staged once per block, not once per tile.
//   * Rows may have any stride. When the base pointers and row strides are
//     16-byte aligned the loads and stores are vectors; otherwise (and on
//     the ragged last 16 columns) they go byte by byte. The kernel masks
//     the ragged edge itself, so no caller pads.
//
// What it leaves for later: table lookups hit random shared-memory banks
// (conflicts), and there is no TMA or wgmma bit-plane product yet.
//
// C interface (bound with ctypes): coded_matmul_launch returns the
// cudaError_t of the launch as an int, 0 on success.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // threads per block
constexpr int kCols = 16;                      // columns per thread
constexpr int kTileCols = kThreads * kCols;    // 4096 columns per tile
constexpr int kOutRows = 4;                    // outputs per block
constexpr int kKTile = 32;                     // input rows per table tile
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ void load16(const uint8_t* p, long long avail,
                                       bool vec, uint32_t w[4]) {
  if (vec && avail >= kCols) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0u;
  for (int c = 0; c < kCols; ++c) {
    if (c < avail) w[c >> 2] |= uint32_t(p[c]) << (8 * (c & 3));
  }
}

__device__ __forceinline__ void store16(uint8_t* p, long long avail,
                                        bool vec, const uint32_t w[4]) {
  if (vec && avail >= kCols) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  for (int c = 0; c < kCols; ++c) {
    if (c < avail) p[c] = uint8_t(w[c >> 2] >> (8 * (c & 3)));
  }
}

__global__ void __launch_bounds__(kThreads)
coded_matmul_kernel(const uint8_t* __restrict__ tables,
                    const uint8_t* __restrict__ x, long long ldx,
                    uint8_t* __restrict__ out, long long ldo,
                    int m, int k, long long n, int vec) {
  __shared__ __align__(16) uint8_t tab[kOutRows][kKTile][256];

  const int o0 = blockIdx.y * kOutRows;
  const int mo = min(kOutRows, m - o0);
  const bool resident = k <= kKTile;   // whole table slice fits: load once
  const long long n_tiles = (n + kTileCols - 1) / kTileCols;

  // Stage tables[o0 + o][j0 + j][:] for o < mo, j < kt, as 16-byte words.
  auto stage = [&](int j0, int kt) {
    const int words = mo * kt * (256 / 16);
    for (int idx = threadIdx.x; idx < words; idx += kThreads) {
      const int o = idx / (kt * 16);
      const int r = idx - o * kt * 16;
      const int j = r >> 4;
      const int q = r & 15;
      const uint4* src = reinterpret_cast<const uint4*>(
          tables + ((long long)(o0 + o) * k + j0 + j) * 256) + q;
      reinterpret_cast<uint4*>(&tab[o][j][0])[q] = __ldg(src);
    }
  };

  if (resident) {
    stage(0, k);
    __syncthreads();
  }

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long col = tile * kTileCols + (long long)threadIdx.x * kCols;
    const long long avail = n - col;   // columns this thread owns, if > 0
    uint32_t acc[kOutRows][4];
#pragma unroll
    for (int o = 0; o < kOutRows; ++o) {
      acc[o][0] = acc[o][1] = acc[o][2] = acc[o][3] = 0u;
    }

    for (int j0 = 0; j0 < k; j0 += kKTile) {
      const int kt = min(kKTile, k - j0);
      if (!resident) {
        __syncthreads();               // previous tile's lookups are done
        stage(j0, kt);
        __syncthreads();
      }
      if (avail > 0) {
        for (int j = 0; j < kt; ++j) {
          uint32_t w[4];
          load16(x + (long long)(j0 + j) * ldx + col, avail, vec, w);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const uint32_t v = (w[q] >> (8 * b)) & 0xffu;
#pragma unroll
              for (int o = 0; o < kOutRows; ++o) {
                if (o < mo) acc[o][q] ^= uint32_t(tab[o][j][v]) << (8 * b);
              }
            }
          }
        }
      }
    }

    if (avail > 0) {
#pragma unroll
      for (int o = 0; o < kOutRows; ++o) {
        if (o < mo) store16(out + (long long)(o0 + o) * ldo + col, avail,
                            vec, acc[o]);
      }
    }
  }
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess || sms <= 0) {
      return 132;
    }
    cached[device] = sms;
  }
  return cached[device];
}

}  // namespace

extern "C" {

// tables: (m, k, 256) uint8, contiguous. x: (k, n) uint8, row stride ldx.
// out: (m, n) uint8, row stride ldo. vec != 0 promises that x, out, ldx
// and ldo are all multiples of 16 bytes. Launches on `stream` of
// `device`; does not synchronise.
int coded_matmul_launch(const void* tables, const void* x, long long ldx,
                        void* out, long long ldo, int m, int k, long long n,
                        int vec, int device, void* stream) {
  if (m <= 0 || k <= 0 || n < 0) return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const long long n_tiles = (n + kTileCols - 1) / kTileCols;
  const long long cap = (long long)sm_count(device) * kBlocksPerSm;
  dim3 grid((unsigned)(n_tiles < cap ? n_tiles : cap),
            (unsigned)((m + kOutRows - 1) / kOutRows));
  coded_matmul_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tables), static_cast<const uint8_t*>(x),
      ldx, static_cast<uint8_t*>(out), ldo, m, k, n, vec);
  return int(cudaGetLastError());
}

const char* coded_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
