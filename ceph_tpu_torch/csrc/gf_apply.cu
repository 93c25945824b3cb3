// GF(2^8) matrix apply for Hopper (sm_90a): out[r, L] = M (r x k) * data[k, L].
//
// Replaces ceph_tpu/ec/kernel.py:_ec_fused_kernel, the TPU kernel that
// _apply_bitmatrix_pallas_jit launches (unpack to bit-planes, int8 matmul
// against the 8r x 8k bit-matrix, mod 2, repack).  This kernel computes the
// same bytes by another method.
//
// Bound: bytes.  A call reads k*L bytes and writes r*L bytes, (k + r)*L in
// all, and does a few table lookups per byte.  For the k=8, m=4 encode window
// of 4 Mi lanes that is 48 MiB, 15 us at 3.35 TB/s.
//
// Design: ISA-L's split-nibble method (ec_init_tables).  For each coefficient
// c the wrapper builds 32 bytes, lo[x] = c*x and hi[x] = c*(x << 4) for
// x < 16, so that c*b = lo[b & 15] ^ hi[b >> 4].  A block copies the tables
// of its output rows into shared memory.  Each thread owns 16 contiguous
// lanes: one 16-byte load per input row, XOR-accumulated into up to
// kMaxRows output rows held in registers, then one 16-byte store per output
// row.  So every input byte is read from device memory once per row tile and
// every output byte written once.  The threads of a warp look up the same
// coefficient's 16-byte half-table at the same time: four 32-bit words in
// four banks, so the lookups have no bank conflicts.  More output rows than
// one tile holds (kMaxRows, or what 48 KB of shared memory holds for large
// k) are split over gridDim.y; each row tile reads the input again.
// The ragged tail of L is masked per byte.  Rows whose pointer or stride is
// not 16-byte aligned take the same kernel with byte loads and stores.
// Input rows may be strided (ld_data), so a window of a wider buffer needs
// no copy; lanes within a row are contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // threads per block
constexpr int kLanes = 16;                 // lanes (bytes) per thread
constexpr int kMaxRows = 8;                // output rows per block, in registers
constexpr int kTableBytes = 32;            // lo[16] then hi[16] per coefficient
constexpr int kSmemLimit = 48 * 1024;      // dynamic shared memory without opt-in

// Four bytes of x, each multiplied by the coefficient whose tables t holds.
__device__ __forceinline__ uint32_t gf_mul4(const uint8_t* t, uint32_t x) {
  uint32_t y = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t v = (x >> (8 * b)) & 0xffu;
    y |= static_cast<uint32_t>(t[v & 15u] ^ t[16u + (v >> 4)]) << (8 * b);
  }
  return y;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const uint8_t* __restrict__ tables, int r, int k,
                int rows_per_tile, const uint8_t* __restrict__ data,
                long long ld_data, uint8_t* __restrict__ out,
                long long ld_out, long long L) {
  extern __shared__ uint8_t smem[];        // [rt][k][32] tables of this tile
  const int r0 = blockIdx.y * rows_per_tile;
  const int rt = min(rows_per_tile, r - r0);
  const int nbytes = rt * k * kTableBytes;
  const uint8_t* src = tables + static_cast<size_t>(r0) * k * kTableBytes;
  for (int i = threadIdx.x; i < nbytes; i += blockDim.x) smem[i] = src[i];
  __syncthreads();

  const long long lane0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kLanes;
  if (lane0 >= L) return;
  const bool full = lane0 + kLanes <= L;

  uint32_t acc[kMaxRows][4];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[i][w] = 0;
  }

  for (int j = 0; j < k; ++j) {
    const uint8_t* p = data + j * ld_data + lane0;
    uint32_t x[4];
    if (kVec && full) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) x[w] = 0;
      for (int q = 0; q < kLanes; ++q) {
        if (lane0 + q < L) x[q >> 2] |= static_cast<uint32_t>(p[q]) << (8 * (q & 3));
      }
    }
    const uint8_t* tj = smem + j * kTableBytes;
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      if (i < rt) {
        const uint8_t* t = tj + i * k * kTableBytes;
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[i][w] ^= gf_mul4(t, x[w]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (i < rt) {
      uint8_t* q = out + (r0 + i) * ld_out + lane0;
      if (kVec && full) {
        *reinterpret_cast<uint4*>(q) =
            make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
        for (int b = 0; b < kLanes; ++b) {
          if (lane0 + b < L) q[b] = static_cast<uint8_t>(acc[i][b >> 2] >> (8 * (b & 3)));
        }
      }
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  tables: [r][k][32] device bytes; data: k rows of L bytes, row
// stride ld_data; out: r rows of L bytes, row stride ld_out.
extern "C" int gf_apply(const void* tables, int r, int k, const void* data,
                        long long ld_data, void* out, long long ld_out,
                        long long L, void* stream) {
  if (r < 1 || k < 1 || r + k > 255 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  int rows = kSmemLimit / (k * kTableBytes);
  if (rows > kMaxRows) rows = kMaxRows;
  if (rows > r) rows = r;
  const long long threads_needed = (L + kLanes - 1) / kLanes;
  const dim3 grid(static_cast<unsigned>((threads_needed + kThreads - 1) / kThreads),
                  static_cast<unsigned>((r + rows - 1) / rows));
  const size_t smem = static_cast<size_t>(rows) * k * kTableBytes;
  const bool vec = reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   ld_data % 16 == 0 && ld_out % 16 == 0;
  const auto* t = static_cast<const uint8_t*>(tables);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    gf_apply_kernel<true><<<grid, kThreads, smem, s>>>(t, r, k, rows, d, ld_data, o, ld_out, L);
  } else {
    gf_apply_kernel<false><<<grid, kThreads, smem, s>>>(t, r, k, rows, d, ld_data, o, ld_out, L);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gf_apply_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
