// GF(2^8) matrix apply for Hopper (sm_90a): out[r, L] = M (r x k) * data[k, L].
//
// Replaces two TPU kernels of ceph_tpu/ec/kernel.py:
//   * gf_apply          <- _ec_fused_kernel, which _apply_bitmatrix_pallas_jit
//                          launches (unpack to bit-planes, int8 matmul against
//                          the 8r x 8k bit-matrix, mod 2, repack);
//   * gf_apply_checksum <- _pallas_probe_sum, the variant tuner's probe: the
//                          same apply with the output summed on the device as
//                          a wrapped int32, so one scalar crosses to the host.
// Both compute the same bytes as the TPU kernels by another method.
//
// Bound: bytes.  gf_apply reads k*L bytes and writes r*L bytes, (k + r)*L in
// all, and does a few table lookups per byte.  For the k=8, m=4 encode window
// of 4 Mi lanes that is 48 MiB, 15 us at 3.35 TB/s.  gf_apply_checksum reads
// k*L bytes and writes one 4-byte sum.
//
// Design: ISA-L's split-nibble method (ec_init_tables).  For each coefficient
// c the wrapper builds 32 bytes, lo[x] = c*x and hi[x] = c*(x << 4) for
// x < 16, so that c*b = lo[b & 15] ^ hi[b >> 4].  A block copies the tables
// of its output rows into shared memory.  Each thread owns kLanes contiguous
// lanes: one or two 16-byte loads per input row, XOR-accumulated into up to
// kMaxRows output rows held in registers, then 16-byte stores per output
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
//
// Variants: (threads per block, lanes per thread, output rows per block) are
// template parameters.  GF_TUNE_SPACE below lists the instantiations the
// variant tuner (ec/kernel.py autotune) chooses among; one nvcc run builds
// them all, and a launch names its variant.  The checksum epilogue replaces
// the stores: each thread sums its output bytes (__vsadu4), a warp reduces
// with __shfl_xor_sync, the block through shared memory, and one uint32
// atomicAdd per block adds into the device sum.  Addition mod 2^32 is
// order-free, so the wrapped sum is exact and the same on every run.

#include <cstdint>
#include <cuda_runtime.h>

// (threads, lanes, rows): the first entry is the champion default.
#define GF_TUNE_SPACE(X) \
  X(256, 16, 8)          \
  X(128, 16, 8)          \
  X(256, 32, 8)          \
  X(256, 16, 4)

namespace {

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

template <int kThreads, int kLanes, int kMaxRows, bool kVec, bool kSum>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const uint8_t* __restrict__ tables, int r, int k,
                int rows_per_tile, const uint8_t* __restrict__ data,
                long long ld_data, uint8_t* __restrict__ out,
                long long ld_out, long long L, uint32_t* __restrict__ sum) {
  static_assert(kLanes % 16 == 0, "lanes per thread: a multiple of 16");
  constexpr int kWords = kLanes / 4;
  extern __shared__ uint8_t smem[];        // [rt][k][32] tables of this tile
  const int r0 = blockIdx.y * rows_per_tile;
  const int rt = min(rows_per_tile, r - r0);
  const int nbytes = rt * k * kTableBytes;
  const uint8_t* src = tables + static_cast<size_t>(r0) * k * kTableBytes;
  for (int i = threadIdx.x; i < nbytes; i += blockDim.x) smem[i] = src[i];
  __syncthreads();

  const long long lane0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kLanes;
  const bool active = lane0 < L;
  const bool full = lane0 + kLanes <= L;

  uint32_t acc[kMaxRows][kWords];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) acc[i][w] = 0;
  }

  if (active) {
    for (int j = 0; j < k; ++j) {
      const uint8_t* p = data + j * ld_data + lane0;
      uint32_t x[kWords];
      if (kVec && full) {
#pragma unroll
        for (int v = 0; v < kWords / 4; ++v) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + v);
          x[4 * v] = q.x; x[4 * v + 1] = q.y; x[4 * v + 2] = q.z; x[4 * v + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int w = 0; w < kWords; ++w) x[w] = 0;
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
          for (int w = 0; w < kWords; ++w) acc[i][w] ^= gf_mul4(t, x[w]);
        }
      }
    }
  }

  if (!kSum) {
    if (!active) return;
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      if (i < rt) {
        uint8_t* q = out + (r0 + i) * ld_out + lane0;
        if (kVec && full) {
#pragma unroll
          for (int v = 0; v < kWords / 4; ++v) {
            reinterpret_cast<uint4*>(q)[v] = make_uint4(
                acc[i][4 * v], acc[i][4 * v + 1], acc[i][4 * v + 2], acc[i][4 * v + 3]);
          }
        } else {
          for (int b = 0; b < kLanes; ++b) {
            if (lane0 + b < L) q[b] = static_cast<uint8_t>(acc[i][b >> 2] >> (8 * (b & 3)));
          }
        }
      }
    }
  } else {
    // Lanes past L loaded zeros and c * 0 = 0, so their bytes add nothing.
    __shared__ uint32_t warp_sums[kThreads / 32];
    uint32_t s = 0;
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) s += __vsadu4(acc[i][w], 0u);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t total = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
      atomicAdd(sum, total);
    }
  }
}

template <int kThreads, int kLanes, int kMaxRows, bool kSum>
int launch(const void* tables, int r, int k, const void* data, long long ld_data,
           void* out, long long ld_out, long long L, uint32_t* sum, cudaStream_t s) {
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
  if (vec) {
    gf_apply_kernel<kThreads, kLanes, kMaxRows, true, kSum>
        <<<grid, kThreads, smem, s>>>(t, r, k, rows, d, ld_data, o, ld_out, L, sum);
  } else {
    gf_apply_kernel<kThreads, kLanes, kMaxRows, false, kSum>
        <<<grid, kThreads, smem, s>>>(t, r, k, rows, d, ld_data, o, ld_out, L, sum);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kSum>
int dispatch(int threads, int lanes, int rows, const void* tables, int r, int k,
             const void* data, long long ld_data, void* out, long long ld_out,
             long long L, uint32_t* sum, cudaStream_t s) {
#define GF_DISPATCH(T, LA, R)                                                  \
  if (threads == T && lanes == LA && rows == R)                                \
    return launch<T, LA, R, kSum>(tables, r, k, data, ld_data, out, ld_out, L, \
                                  sum, s);
  GF_TUNE_SPACE(GF_DISPATCH)
#undef GF_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);   // not a built variant
}

}  // namespace

// Launches variant (threads, lanes, rows) on `stream` and returns
// cudaGetLastError() (0 on success).  tables: [r][k][32] device bytes;
// data: k rows of L bytes, row stride ld_data; out: r rows of L bytes, row
// stride ld_out.
extern "C" int gf_apply(const void* tables, int r, int k, const void* data,
                        long long ld_data, void* out, long long ld_out,
                        long long L, int threads, int lanes, int rows,
                        void* stream) {
  if (r < 1 || k < 1 || r + k > 255 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  return dispatch<false>(threads, lanes, rows, tables, r, k, data, ld_data, out,
                         ld_out, L, nullptr, static_cast<cudaStream_t>(stream));
}

// The same apply with the checksum epilogue: *sum (one device int32) is set
// to the sum of the r*L output bytes, wrapped mod 2^32.  Nothing else is
// written.
extern "C" int gf_apply_checksum(const void* tables, int r, int k, const void* data,
                                 long long ld_data, long long L, int threads,
                                 int lanes, int rows, void* sum, void* stream) {
  if (r < 1 || k < 1 || r + k > 255 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t z = cudaMemsetAsync(sum, 0, sizeof(uint32_t), s);
  if (z != cudaSuccess) return static_cast<int>(z);
  if (L == 0) return 0;
  return dispatch<true>(threads, lanes, rows, tables, r, k, data, ld_data, nullptr,
                        0, L, static_cast<uint32_t*>(sum), s);
}

// Writes the built variants as (threads, lanes, rows) triples into out (room
// for `cap` triples) and returns how many there are.
extern "C" int gf_tune_space(int* out, int cap) {
  int n = 0;
#define GF_LIST(T, LA, R)          \
  if (n < cap) {                   \
    out[3 * n] = T;                \
    out[3 * n + 1] = LA;           \
    out[3 * n + 2] = R;            \
  }                                \
  ++n;
  GF_TUNE_SPACE(GF_LIST)
#undef GF_LIST
  return n;
}

extern "C" const char* gf_apply_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
