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
// k*L bytes and writes one 4-byte sum.  Issuing the lookups must stay under
// that: the inner step below is 5 instructions per coefficient and 4-byte
// word, on the ALU pipe (64 lanes per clock and SM).
//
// Design: table lookups by byte permute, in registers (prmt, the GPU's
// counterpart of ISA-L's pshufb).  Multiplication by a coefficient c is
// linear over GF(2), so with a byte b cut into fields of 3, 3 and 2 bits,
// c*b = T0[b & 7] ^ T1[(b >> 3) & 7] ^ T2[b >> 6], where T0[i] = c*i and
// T1[i] = c*(i << 3) for i < 8, T2[i] = c*(i << 6) for i < 4.  T0 and T1 are
// 8 bytes, two 32-bit registers each, and T2 is one: one prmt looks the
// field of all four bytes of a word up at once.  The wrapper lays each
// coefficient's 20 bytes out in 32 (ec/kernel.py prmt_tables); a block
// copies the tables of its output rows into shared memory, and a thread
// loads one coefficient's five words with two loads that the whole warp
// makes at one address (a broadcast), once per (input row, output row) for
// all of its words.
//
// Selectors: prmt takes a 4-bit selector per result byte from the low 16
// bits of its third operand, and in its default mode reads bit 3 of each as
// "replicate the sign bit".  For a field at shift s with mask m (0x07070707,
// or 0x03030303 for T2), y = (x >> s) & m holds byte n's field in bits
// 8n..8n+2, and y + (y >> 12) (the two share no bit) moves the fields of
// bytes 0, 2, 1, 3 into nibbles 0..3 with bit 3 clear.  So the products come
// out in byte order 0, 2, 1, 3.  An input word's selectors serve all of the
// tile's output rows; each output word is put back in order once, by
// prmt(acc, 0, 0x3120), before it is stored.  A byte sum does not depend on
// the order, so the checksum epilogue needs no restore.
//
// Each thread owns kLanes contiguous lanes: one or two 16-byte loads per
// input row, XOR-accumulated into up to kMaxRows output rows held in
// registers, then 16-byte stores per output row.  So every input byte is
// read from device memory once per row tile and every output byte written
// once.  Rows j go outer, then output rows, then words; the loads of the
// next kStages - 1 rows are in flight, by cp.async into a per-thread ring in
// shared memory, while a row's lookups issue.  More output rows than one
// tile holds (kMaxRows, or what the 48 KB of shared memory left beside the
// ring holds for large k) are split over gridDim.y; each row tile reads the
// input again.
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
  X(128, 16, 4)        \
  X(256, 16, 4)        \
  X(64, 16, 4)         \
  X(512, 16, 4)        \
  X(128, 16, 8)        \
  X(256, 16, 8)

namespace {

constexpr int kTableBytes = 32;            // T0[8] T1[8] T2[4], 12 bytes of padding
constexpr int kSmemLimit = 48 * 1024;      // shared memory without opt-in
constexpr int kStages = 4;                 // input rows in a thread's load ring

// prmt.b32 in its default mode.  __byte_perm reads only 3 bits of each
// selector nibble, so the compiler masks every selector (one more LOP3 per
// lookup); the selectors here keep bit 3 clear and need no mask.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The selectors of x's three fields, bytes in the order 0, 2, 1, 3.
__device__ __forceinline__ void selectors(uint32_t x, uint32_t& s0, uint32_t& s1,
                                          uint32_t& s2) {
  const uint32_t y0 = x & 0x07070707u;
  const uint32_t y1 = (x >> 3) & 0x07070707u;
  const uint32_t y2 = (x >> 6) & 0x03030303u;
  s0 = y0 + (y0 >> 12);
  s1 = y1 + (y1 >> 12);
  s2 = y2 + (y2 >> 12);
}

// Four bytes times one coefficient: T0 in t.x:t.y, T1 in t.z:t.w, T2 in t2.
__device__ __forceinline__ uint32_t gf_mul4(const uint4& t, uint32_t t2, uint32_t s0,
                                            uint32_t s1, uint32_t s2) {
  return prmt(t.x, t.y, s0) ^ prmt(t.z, t.w, s1) ^ prmt(t2, 0u, s2);
}

// 16 bytes from device to shared memory, asynchronously, cached in L2 only
// (a row is read once); commit closes a group, wait<N> waits until at most N
// of this thread's groups are in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// XOR-accumulates one input row's products into acc (byte order 0, 2, 1,
// 3): the row's selectors once, then each of the tile's output rows.
template <int kLanes, int kMaxRows>
__device__ __forceinline__ void row_products(uint32_t (&acc)[kMaxRows][kLanes / 4],
                                             const uint32_t (&x)[kLanes / 4],
                                             const uint8_t* tj, int rt, int k) {
  constexpr int kWords = kLanes / 4;
  uint32_t s0[kWords], s1[kWords], s2[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) selectors(x[w], s0[w], s1[w], s2[w]);
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (i < rt) {
      const uint8_t* t = tj + i * k * kTableBytes;
      const uint4 t01 = *reinterpret_cast<const uint4*>(t);
      const uint32_t t2 = *reinterpret_cast<const uint32_t*>(t + 16);
#pragma unroll
      for (int w = 0; w < kWords; ++w) acc[i][w] ^= gf_mul4(t01, t2, s0[w], s1[w], s2[w]);
    }
  }
}

// The k input rows of a thread whose lanes are all below L and whose rows
// are 16-byte aligned.  A ring of kStages rows per thread in shared memory
// keeps kStages - 1 rows of 16-byte cp.async loads in flight while a row's
// lookups issue: with about a thousand threads per SM, one row each would be
// 16 KB in flight, under what HBM's latency asks for.  A thread reads only
// the ring slots it filled, so no barrier is needed.
template <int kThreads, int kLanes, int kMaxRows>
__device__ __forceinline__ void accumulate_ring(uint32_t (&acc)[kMaxRows][kLanes / 4],
                                                const uint8_t* tables, int rt, int k,
                                                const uint8_t* __restrict__ data,
                                                long long ld_data, long long lane0) {
  constexpr int kVecs = kLanes / 16;
  __shared__ uint4 ring[kStages][kVecs][kThreads];
  const uint8_t* p = data + lane0;
  const int t = threadIdx.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k) {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) cp_async16(&ring[s][v][t], p + s * ld_data + 16 * v);
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < k; ++j) {
    const int ahead = j + kStages - 1;
    if (ahead < k) {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        cp_async16(&ring[ahead % kStages][v][t], p + ahead * ld_data + 16 * v);
      }
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();          // row j has landed
    uint32_t x[kLanes / 4];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const uint4 q = ring[j % kStages][v][t];
      x[4 * v] = q.x; x[4 * v + 1] = q.y; x[4 * v + 2] = q.z; x[4 * v + 3] = q.w;
    }
    row_products<kLanes, kMaxRows>(acc, x, tables + j * kTableBytes, rt, k);
  }
}

// The k input rows by byte loads masked at L: the ragged tail, and rows that
// are not 16-byte aligned.
template <int kLanes, int kMaxRows>
__device__ __forceinline__ void accumulate_bytes(uint32_t (&acc)[kMaxRows][kLanes / 4],
                                                 const uint8_t* tables, int rt, int k,
                                                 const uint8_t* __restrict__ data,
                                                 long long ld_data, long long lane0,
                                                 long long L) {
  constexpr int kWords = kLanes / 4;
#pragma unroll 1
  for (int j = 0; j < k; ++j) {
    const uint8_t* p = data + j * ld_data + lane0;
    uint32_t x[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) x[w] = 0;
#pragma unroll
    for (int q = 0; q < kLanes; ++q) {
      if (lane0 + q < L) x[q >> 2] |= static_cast<uint32_t>(p[q]) << (8 * (q & 3));
    }
    row_products<kLanes, kMaxRows>(acc, x, tables + j * kTableBytes, rt, k);
  }
}

template <int kThreads, int kLanes, int kMaxRows, bool kVec, bool kSum>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const uint8_t* __restrict__ tables, int r, int k,
                int rows_per_tile, const uint8_t* __restrict__ data,
                long long ld_data, uint8_t* __restrict__ out,
                long long ld_out, long long L, uint32_t* __restrict__ sum) {
  static_assert(kLanes % 16 == 0, "lanes per thread: a multiple of 16");
  constexpr int kWords = kLanes / 4;
  extern __shared__ uint4 smem[];          // [rt][k][32 bytes] tables of this tile
  const int r0 = blockIdx.y * rows_per_tile;
  const int rt = min(rows_per_tile, r - r0);
  const int nvec = rt * k * (kTableBytes / 16);
  const uint4* src = reinterpret_cast<const uint4*>(tables) +
                     static_cast<size_t>(r0) * k * (kTableBytes / 16);
  for (int i = threadIdx.x; i < nvec; i += kThreads) smem[i] = src[i];
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

  const uint8_t* tab = reinterpret_cast<const uint8_t*>(smem);
  if (active) {
    if (kVec && full) {
      accumulate_ring<kThreads, kLanes, kMaxRows>(acc, tab, rt, k, data, ld_data, lane0);
    } else {
      accumulate_bytes<kLanes, kMaxRows>(acc, tab, rt, k, data, ld_data, lane0, L);
    }
  }

  if (!kSum) {
    if (!active) return;
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      if (i < rt) {
        uint8_t* q = out + (r0 + i) * ld_out + lane0;
        uint32_t o[kWords];
#pragma unroll
        for (int w = 0; w < kWords; ++w) o[w] = prmt(acc[i][w], 0u, 0x3120);
        if (kVec && full) {
#pragma unroll
          for (int v = 0; v < kWords / 4; ++v) {
            reinterpret_cast<uint4*>(q)[v] =
                make_uint4(o[4 * v], o[4 * v + 1], o[4 * v + 2], o[4 * v + 3]);
          }
        } else {
          for (int b = 0; b < kLanes; ++b) {
            if (lane0 + b < L) q[b] = static_cast<uint8_t>(o[b >> 2] >> (8 * (b & 3)));
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
  // the tables share the 48 KB with the static shared memory: the load ring
  // and the checksum's warp sums
  constexpr int kStatic = kStages * kThreads * kLanes + (kSum ? kThreads / 32 * 4 : 0);
  int rows = (kSmemLimit - kStatic) / (k * kTableBytes);
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
// cudaGetLastError() (0 on success).  tables: [r][k][32] device bytes
// (ec/kernel.py prmt_tables; 16-byte aligned); data: k rows of L bytes, row
// stride ld_data; out: r rows of L bytes, row stride ld_out.
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
