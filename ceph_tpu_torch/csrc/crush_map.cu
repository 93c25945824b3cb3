// Batched CRUSH placement for Hopper (sm_90a): one thread maps one input.
//
// Replaces the device programs of the JAX package's batched CRUSH engine:
//   * crush_map            <- ceph_tpu/ops/crush_kernel.py JaxEngine._build
//                             (fast_map/full_map, firstn and indep), the
//                             jitted descent that JaxEngine._run drives;
//   * crush_straw2_winners <- ceph_tpu/ops/crush_kernel.py _get_winners_fn,
//                             the jitted straw2 winner grid.
//
// Bound: integer instructions.  As compiled for sm_90a (count them with
// `python3 crush_probe.py sass-ops`), a drawn item issues ~282
// instructions: 136 for the rjenkins hash32_3 (three per mix step: IADD3,
// a shift, LOP3), 25 or 31 for crush_ln (a leading-zero count, a 64-bit
// multiply, three shared-memory table reads), 91 for the signed 64-bit
// division (a call to the emulated 64-bit routine: a negative 49-bit ln
// never takes the 32-bit shortcut) and ~27 for the loop, compare and
// select.  185 of them run on the integer ALU pipe and ~70 (IMAD) on the
// FMA pipe, so the ALU pipe, 64 lanes per SM, bounds a draw at 2.9 SM
// clocks.  A descent draws every item of every bucket it visits, so a
// 1024-OSD map with 128 hosts costs ~136 draws per replica; the bytes
// moved (8 B of input and 4 B per output column per lane) are negligible.
//
// Design: mapper.c's loops run as written, one input lane per thread, so no
// lane waits for another's retries (the TPU engine's fixed-trip rounds,
// FAST/FULL split and straggler recompaction exist for XLA and are not
// carried over):
//   * firstn: replica slots rep = 0..numrep-1; for each, ftotal up to
//     choose_tries with an early exit; the outer (root -> failure domain)
//     levels with the same r at every level; for chooseleaf, leaf_tries
//     retries below the domain (r' = r + f2, vary_r = 1, stable = 1); the
//     reweight rejection is_out (mapper.c:378-392); collisions against the
//     lane's own slots held so far.
//   * indep: crush_choose_indep's breadth-first order (every open slot per
//     ftotal round); numrep drives the r stride and out_size bounds the
//     slots; a uniform bucket whose size divides numrep adds +ftotal
//     (mapper.c:640-647); the leaf retry below a domain uses
//     r' = rep + r_last + numrep * f2 with the same per-level bump; holes
//     are CRUSH_ITEM_NONE.
//   * crush_ln (mapper.c:246-288) runs as mapper.c computes it, from the
//     129-entry RH/LH and 256-entry LL tables staged in shared memory
//     (4112 bytes per block); the 64 Ki-entry table (512 KiB) would not fit.
//   * the straw2 draw is ln / w as a signed 64-bit truncating division
//     (weight 0 draws S64_MIN); the argmax keeps the first maximum (strict >).
//   * uniform buckets run bucket_perm_choose's seeded Fisher-Yates over a
//     per-thread byte array of kMaxUniform entries (the wrapper refuses a
//     rule with a larger uniform bucket).
// The topology (per level: items, row map, sizes, bucket ids) is one int32
// array built once per engine; bucket and OSD weights are arguments of every
// call, so a reweight rebuilds nothing.  Firstn writes [osds..., count] per
// lane, padded with -1; indep writes out_size slots.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLevels = 12;            // outer + leaf levels of one segment
constexpr int kMaxRep = 32;               // result columns per lane
constexpr int kMaxUniform = 256;          // largest uniform bucket
constexpr int kLnEntries = 129 * 2 + 256; // RH/LH interleaved, then LL
constexpr int32_t kItemNone = 0x7fffffff;
constexpr int32_t kItemUndef = 0x7ffffffe;
constexpr uint32_t kHashSeed = 1315423911u;

struct Level {
  int items;     // offset of [n][imax] item ids in topo
  int rows;      // offset of the row map (-1 - bucket id -> row) in topo
  int sizes;     // offset of [n] bucket sizes in topo
  int ids;       // offset of [n] bucket ids in topo
  int weights;   // offset of [n][imax] item weights in the weights array
  int imax;      // row width
  int uniform;   // 1: bucket_perm_choose, 0: straw2
};

struct Params {
  Level lv[kMaxLevels];
  int n_outer, n_leaf;
  int firstn, recurse;
  int numrep, out_size;
  int choose_tries, leaf_tries;
  int n_osd;
  int ld_out;
};

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= b; a -= c; a ^= c >> 13;
  b -= c; b -= a; b ^= a << 8;
  c -= a; c -= b; c ^= b >> 13;
  a -= b; a -= c; a ^= c >> 12;
  b -= c; b -= a; b ^= a << 16;
  c -= a; c -= b; c ^= b >> 5;
  a -= b; a -= c; a ^= c >> 3;
  b -= c; b -= a; b ^= a << 10;
  c -= a; c -= b; c ^= b >> 15;
}

__device__ __forceinline__ uint32_t hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = kHashSeed ^ a ^ b, x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
}

__device__ __forceinline__ uint32_t hash32_3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = kHashSeed ^ a ^ b ^ c, x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

// mapper.c crush_ln: 2^44 * log2(xin + 1), xin < 2^16.  t holds RH[k] at 2k,
// LH[k] at 2k + 1 (k < 129), then LL[0..255] from 258.
__device__ __forceinline__ int64_t crush_ln(uint32_t xin, const uint64_t* t) {
  uint32_t x = xin + 1;
  int iexpon = 15;
  if (!(x & 0x18000u)) {
    const int bits = __clz(x & 0x1ffffu) - 16;
    x <<= bits;
    iexpon = 15 - bits;
  }
  const int k = static_cast<int>(x >> 8) - 128;
  const uint64_t rh = t[2 * k], lh = t[2 * k + 1];
  const uint64_t xl64 = (static_cast<uint64_t>(x) * rh) >> 48;
  uint64_t result = static_cast<uint64_t>(iexpon) << 44;
  result += (lh + t[258 + (xl64 & 0xff)]) >> 4;
  return static_cast<int64_t>(result);
}

// bucket_straw2_choose (mapper.c:300-344): index of the winning item.
__device__ __forceinline__ int straw2_index(const int32_t* items, const int64_t* w,
                                            int size, uint32_t x, uint32_t r,
                                            const uint64_t* lnt) {
  int high = 0;
  int64_t high_draw = 0;
  for (int i = 0; i < size; ++i) {
    const int64_t wi = __ldg(w + i);
    int64_t draw = LLONG_MIN;
    if (wi > 0) {
      const uint32_t u = hash32_3(x, static_cast<uint32_t>(__ldg(items + i)), r) & 0xffffu;
      draw = (crush_ln(u, lnt) - 0x1000000000000LL) / wi;
    }
    if (i == 0 || draw > high_draw) {
      high = i;
      high_draw = draw;
    }
  }
  return high;
}

// bucket_perm_choose (mapper.c:73-130), stateless: index of perm[r % size].
__device__ __forceinline__ int perm_index(int size, uint32_t bid, uint32_t x, int64_t r) {
  const int pr = static_cast<int>(r % size);
  if (pr == 0) return static_cast<int>(hash32_3(x, bid, 0) % static_cast<uint32_t>(size));
  uint8_t perm[kMaxUniform];
  for (int i = 0; i < size; ++i) perm[i] = static_cast<uint8_t>(i);
  for (int p = 0; p <= pr && p < size - 1; ++p) {
    const uint32_t i = hash32_3(x, bid, static_cast<uint32_t>(p)) %
                       static_cast<uint32_t>(size - p);
    if (i) {
      const uint8_t t = perm[p + i];
      perm[p + i] = perm[p];
      perm[p] = t;
    }
  }
  return perm[pr];
}

struct Ctx {
  const int32_t* topo;
  const int64_t* weights;
  const uint64_t* lnt;
  uint32_t x;
};

// One bucket's draw: the item chosen from row `row` of level L with r.
__device__ __forceinline__ int32_t level_choose(const Ctx& c, const Level& L, int row, int64_t r) {
  const int32_t* items = c.topo + L.items + static_cast<size_t>(row) * L.imax;
  const int size = __ldg(c.topo + L.sizes + row);
  int idx;
  if (L.uniform) {
    idx = perm_index(size, static_cast<uint32_t>(__ldg(c.topo + L.ids + row)), c.x, r);
  } else {
    idx = straw2_index(items, c.weights + L.weights + static_cast<size_t>(row) * L.imax,
                       size, c.x, static_cast<uint32_t>(r), c.lnt);
  }
  return __ldg(items + idx);
}

// Descend levels [l0, l1) from `row` of level l0.  bump >= 0 applies
// choose_indep's per-bucket stride: a uniform bucket whose size divides
// numrep draws with r + bump.  *r_last receives the r of the last draw.
__device__ __forceinline__ int32_t descend(const Ctx& c, const Params& P, int l0, int l1,
                                           int row, int64_t r, int64_t bump,
                                           int64_t* r_last) {
  int32_t cand = 0;
  int64_t r_lv = r;
  for (int l = l0; l < l1; ++l) {
    const Level& L = P.lv[l];
    if (l > l0) row = __ldg(c.topo + L.rows + (-1 - cand));
    r_lv = r;
    if (bump > 0 && L.uniform) {
      const int size = __ldg(c.topo + L.sizes + row);
      if (size % P.numrep == 0) r_lv = r + bump;
    }
    cand = level_choose(c, L, row, r_lv);
  }
  *r_last = r_lv;
  return cand;
}

// is_out (mapper.c:378-392)
__device__ __forceinline__ bool is_out(const int64_t* osd_w, int n_osd, int32_t item, uint32_t x) {
  if (item < 0 || item >= n_osd) return true;
  const int64_t w = __ldg(osd_w + item);
  if (w >= 0x10000) return false;
  if (w == 0) return true;
  return static_cast<int64_t>(hash32_2(x, static_cast<uint32_t>(item)) & 0xffffu) >= w;
}

template <bool kFirstn>
__global__ void __launch_bounds__(kThreads)
crush_map_kernel(Params P, const int32_t* __restrict__ topo,
                 const int64_t* __restrict__ weights,
                 const int64_t* __restrict__ osd_w,
                 const int64_t* __restrict__ ln_tables,
                 const int64_t* __restrict__ xs, long long X,
                 int32_t* __restrict__ out) {
  __shared__ uint64_t lnt[kLnEntries];
  for (int i = threadIdx.x; i < kLnEntries; i += blockDim.x)
    lnt[i] = static_cast<uint64_t>(ln_tables[i]);
  __syncthreads();
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= X) return;

  Ctx c{topo, weights, lnt, static_cast<uint32_t>(xs[lane])};
  const int leaf0 = P.n_outer, leaf1 = P.n_outer + P.n_leaf;
  int32_t hosts[kMaxRep], osds[kMaxRep];
  int32_t* row_out = out + lane * P.ld_out;

  if (kFirstn) {
    int outpos = 0;
    for (int rep = 0; rep < P.numrep; ++rep) {
      for (int ftotal = 0; ftotal < P.choose_tries; ++ftotal) {
        const int64_t r = rep + ftotal;
        int64_t r_last;
        const int32_t host = descend(c, P, 0, P.n_outer, 0, r, 0, &r_last);
        bool collide = false;
        for (int i = 0; i < outpos; ++i) collide |= hosts[i] == host;
        if (collide) continue;
        int32_t osd = host;
        bool ok = false;
        if (P.recurse) {
          const int row = __ldg(topo + P.lv[leaf0].rows + (-1 - host));
          for (int f2 = 0; f2 < P.leaf_tries && !ok; ++f2) {
            const int32_t cand = descend(c, P, leaf0, leaf1, row, r + f2, 0, &r_last);
            bool reject = is_out(osd_w, P.n_osd, cand, c.x);
            for (int i = 0; i < outpos; ++i) reject |= osds[i] == cand;
            if (!reject) {
              osd = cand;
              ok = true;
            }
          }
        } else {
          ok = !is_out(osd_w, P.n_osd, host, c.x);
        }
        if (ok) {
          hosts[outpos] = host;
          osds[outpos] = osd;
          ++outpos;
          break;
        }
      }
    }
    for (int i = 0; i < P.numrep; ++i) row_out[i] = i < outpos ? osds[i] : -1;
    row_out[P.numrep] = outpos;
  } else {
    for (int i = 0; i < P.out_size; ++i) hosts[i] = osds[i] = kItemUndef;
    int left = P.out_size;
    for (int ftotal = 0; ftotal < P.choose_tries && left > 0; ++ftotal) {
      for (int rep = 0; rep < P.out_size; ++rep) {
        if (hosts[rep] != kItemUndef) continue;
        int64_t r_last;
        const int32_t host = descend(c, P, 0, P.n_outer, 0,
                                     rep + static_cast<int64_t>(P.numrep) * ftotal,
                                     ftotal, &r_last);
        bool collide = false;
        for (int i = 0; i < P.out_size; ++i) collide |= hosts[i] == host;
        if (collide) continue;
        int32_t osd = host;
        bool ok = false;
        if (P.recurse) {
          const int row = __ldg(topo + P.lv[leaf0].rows + (-1 - host));
          const int64_t base = rep + r_last;
          for (int f2 = 0; f2 < P.leaf_tries && !ok; ++f2) {
            int64_t unused;
            const int32_t cand = descend(c, P, leaf0, leaf1, row,
                                         base + static_cast<int64_t>(P.numrep) * f2,
                                         f2, &unused);
            if (!is_out(osd_w, P.n_osd, cand, c.x)) {
              osd = cand;
              ok = true;
            }
          }
        } else {
          ok = !is_out(osd_w, P.n_osd, host, c.x);
        }
        if (ok) {
          hosts[rep] = host;
          osds[rep] = osd;
          --left;
        }
      }
    }
    for (int i = 0; i < P.out_size; ++i) row_out[i] = osds[i] == kItemUndef ? kItemNone : osds[i];
  }
}

// out[x, r] = the straw2 winner of one bucket for input xs[x] and draw rs[r].
__global__ void __launch_bounds__(kThreads)
crush_straw2_winners_kernel(const int32_t* __restrict__ items,
                            const int64_t* __restrict__ w, int B,
                            const int64_t* __restrict__ ln_tables,
                            const int64_t* __restrict__ xs, long long X,
                            const int64_t* __restrict__ rs, int R,
                            int64_t* __restrict__ out) {
  __shared__ uint64_t lnt[kLnEntries];
  for (int i = threadIdx.x; i < kLnEntries; i += blockDim.x)
    lnt[i] = static_cast<uint64_t>(ln_tables[i]);
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= X * R) return;
  const long long xi = i / R;
  const int ri = static_cast<int>(i - xi * R);
  const int idx = straw2_index(items, w, B, static_cast<uint32_t>(xs[xi]),
                               static_cast<uint32_t>(rs[ri]), lnt);
  out[i] = __ldg(items + idx);
}

}  // namespace

// Launches the descent for one rule segment on `stream`; returns
// cudaGetLastError() (0 on success).  levels: host array of 7 ints per
// level (the fields of Level, in order), n_outer + n_leaf levels.  topo,
// weights, osd_w, ln_tables (kLnEntries int64), xs and out are device
// pointers; out is [X][ld_out] int32.
extern "C" int crush_map(const int* levels, int n_outer, int n_leaf, int firstn,
                         int recurse, int numrep, int out_size, int choose_tries,
                         int leaf_tries, const void* topo, const void* weights,
                         const void* osd_w, int n_osd, const void* ln_tables,
                         const void* xs, long long X, void* out, int ld_out,
                         void* stream) {
  if (n_outer < 1 || n_leaf < 0 || n_outer + n_leaf > kMaxLevels ||
      numrep < 1 || out_size < 1 || out_size > kMaxRep ||
      (firstn && numrep != out_size) || ld_out < out_size + (firstn ? 1 : 0) ||
      (recurse && n_leaf < 1) || X < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (X == 0) return 0;
  Params P{};
  for (int l = 0; l < n_outer + n_leaf; ++l) {
    const int* f = levels + 7 * l;
    P.lv[l] = Level{f[0], f[1], f[2], f[3], f[4], f[5], f[6]};
  }
  P.n_outer = n_outer;
  P.n_leaf = n_leaf;
  P.firstn = firstn;
  P.recurse = recurse;
  P.numrep = numrep;
  P.out_size = out_size;
  P.choose_tries = choose_tries;
  P.leaf_tries = leaf_tries;
  P.n_osd = n_osd;
  P.ld_out = ld_out;
  const dim3 grid(static_cast<unsigned>((X + kThreads - 1) / kThreads));
  auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int32_t*>(topo);
  const auto* w = static_cast<const int64_t*>(weights);
  const auto* ow = static_cast<const int64_t*>(osd_w);
  const auto* ln = static_cast<const int64_t*>(ln_tables);
  const auto* x = static_cast<const int64_t*>(xs);
  auto* o = static_cast<int32_t*>(out);
  if (firstn) {
    crush_map_kernel<true><<<grid, kThreads, 0, s>>>(P, t, w, ow, ln, x, X, o);
  } else {
    crush_map_kernel<false><<<grid, kThreads, 0, s>>>(P, t, w, ow, ln, x, X, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// The [X][R] straw2 winner grid of one bucket (items/w: B entries).
extern "C" int crush_straw2_winners(const void* items, const void* w, int B,
                                    const void* ln_tables, const void* xs, long long X,
                                    const void* rs, int R, void* out, void* stream) {
  if (B < 1 || R < 0 || X < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (X == 0 || R == 0) return 0;
  const long long n = X * R;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  crush_straw2_winners_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(items), static_cast<const int64_t*>(w), B,
      static_cast<const int64_t*>(ln_tables), static_cast<const int64_t*>(xs), X,
      static_cast<const int64_t*>(rs), R, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int crush_max_levels() { return kMaxLevels; }
extern "C" int crush_max_rep() { return kMaxRep; }
extern "C" int crush_max_uniform() { return kMaxUniform; }

extern "C" const char* crush_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
