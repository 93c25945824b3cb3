// Batched CRUSH placement for Hopper (sm_90a): a tile of G lanes maps one
// input.
//
// Replaces the device programs of the JAX package's batched CRUSH engine:
//   * crush_map            <- ceph_tpu/ops/crush_kernel.py JaxEngine._build
//                             (fast_map/full_map, firstn and indep), the
//                             jitted descent that JaxEngine._run drives;
//   * crush_straw2_winners <- ceph_tpu/ops/crush_kernel.py _get_winners_fn,
//                             the jitted straw2 winner grid.
//
// Bound: integer operations, counted from the algorithm (chip_smoke.py,
// crush_ops_ms).  Any bit-exact descent computes rjenkins hash32_3 for
// every straw2 draw and every perm-choose step: 5 mixes of 9 statements,
// each a three-input subtract, a shift and an xor, plus the seed xor, 136
// integer operations; an is_out hash32_2 is 3 mixes, 82.  Only the 46
// xors (28 in hash32_2) need the ALU pipe (LOP3, 64 lanes per SM clock);
// a subtract or a shift can also issue on the FMA pipe (IMAD, IMAD.SHL,
// IMAD.HI) beside it, and an SM issues at most 128 lanes per clock.  So a
// draw takes at least max(46 / 64, 136 / 128) = 1.0625 SM clocks (the
// issue term binds) over the card's 132 SMs; crush_ln, the compare and the
// quotient are left out.  A 1024-OSD map with 128 hosts draws ~136 items
// per replica.  The bytes moved (8 B of input and 4 B per output column
// per input) are negligible.  What the kernel issues per draw is measured
// apart (`python3 crush_probe.py sass-ops`).
//
// Design:
//   * the quotient.  straw2 draws ln / w, a signed 64-bit truncating
//     division of ln - 2^48 (in [-2^48, 0]) by a u32 weight.  As a
//     division it is a call into a ~90-instruction emulation on the hash's
//     dependency chain.  Here n = 2^48 - ln and m = floor((2^64 - 1) / w),
//     computed once per weight (on the host for crush_map, in the block's
//     prologue for crush_straw2_winners): q = umulhi(n, m) is the quotient
//     or one less, and one multiply-subtract-compare fixes it; the draw is
//     -q.  Exact for every n < 2^64 and w >= 1.  Weight 0 draws S64_MIN.
//   * lanes per input.  A tile of G lanes (G in kLaneVariants, chosen per
//     launch by the wrapper from the input count, the threads the card
//     holds at once and the map's row widths) maps one input.  Lane j draws items j, j+G,
//     ... of a straw2 bucket, two items per iteration so that two hash
//     chains interleave, and keeps its first maximum; a butterfly of
//     shuffles over the tile's own mask then keeps the larger draw, the
//     lower index on equal draws (a lane with no item holds INT_MAX), so
//     every lane ends with straw2's first maximum.  Everything else (the
//     retry loops, collisions, is_out, uniform buckets) runs on all G
//     lanes, which compute the same values; lane 0 writes the row.
//     One thread per input leaves a pool's 16-32 Ki inputs a partial
//     wave and makes a warp of 32 inputs wait on each one's retries; a
//     tile of G holds 32 / G inputs per warp and fills the card.  One
//     lane per input measured slowest at every size on an H100
//     (PERF.md), so crush_map is not built for it; crush_straw2_winners
//     keeps one thread per (x, r).
//   * no stack on the straw2 path.  The result slots (hosts, osds) live
//     in dynamic shared memory, 2 x out_size int32 per lane (each lane of
//     a tile keeps its own copy, so lanes that drift apart between
//     shuffles never read each other's writes); the
//     Fisher-Yates array of a uniform bucket (a per-thread byte array of
//     kMaxUniform entries, in local memory) exists only in the kUniform
//     instantiations, which the wrapper picks for a map with a uniform
//     level.
// Kept from mapper.c: firstn's replica-by-replica order with ftotal up to
// choose_tries and leaf_tries below a failure domain (r' = r + f2,
// vary_r = 1, stable = 1); indep's breadth-first rounds (r = rep +
// numrep * ftotal, a uniform bucket whose size divides numrep adds
// +ftotal, the leaf retry r' = rep + r_last + numrep * f2, holes are
// CRUSH_ITEM_NONE); is_out (mapper.c:378-392); crush_ln (mapper.c:246-288)
// from the 129-entry RH/LH and 256-entry LL tables staged in shared memory
// (4112 bytes per block).  The topology is one int32 array built once per
// engine; weights and reciprocals are arguments of every call, so a
// reweight rebuilds nothing.  Firstn writes [osds..., count] per input,
// padded with -1; indep writes out_size slots.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLevels = 12;            // outer + leaf levels of one segment
constexpr int kMaxRep = 32;               // result columns per input
constexpr int kMaxUniform = 256;          // largest uniform bucket
constexpr int kLnEntries = 129 * 2 + 256; // RH/LH interleaved, then LL
constexpr int kLaneVariants[] = {4, 8, 16};
constexpr int32_t kItemNone = 0x7fffffff;
constexpr int32_t kItemUndef = 0x7ffffffe;
constexpr uint32_t kHashSeed = 1315423911u;
constexpr uint64_t kLnOne = 0x1000000000000ull;  // 2^48 >= crush_ln(u), every u

struct Level {
  int items;     // offset of [n][imax] item ids in topo
  int rows;      // offset of the row map (-1 - bucket id -> row) in topo
  int sizes;     // offset of [n] bucket sizes in topo
  int ids;       // offset of [n] bucket ids in topo
  int weights;   // offset of [n][imax] item weights (and reciprocals)
  int imax;      // row width
  int uniform;   // 1: bucket_perm_choose, 0: straw2
};

struct Params {
  Level lv[kMaxLevels];
  int n_outer, n_leaf;
  int recurse;
  int numrep, out_size;
  int choose_tries, leaf_tries;
  int n_osd;
  int ld_out;
};

// The G lanes that map one input: the tile's lanes of the warp, and this
// lane's rank in it.
template <int G>
struct Tile {
  unsigned mask;
  int rank;
  __device__ __forceinline__ Tile()
      : mask(G == 32 ? 0xffffffffu
                     : ((1u << G) - 1u) << ((threadIdx.x & 31u) & ~(G - 1u))),
        rank(static_cast<int>(threadIdx.x) & (G - 1)) {}
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
__device__ __forceinline__ uint64_t crush_ln(uint32_t xin, const uint64_t* t) {
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
  return result;
}

// One straw2 draw (mapper.c:322-335): (crush_ln(u) - 2^48) / w truncated,
// as -(n / w) with n = 2^48 - crush_ln(u) >= 0 and m = floor((2^64-1)/w).
__device__ __forceinline__ int64_t straw2_draw(uint32_t x, int32_t item, uint32_t r,
                                               int64_t w, uint64_t m,
                                               const uint64_t* lnt) {
  if (w <= 0) return LLONG_MIN;
  const uint32_t u = hash32_3(x, static_cast<uint32_t>(item), r) & 0xffffu;
  const uint64_t n = kLnOne - crush_ln(u, lnt);
  const uint64_t wu = static_cast<uint64_t>(w);
  uint64_t q = __umul64hi(n, m);
  if (n - q * wu >= wu) ++q;
  return -static_cast<int64_t>(q);
}

// The reciprocals of crush_map live in device memory (read through the
// read-only cache), those of crush_straw2_winners in shared memory.
struct GlobalRecips {
  const uint64_t* p;
  __device__ __forceinline__ uint64_t operator()(int i) const {
    return __ldg(reinterpret_cast<const unsigned long long*>(p) + i);
  }
};
struct SharedRecips {
  const uint64_t* p;
  __device__ __forceinline__ uint64_t operator()(int i) const { return p[i]; }
};

// bucket_straw2_choose (mapper.c:300-344) on a tile: the index of the
// first maximum draw, on every lane of the tile.
template <int G, class Recips>
__device__ __forceinline__ int straw2_index(const Tile<G>& t, const int32_t* items,
                                            const int64_t* w, Recips m, int size,
                                            uint32_t x, uint32_t r,
                                            const uint64_t* lnt) {
  int best = INT_MAX;
  int64_t best_draw = LLONG_MIN;
  int i = t.rank;
#pragma unroll 1
  for (; i + G < size; i += 2 * G) {
    const int64_t d0 = straw2_draw(x, __ldg(items + i), r, __ldg(w + i), m(i), lnt);
    const int64_t d1 = straw2_draw(x, __ldg(items + i + G), r, __ldg(w + i + G),
                                   m(i + G), lnt);
    if (best == INT_MAX || d0 > best_draw) {
      best = i;
      best_draw = d0;
    }
    if (d1 > best_draw) {
      best = i + G;
      best_draw = d1;
    }
  }
  if (i < size) {
    const int64_t d = straw2_draw(x, __ldg(items + i), r, __ldg(w + i), m(i), lnt);
    if (best == INT_MAX || d > best_draw) {
      best = i;
      best_draw = d;
    }
  }
  if constexpr (G > 1) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const long long od = __shfl_xor_sync(t.mask, static_cast<long long>(best_draw), off, G);
      const int oi = __shfl_xor_sync(t.mask, best, off, G);
      if (od > best_draw || (od == best_draw && oi < best)) {
        best = oi;
        best_draw = od;
      }
    }
  }
  return best == INT_MAX ? 0 : best;   // an empty row: index 0, as mapper.c
}

// bucket_perm_choose (mapper.c:73-130), stateless: index of perm[r % size].
__device__ __forceinline__ int perm_index(int size, uint32_t bid, uint32_t x, uint32_t r) {
  const uint32_t usize = static_cast<uint32_t>(size);
  const int pr = static_cast<int>(r % usize);
  if (pr == 0) return static_cast<int>(hash32_3(x, bid, 0) % usize);
  uint8_t perm[kMaxUniform];
  for (int i = 0; i < size; ++i) perm[i] = static_cast<uint8_t>(i);
  for (int p = 0; p <= pr && p < size - 1; ++p) {
    const uint32_t i = hash32_3(x, bid, static_cast<uint32_t>(p)) %
                       (usize - static_cast<uint32_t>(p));
    if (i) {
      const uint8_t tmp = perm[p + i];
      perm[p + i] = perm[p];
      perm[p] = tmp;
    }
  }
  return perm[pr];
}

// One lane's result slots in shared memory, kThreads apart.
struct Slots {
  int32_t* p;
  __device__ __forceinline__ int32_t& operator[](int i) const { return p[i * kThreads]; }
};

struct Ctx {
  const int32_t* topo;
  const int64_t* weights;
  const uint64_t* recips;
  const uint64_t* lnt;
  uint32_t x;
};

// One bucket's draw: the item chosen from row `row` of level L with r.
template <int G, bool kUniform>
__device__ __forceinline__ int32_t level_choose(const Ctx& c, const Tile<G>& t,
                                                const Level& L, int row, int64_t r) {
  const int32_t* items = c.topo + L.items + static_cast<size_t>(row) * L.imax;
  const int size = __ldg(c.topo + L.sizes + row);
  if constexpr (kUniform) {
    if (L.uniform) {
      return __ldg(items + perm_index(size, static_cast<uint32_t>(__ldg(c.topo + L.ids + row)),
                                      c.x, static_cast<uint32_t>(r)));
    }
  }
  const size_t off = L.weights + static_cast<size_t>(row) * L.imax;
  return __ldg(items + straw2_index<G>(t, items, c.weights + off, GlobalRecips{c.recips + off},
                                       size, c.x, static_cast<uint32_t>(r), c.lnt));
}

// Descend levels [l0, l1) from `row` of level l0.  bump >= 0 applies
// choose_indep's per-bucket stride: a uniform bucket whose size divides
// numrep draws with r + bump.  *r_last receives the r of the last draw.
template <int G, bool kUniform>
__device__ __forceinline__ int32_t descend(const Ctx& c, const Tile<G>& t, const Params& P,
                                           int l0, int l1, int row, int64_t r,
                                           int64_t bump, int64_t* r_last) {
  int32_t cand = 0;
  int64_t r_lv = r;
  for (int l = l0; l < l1; ++l) {
    const Level& L = P.lv[l];
    if (l > l0) row = __ldg(c.topo + L.rows + (-1 - cand));
    r_lv = r;
    if (kUniform && bump > 0 && L.uniform) {
      const int size = __ldg(c.topo + L.sizes + row);
      if (size % P.numrep == 0) r_lv = r + bump;
    }
    cand = level_choose<G, kUniform>(c, t, L, row, r_lv);
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

template <bool kFirstn, int G, bool kUniform>
__global__ void __launch_bounds__(kThreads)
crush_map_kernel(Params P, const int32_t* __restrict__ topo,
                 const int64_t* __restrict__ weights,
                 const uint64_t* __restrict__ recips,
                 const int64_t* __restrict__ osd_w,
                 const int64_t* __restrict__ ln_tables,
                 const int64_t* __restrict__ xs, long long X,
                 int32_t* __restrict__ out) {
  __shared__ uint64_t lnt[kLnEntries];
  extern __shared__ int32_t slots[];       // [2 * out_size][kThreads]
  for (int i = threadIdx.x; i < kLnEntries; i += blockDim.x)
    lnt[i] = static_cast<uint64_t>(ln_tables[i]);
  __syncthreads();
  const long long input =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (input >= X) return;                  // the whole tile leaves together
  const Tile<G> t;

  Ctx c{topo, weights, recips, lnt, static_cast<uint32_t>(xs[input])};
  const int leaf0 = P.n_outer, leaf1 = P.n_outer + P.n_leaf;
  // each lane keeps its own slots (no lane waits on another's writes),
  // slot i of all threads side by side: a warp's accesses hit 32 banks
  const Slots hosts{slots + threadIdx.x};
  const Slots osds{slots + P.out_size * kThreads + threadIdx.x};
  int32_t* row_out = out + input * P.ld_out;

  if (kFirstn) {
    int outpos = 0;
    for (int rep = 0; rep < P.numrep; ++rep) {
      for (int ftotal = 0; ftotal < P.choose_tries; ++ftotal) {
        const int64_t r = rep + ftotal;
        int64_t r_last;
        const int32_t host = descend<G, kUniform>(c, t, P, 0, P.n_outer, 0, r, 0, &r_last);
        bool collide = false;
        for (int i = 0; i < outpos; ++i) collide |= hosts[i] == host;
        if (collide) continue;
        int32_t osd = host;
        bool ok = false;
        if (P.recurse) {
          const int row = __ldg(topo + P.lv[leaf0].rows + (-1 - host));
          for (int f2 = 0; f2 < P.leaf_tries && !ok; ++f2) {
            const int32_t cand =
                descend<G, kUniform>(c, t, P, leaf0, leaf1, row, r + f2, 0, &r_last);
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
    if (t.rank == 0) {
      for (int i = 0; i < P.numrep; ++i) row_out[i] = i < outpos ? osds[i] : -1;
      row_out[P.numrep] = outpos;
    }
  } else {
    for (int i = 0; i < P.out_size; ++i) hosts[i] = osds[i] = kItemUndef;
    int left = P.out_size;
    for (int ftotal = 0; ftotal < P.choose_tries && left > 0; ++ftotal) {
      for (int rep = 0; rep < P.out_size; ++rep) {
        if (hosts[rep] != kItemUndef) continue;
        int64_t r_last;
        const int32_t host = descend<G, kUniform>(
            c, t, P, 0, P.n_outer, 0, rep + static_cast<int64_t>(P.numrep) * ftotal,
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
            const int32_t cand = descend<G, kUniform>(
                c, t, P, leaf0, leaf1, row, base + static_cast<int64_t>(P.numrep) * f2, f2,
                &unused);
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
    if (t.rank == 0) {
      for (int i = 0; i < P.out_size; ++i)
        row_out[i] = osds[i] == kItemUndef ? kItemNone : osds[i];
    }
  }
}

// out[x, r] = the straw2 winner of one bucket for input xs[x] and draw
// rs[r]; one thread per (x, r).  The block's prologue computes the items'
// reciprocals into shared memory, one division per item.
__global__ void __launch_bounds__(kThreads)
crush_straw2_winners_kernel(const int32_t* __restrict__ items,
                            const int64_t* __restrict__ w, int B,
                            const int64_t* __restrict__ ln_tables,
                            const int64_t* __restrict__ xs, long long X,
                            const int64_t* __restrict__ rs, int R,
                            int64_t* __restrict__ out) {
  __shared__ uint64_t lnt[kLnEntries];
  extern __shared__ uint64_t recip[];      // [B]
  for (int i = threadIdx.x; i < kLnEntries; i += blockDim.x)
    lnt[i] = static_cast<uint64_t>(ln_tables[i]);
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const int64_t wi = w[i];
    recip[i] = wi > 0 ? ~0ull / static_cast<uint64_t>(wi) : 0;
  }
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= X * R) return;
  const long long xi = i / R;
  const int ri = static_cast<int>(i - xi * R);
  const int idx = straw2_index<1>(Tile<1>(), items, w, SharedRecips{recip}, B,
                                  static_cast<uint32_t>(xs[xi]),
                                  static_cast<uint32_t>(rs[ri]), lnt);
  out[i] = __ldg(items + idx);
}

struct MapArgs {
  Params P;
  const int32_t* topo;
  const int64_t* weights;
  const uint64_t* recips;
  const int64_t* osd_w;
  const int64_t* ln;
  const int64_t* xs;
  long long X;
  int32_t* out;
};

template <bool kFirstn, int G, bool kUniform>
void launch_map(const MapArgs& a, cudaStream_t s) {
  const long long threads = a.X * G;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  const size_t smem = static_cast<size_t>(kThreads) * 2 * a.P.out_size * sizeof(int32_t);
  crush_map_kernel<kFirstn, G, kUniform><<<grid, kThreads, smem, s>>>(
      a.P, a.topo, a.weights, a.recips, a.osd_w, a.ln, a.xs, a.X, a.out);
}

template <int G>
void launch_lanes(const MapArgs& a, bool firstn, bool uniform, cudaStream_t s) {
  if (firstn) {
    uniform ? launch_map<true, G, true>(a, s) : launch_map<true, G, false>(a, s);
  } else {
    uniform ? launch_map<false, G, true>(a, s) : launch_map<false, G, false>(a, s);
  }
}

}  // namespace

// Launches the descent for one rule segment on `stream` with `lanes`
// lanes per input; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments it does not take (lanes not in
// kLaneVariants among them).  levels: host array of 7 ints per level (the
// fields of Level, in order), n_outer + n_leaf levels; a level with the
// uniform flag selects the kUniform instantiation.  topo, weights,
// recips (floor((2^64 - 1) / w) per weight, 0 for w <= 0), osd_w,
// ln_tables (kLnEntries int64), xs and out are device pointers; out is
// [X][ld_out] int32.
extern "C" int crush_map(const int* levels, int n_outer, int n_leaf, int firstn,
                         int recurse, int numrep, int out_size, int choose_tries,
                         int leaf_tries, const void* topo, const void* weights,
                         const void* recips, const void* osd_w, int n_osd,
                         const void* ln_tables, const void* xs, long long X,
                         void* out, int ld_out, int lanes, void* stream) {
  if (n_outer < 1 || n_leaf < 0 || n_outer + n_leaf > kMaxLevels ||
      numrep < 1 || out_size < 1 || out_size > kMaxRep ||
      (firstn && numrep != out_size) || ld_out < out_size + (firstn ? 1 : 0) ||
      (recurse && n_leaf < 1) || X < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bool known = false;
  for (int g : kLaneVariants) known |= g == lanes;
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  if (X == 0) return 0;
  MapArgs a{};
  bool uniform = false;
  for (int l = 0; l < n_outer + n_leaf; ++l) {
    const int* f = levels + 7 * l;
    a.P.lv[l] = Level{f[0], f[1], f[2], f[3], f[4], f[5], f[6]};
    uniform |= f[6] != 0;
  }
  a.P.n_outer = n_outer;
  a.P.n_leaf = n_leaf;
  a.P.recurse = recurse;
  a.P.numrep = numrep;
  a.P.out_size = out_size;
  a.P.choose_tries = choose_tries;
  a.P.leaf_tries = leaf_tries;
  a.P.n_osd = n_osd;
  a.P.ld_out = ld_out;
  a.topo = static_cast<const int32_t*>(topo);
  a.weights = static_cast<const int64_t*>(weights);
  a.recips = static_cast<const uint64_t*>(recips);
  a.osd_w = static_cast<const int64_t*>(osd_w);
  a.ln = static_cast<const int64_t*>(ln_tables);
  a.xs = static_cast<const int64_t*>(xs);
  a.X = X;
  a.out = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 4: launch_lanes<4>(a, firstn, uniform, s); break;
    case 8: launch_lanes<8>(a, firstn, uniform, s); break;
    case 16: launch_lanes<16>(a, firstn, uniform, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The [X][R] straw2 winner grid of one bucket (items/w: B entries); B * 8
// bytes of reciprocals in dynamic shared memory beside the ln tables.
extern "C" int crush_straw2_winners(const void* items, const void* w, int B,
                                    const void* ln_tables, const void* xs, long long X,
                                    const void* rs, int R, void* out, void* stream) {
  if (B < 1 || R < 0 || X < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (X == 0 || R == 0) return 0;
  const size_t smem = static_cast<size_t>(B) * sizeof(uint64_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        crush_straw2_winners_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long n = X * R;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  crush_straw2_winners_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(items), static_cast<const int64_t*>(w), B,
      static_cast<const int64_t*>(ln_tables), static_cast<const int64_t*>(xs), X,
      static_cast<const int64_t*>(rs), R, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int crush_max_levels() { return kMaxLevels; }
extern "C" int crush_max_rep() { return kMaxRep; }
extern "C" int crush_max_uniform() { return kMaxUniform; }

// Writes the built lane variants (ascending) to out[0..cap) and returns
// their number.
extern "C" int crush_lane_variants(int* out, int cap) {
  int n = 0;
  for (int g : kLaneVariants) {
    if (n < cap) out[n] = g;
    ++n;
  }
  return n;
}

extern "C" const char* crush_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
