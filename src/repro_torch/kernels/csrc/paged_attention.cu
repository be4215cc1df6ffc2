// Paged decode attention over a block-table KV pool (sm_90a, float32).
//
// Replaces the Pallas kernel `paged_attention` of
// src/repro/kernels/paged_attention.py:84 (body `_paged_kernel`, l.28);
// semantics are those of `paged_attention_ref` in kernels/ref.py: the
// partial softmax statistics (acc [B, Hq, hd], m [B, Hq], l [B, Hq]) of
// q [B, Hq, hd] over the pages tables [B, pps] names in
// pool [P, page, 2, Hkv, hd].
//
// Masking follows the reference: slots with pid < 0 are skipped, and a key
// at pos = page_pos + t is valid when pos <= seq_len and, for window > 0,
// seq_len - pos < window. Only valid keys are read and scored: an invalid
// key's weight is 0 in the reference and its -1e30 score never raises the
// max, so skipping it gives the same (m, l, acc). A row with no valid key
// returns m = -1e30, l = 0, acc = 0: no NaN. (An idle engine slot has its
// parking page and seq_len 0: one valid key.)
//
// Bound on the H100: bytes. Each valid key's K and V head rows are read
// once (ctx x 2 x Hkv x hd x 4 B a row) against 4 x Hq x hd FLOP a key, far
// below the float32 rate: at the serving shape (B = 8, Hq = 24, Hkv = 8,
// hd = 128, 1041 keys a row) 68.4 MB a call, 20.4 us at 3.35 TB/s. So the
// design is about keeping enough bytes in flight, and little else on the
// path between the launch and the last byte:
//
// * Split-KV over a thread-block cluster. A row's valid keys, in slot
//   order, form tiles of up to TK keys of one page (TK = 16 for hd >= 32: a
//   whole page of the engine's 16). The tiles of a (row, KV head, group
//   block) are split into S contiguous ranges of equal count (within one),
//   one a block of a cluster of S blocks; counting valid tiles rather than
//   slots keeps the blocks even when a short row leaves most of its table
//   empty. A block with no tile contributes m = -1e30, l = 0, acc = 0. S is
//   the smallest of 1, 2, 4, 8 whose grid holds kInFlightBytes in its
//   rings (Little's law: 3.35 TB/s x ~1.8 us), doubled only while a block
//   keeps kMinSlots table slots: 2 at the serving shape (128 blocks), 8 for
//   one row. More, shallower blocks pay the start and the combine more
//   often for no more bytes in flight.
// * A cp.async ring of kStages = 3 tiles in shared memory; a tile is the K
//   and V head rows of its keys (16 KB at hd 128), only the valid rows
//   read, the rest zero-filled. The copy of tile j + 2 goes out before tile
//   j is waited for, so three tiles are in flight while a block waits. The
//   table is read once (a block's list of tiles is built from the same
//   loads that count them), with q's loads beside it.
// * Scores without a warp all-reduce per key: L = 8 lanes score one key
//   (hd / 32 float4s each, 3 shuffles a query head, reading contiguous
//   128 B per quarter-warp; q from shared memory). Warp w takes keys w,
//   w + 4, ... of each tile and keeps its own online softmax, rescaled once
//   a tile, so a tile needs no block-wide step between its scores and p v;
//   each p is computed once a key group and broadcast by shuffle, and
//   lane c4 adds p v for float4 column c4 of V. acc, m and l are registers
//   sized by the group bucket GB (1, 2, 3, 4, or 8 with zero query heads
//   past the group; groups of more than 8 take one block each 8).
// * The combine in distributed shared memory: a block merges its warps'
//   partials into one (m, l, acc) and writes it into its own slot in the
//   shared memory of block 0 of the cluster (map_shared_rank). After one
//   cluster.sync() block 0 takes max m, then sum x exp(m_s - m) over the S
//   slots in rank order, so the result is deterministic, and writes the
//   output. No block reads another's shared memory, so none has to wait
//   for the others to leave (pulling the partials, with a second
//   cluster.sync() before exit, measured about 1 us slower on an H100).
//
// One launch a call; a launch the card refuses (cluster, shared memory)
// returns its error and the wrapper raises.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // cp_async16, cp_async_commit, cp_async_wait

namespace cg = cooperative_groups;

namespace libra {

constexpr float kAttnNegInf = -1e30f;
constexpr int kThreads = 128;   // four warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;      // tiles in the cp.async ring
constexpr int kMinBlocks = 4;   // blocks an SM (group buckets up to 4)
constexpr int kMaxSplit = 8;    // blocks a cluster: the portable limit
constexpr int kMinSlots = 2;    // table slots a block at least, to split
// bytes the grid's rings hold: 3.35 TB/s times about 1.8 us of latency
constexpr long long kInFlightBytes = 6LL << 20;

template <int HD>
struct PagedTile {
  static constexpr int C4 = HD / 4;            // float4 columns of a row
  static constexpr int L = C4 < 8 ? C4 : 8;    // lanes that score one key
  static constexpr int NV = C4 / L;            // float4s a lane scores
  static constexpr int TK = kThreads / L;      // keys a tile
  static constexpr int KW = TK / kWarps;       // keys a warp: w, w + 4, ...
  static constexpr int NSUB = 32 / C4;         // keys a warp's p v takes
  static constexpr int R = kWarps * NSUB;      // p v partials a block
  static_assert(C4 % L == 0, "head dim: a multiple of 4, at most 128");
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Dynamic shared memory, in floats: the ring (later the warps' partials),
// the scaled q, the scan's warp totals, one slot a block of the cluster for
// its partial (acc [GB][HD], m [GB], l [GB]; used in block 0), then the
// block's tile list (int2 each).
template <int HD, int GB>
struct PagedSmem {
  using T = PagedTile<HD>;
  static constexpr int kRing = kStages * 2 * T::TK * HD;
  static constexpr int kRed = round4(T::R * GB * HD + 2 * kWarps * GB);
  static constexpr int kUnion = kRing > kRed ? kRing : kRed;
  static constexpr int kQ = GB * HD;
  static constexpr int kScan = kWarps;
  static constexpr int kSlots = kUnion + kQ + kScan;  // where slot 0 starts
  static constexpr int kPart = round4(GB * HD + 2 * GB);
  __host__ __device__ static int floats(int split) {
    return kSlots + split * kPart;
  }
  static size_t bytes(int split, long long cap) {
    return (size_t)floats(split) * 4 + (size_t)cap * sizeof(int2);
  }
};

// Exclusive prefix sum of v over the block, and its total.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int base = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_sums[w];
    base += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();
  return base + x - v;
}

// Valid keys [lo, hi) of slot j of a row, and how many tiles of tk keys
// they make (0 for a -1 slot or a page with no valid key).
__device__ __forceinline__ int slot_tiles(const int* tables,
                                          const int* page_pos, int64_t row,
                                          int j, int pps, long long slen,
                                          int page, int window, int tk,
                                          int& pid, int& lo, int& hi) {
  if (j >= pps) return 0;
  pid = tables[row + j];
  const long long base = page_pos[row + j];  // loaded beside pid
  if (pid < 0) return 0;
  long long h = slen - base + 1;
  if (h > page) h = page;
  long long l = 0;
  if (window > 0 && slen - window + 1 - base > 0) l = slen - window + 1 - base;
  if (h <= l) return 0;
  lo = (int)l;
  hi = (int)h;
  return (hi - lo + tk - 1) / tk;
}

// List the c tiles of a slot whose first tile is the block's tile `at`
// (those inside [0, nt) only): page id, and t0 | t1 << 16.
__device__ __forceinline__ void list_tiles(int2* list, int c, int pid, int lo,
                                           int hi, int at, int nt, int tk) {
  for (int k = 0; k < c; ++k) {
    const int idx = at + k;
    if (idx >= 0 && idx < nt) {
      const int t0 = lo + k * tk, t1 = min(hi, t0 + tk);
      list[idx] = make_int2(pid, t0 | (t1 << 16));
    }
  }
}

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

__device__ __forceinline__ float4 scale4(float a, float4 x) {
  return make_float4(a * x.x, a * x.y, a * x.z, a * x.w);
}

template <int HD, int GB>
__global__ void __launch_bounds__(kThreads, GB <= 4 ? kMinBlocks : 1)
    paged_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ pool,
                           const int* __restrict__ tables,
                           const int* __restrict__ page_pos,
                           const int* __restrict__ seq_lens,
                           float* __restrict__ acc_out,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out, int hq, int hkv,
                           int page, int pps, int window, int cap) {
  using T = PagedTile<HD>;
  using Sm = PagedSmem<HD, GB>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ring = smem;
  float* red_acc = smem;  // [R][GB][HD], once the ring is drained
  float* red_m = smem + T::R * GB * HD;  // [kWarps][GB]
  float* red_l = red_m + kWarps * GB;
  float* sq = smem + Sm::kUnion;  // [GB][HD], scaled
  int* warp_sums = reinterpret_cast<int*>(sq + Sm::kQ);
  float* slots = smem + Sm::kSlots;  // [split][kPart]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  int2* list = reinterpret_cast<int2*>(smem + Sm::floats(split));
  // arrive now, wait before the first write into block 0's shared memory:
  // by then every block of the cluster has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int gn = hq / hkv;
  const int n_gblk = (gn + GB - 1) / GB;
  const int h = blockIdx.y / n_gblk, g0 = (blockIdx.y % n_gblk) * GB;
  const int gcount = min(GB, gn - g0);
  const int bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long slen = seq_lens[bi];
  const int64_t row = (int64_t)bi * pps;

  // q of the group block, scaled; loaded first, so that its latency passes
  // under the table's. Query heads past the group are 0.
  const float scale = 1.0f / sqrtf((float)HD);
  const int64_t qrow = ((int64_t)bi * hq + (int64_t)h * gn + g0) * HD;
  constexpr int kQPer = (GB * HD + kThreads - 1) / kThreads;
  float qr[kQPer];
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int e = tid + u * kThreads;
    qr[u] = e < gcount * HD ? q[qrow + e] * scale : 0.f;
  }

  // 1. The row's valid tiles in slot order: count them, then list this
  //    block's contiguous share [t_begin, t_end). A table of at most
  //    kThreads slots is read once: each thread keeps its slot.
  int n_all = 0, n_first = 0;
  int c0 = 0, pid0 = 0, lo0 = 0, hi0 = 0, first0 = 0;
  for (int w0 = 0; w0 < pps; w0 += kThreads) {
    int pid = 0, lo = 0, hi = 0, total;
    const int c = slot_tiles(tables, page_pos, row, w0 + tid, pps, slen, page,
                             window, T::TK, pid, lo, hi);
    const int first = n_all + block_scan(c, warp_sums, total);
    if (w0 == 0) {
      c0 = c, pid0 = pid, lo0 = lo, hi0 = hi, first0 = first;
      n_first = total;
    }
    n_all += total;
  }
  const int t_begin = (int)((long long)rank * n_all / split);
  const int t_end = (int)((long long)(rank + 1) * n_all / split);
  const int nt = min(t_end - t_begin, cap);
  list_tiles(list, c0, pid0, lo0, hi0, first0 - t_begin, nt, T::TK);
  for (int w0 = kThreads, seen = n_first; w0 < pps && seen < t_end;
       w0 += kThreads) {
    int pid = 0, lo = 0, hi = 0, total;
    const int c = slot_tiles(tables, page_pos, row, w0 + tid, pps, slen, page,
                             window, T::TK, pid, lo, hi);
    const int first = seen + block_scan(c, warp_sums, total);
    list_tiles(list, c, pid, lo, hi, first - t_begin, nt, T::TK);
    seen += total;
  }
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int e = tid + u * kThreads;
    if (e < GB * HD) sq[e] = qr[u];
  }
  __syncthreads();

  // 2. The cp.async ring: tile j's K and V head rows into slot j % kStages,
  //    rows past its keys zero-filled.
  const int64_t tok = 2LL * hkv * HD;  // one key position of a page
  const float* head = pool + (int64_t)h * HD;
  auto issue = [&](int j) {
    const int2 e = list[j];
    const int t0 = e.y & 0xffff, n = (e.y >> 16) - t0;
    const float* src = head + ((int64_t)e.x * page + t0) * tok;
    float* dst = ring + (j % kStages) * (2 * T::TK * HD);
#pragma unroll
    for (int u = 0; u < 2 * T::NV; ++u) {  // 2 TK C4 chunks of 16 B
      const int i = tid + u * kThreads;
      const int kv = i / (T::TK * T::C4), r = (i / T::C4) % T::TK;
      const int c = i % T::C4;
      const bool in = r < n;
      cp_async16(dst + (kv * T::TK + r) * HD + c * 4,
                 in ? src + r * tok + kv * (int64_t)hkv * HD + c * 4 : src,
                 in);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) issue(s);
    cp_async_commit();
  }

  // Each warp runs its own online softmax over the tile's keys w, w + 4,
  // ...: lane group q (L lanes, float4 columns sl + L i) scores key
  // w + 4 q; for p v, lane (c4, sub) takes float4 column c4 of V for the
  // groups q = sub, sub + NSUB, ... (hd 96: lanes 24-31 sit out).
  const int grp = lane / T::L, sl = lane % T::L;
  const int c4 = lane % T::C4, sub = lane / T::C4;
  float m[GB], l[GB];
  float4 acc[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kAttnNegInf;
    l[g] = 0.f;
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int j = 0; j < nt; ++j) {
    // the copy of tile j + kStages - 1 goes out before tile j is waited
    // for, into the slot tile j - 1 left
    if (j + kStages - 1 < nt) issue(j + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile j landed
    const int2 e = list[j];
    const int n = (e.y >> 16) - (e.y & 0xffff);
    const float* kt = ring + (j % kStages) * (2 * T::TK * HD);
    const float* vt = kt + T::TK * HD;
    const int key = warp + kWarps * grp;

    float4 kr[T::NV];
#pragma unroll
    for (int i = 0; i < T::NV; ++i)
      kr[i] = *reinterpret_cast<const float4*>(kt + key * HD +
                                               (sl + T::L * i) * 4);
    float p[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < T::NV; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            sq + g * HD + (sl + T::L * i) * 4);
        s = fmaf(qv.x, kr[i].x, s);
        s = fmaf(qv.y, kr[i].y, s);
        s = fmaf(qv.z, kr[i].z, s);
        s = fmaf(qv.w, kr[i].w, s);
      }
#pragma unroll
      for (int o = T::L / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      s = key < n ? s : kAttnNegInf;
      float mx = s;  // the max over the warp's keys, rescaled once a tile
#pragma unroll
      for (int o = T::L; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[g], mx);
      const float alpha = __expf(m[g] - mn);
      m[g] = mn;
      l[g] *= alpha;
      acc[g] = scale4(alpha, acc[g]);
      p[g] = key < n ? __expf(s - mn) : 0.f;
    }
#pragma unroll
    for (int gq = 0; gq < T::KW; ++gq) {
      float pq[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        pq[g] = __shfl_sync(0xffffffffu, p[g], gq * T::L);
        l[g] += pq[g];
      }
      const int k = warp + kWarps * gq;
      if (gq % T::NSUB == sub && k < n) {
        const float4 v =
            *reinterpret_cast<const float4*>(vt + k * HD + c4 * 4);
#pragma unroll
        for (int g = 0; g < GB; ++g) acc[g] = fma4(pq[g], v, acc[g]);
      }
    }
    __syncthreads();  // slot j % kStages is free
  }

  // 3. The block's partial: its warps' partials, rescaled to the block's
  //    max and summed in order, written into its slot in block 0 of the
  //    cluster (distributed shared memory).
  cp_async_wait<0>();  // (only empty groups are left)
  if (sub < T::NSUB) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
      *reinterpret_cast<float4*>(
          red_acc + ((warp * T::NSUB + sub) * GB + g) * HD + c4 * 4) = acc[g];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      red_m[warp * GB + g] = m[g];
      red_l[warp * GB + g] = l[g];
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* slot = cluster.map_shared_rank(slots + rank * Sm::kPart, 0);
  for (int e = tid; e < GB * T::C4; e += kThreads) {
    const int g = e / T::C4;
    float mx = kAttnNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * GB + g]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(red_m[w * GB + g] - mx);
#pragma unroll
      for (int u = 0; u < T::NSUB; ++u)
        a = fma4(f,
                 *reinterpret_cast<const float4*>(
                     red_acc + (w * T::NSUB + u) * GB * HD + e * 4),
                 a);
    }
    *reinterpret_cast<float4*>(slot + e * 4) = a;
  }
  for (int g = tid; g < GB; g += kThreads) {
    float mx = kAttnNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * GB + g]);
    float x = 0.f;
    for (int w = 0; w < kWarps; ++w)
      x += red_l[w * GB + g] * __expf(red_m[w * GB + g] - mx);
    slot[GB * HD + g] = mx;
    slot[GB * HD + GB + g] = x;
  }

  // 4. The cluster's combine: once every partial is in its slot, block 0
  //    merges them in rank order and writes (acc, m, l). No block reads
  //    another's shared memory, so the others may leave at once.
  cluster.sync();
  if (rank != 0) return;
  const float* slot_m = slots + GB * HD;
  const float* slot_l = slot_m + GB;
  for (int e = tid; e < gcount * T::C4; e += kThreads) {
    const int g = e / T::C4;
    float ms[kMaxSplit];
    float4 xs[kMaxSplit];
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s) {
      ms[s] = kAttnNegInf;
      xs[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < split) {
        ms[s] = slot_m[s * Sm::kPart + g];
        xs[s] = *reinterpret_cast<const float4*>(slots + s * Sm::kPart +
                                                 e * 4);
      }
    }
    float mx = kAttnNegInf;
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s) mx = fmaxf(mx, ms[s]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s)
      if (s < split) a = fma4(__expf(ms[s] - mx), xs[s], a);
    *reinterpret_cast<float4*>(acc_out + qrow + e * 4) = a;
  }
  if (tid < gcount) {
    float mx = kAttnNegInf;
    for (int s = 0; s < split; ++s) mx = fmaxf(mx, slot_m[s * Sm::kPart + tid]);
    float x = 0.f;
    for (int s = 0; s < split; ++s)
      x += slot_l[s * Sm::kPart + tid] *
           __expf(slot_m[s * Sm::kPart + tid] - mx);
    const int64_t o = (int64_t)bi * hq + (int64_t)h * gn + g0 + tid;
    m_out[o] = mx;
    l_out[o] = x;
  }
}

// S: the smallest of 1, 2, 4, 8 whose grid's rings hold kInFlightBytes,
// doubled only while each block keeps at least kMinSlots table slots.
inline int pick_split(int units, int pps, long long ring_bytes) {
  int s = 1;
  while (s < kMaxSplit && units * ring_bytes * s < kInFlightBytes &&
         pps >= 2 * s * kMinSlots)
    s *= 2;
  return s;
}

template <int HD, int GB>
int launch_paged(const void* q, const void* pool, const void* tables,
                 const void* page_pos, const void* seq_lens, void* acc,
                 void* m, void* l, int b, int hq, int hkv, int page, int pps,
                 int window, cudaStream_t stream) {
  using T = PagedTile<HD>;
  const int n_gblk = (hq / hkv + GB - 1) / GB;
  const int split = pick_split(b * hkv * n_gblk, pps,
                               4LL * PagedSmem<HD, GB>::kRing);
  const long long tiles = (long long)pps * ((page + T::TK - 1) / T::TK);
  const long long cap = (tiles + split - 1) / split;
  const size_t bytes = PagedSmem<HD, GB>::bytes(split, cap);
  auto kernel = paged_attention_kernel<HD, GB>;
  cudaError_t err;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, hkv * n_gblk, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const float*)q, (const float*)pool,
                           (const int*)tables, (const int*)page_pos,
                           (const int*)seq_lens, (float*)acc, (float*)m,
                           (float*)l, hq, hkv, page, pps, window, (int)cap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int HD>
int launch_group(const void* q, const void* pool, const void* tables,
                 const void* page_pos, const void* seq_lens, void* acc,
                 void* m, void* l, int b, int hq, int hkv, int page, int pps,
                 int window, cudaStream_t st) {
#define LIBRA_PAGED_G(GB)                                                   \
  return launch_paged<HD, GB>(q, pool, tables, page_pos, seq_lens, acc, m, \
                              l, b, hq, hkv, page, pps, window, st);
  switch (hq / hkv) {
    case 1: LIBRA_PAGED_G(1)
    case 2: LIBRA_PAGED_G(2)
    case 3: LIBRA_PAGED_G(3)
    case 4: LIBRA_PAGED_G(4)
    default: LIBRA_PAGED_G(8)
  }
#undef LIBRA_PAGED_G
}

}  // namespace libra

extern "C" int libra_paged_attention(const void* q, const void* pool,
                                     const void* tables, const void* page_pos,
                                     const void* seq_lens, void* acc, void* m,
                                     void* l, int b, int hq, int hkv, int hd,
                                     int page, int pps, int window,
                                     void* cuda_stream) {
  cudaStream_t st = (cudaStream_t)cuda_stream;
  // tile rows pack two key offsets in 16 bits each; cp.async and the float4
  // stores need 16-byte aligned pool and acc
  if (page > 0x7fff) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)pool | (uintptr_t)acc) & 15)
    return (int)cudaErrorMisalignedAddress;
#define LIBRA_PAGED(HD)                                                     \
  case HD:                                                                  \
    return libra::launch_group<HD>(q, pool, tables, page_pos, seq_lens, acc, \
                                   m, l, b, hq, hkv, page, pps, window, st);
  switch (hd) {
    LIBRA_PAGED(16)
    LIBRA_PAGED(32)
    LIBRA_PAGED(64)
    LIBRA_PAGED(96)
    LIBRA_PAGED(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LIBRA_PAGED
}
