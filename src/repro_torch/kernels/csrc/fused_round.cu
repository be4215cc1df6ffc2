// One scheduling round in one launch: anchor + RX decrypt + policy verdict
// + egress gather (+ TX encrypt).
//
// Replaces the Pallas kernel `_fused_round_impl` (body
// `_fused_round_kernel`) of src/repro/kernels/selective_copy.py:554
// (:417), its staged `n_buffers >= 2` path (:449-490, `_load_row` :492)
// included; semantics are those of `fused_round_ref` in kernels/ref.py.
//
// Design: the page-tile ring of datapath.cuh, `depth` slots a block (the
// wrapper's n_buffers; the TPU kernel stages stream rows D - 1 rows ahead,
// this one stages task windows D - 1 tasks ahead). A row's tasks are its
// metadata-and-verdict task, then one task a tile of at most kTile tokens
// of each table slot.
//   * A tile task stages the stream window of its payload lanes (and the
//     RX keystream's) into its slot; threads write tok ^ ks to the pool
//     row and tok ^ ks ^ txks to out[b, jj*page + ...], in int4s. Payload
//     token rel is live iff the table entry is >= 0 and rel < total_len -
//     meta_len; a live lane whose stream position falls outside [0, S) is
//     not anchored and gathers the pool's current token, as the plain
//     version (gather after scatter) does. Dead lanes of the output are
//     zero. The gathered token never comes back from the pool it was just
//     written to.
//   * The metadata task stages the row's metadata window, and with a
//     policy table the metadata keystream's and the first payload page of
//     the stream and RX keystream (the TPU kernel's first-page window).
//     Warp 0 takes the first matching rule (first_match_warp) from shared
//     memory while the other warps compact meta[b, :meta_max]. The policy
//     table is copied into shared memory once a block when it fits
//     kTableBudget, and read from global memory otherwise.
// Windows: a TMA bulk copy of the 16-byte-aligned cover of each window
// (the stream offset meta_len + rel has any alignment; the slot is read
// back at the shift) when S, page and meta_max are multiples of 4 tokens
// and the pointers 16-byte aligned; 4-byte cp.async of the exact window
// otherwise. A window past kTile tokens (meta_max or a policy position
// beyond the first tile) is read from global memory.
//
// Precondition: a round's page ids are distinct across messages, so tasks
// write disjoint pool lanes and a task's gather reads only lanes it owns.
// The scratch row is never written.
//
// Bound on the H100: bytes. Read the payload lanes of the stream (and RX
// keystream, TX keystream), write them once to the pool and once to the
// output, plus the metadata block; the policy table and verdicts are
// noise. The grid is one wave at any shape (the one-block-a-page grid it
// replaced needed a second wave at the deployment's 1088 blocks). At the
// deployment's shape every block takes one task, so a block's time is two
// dependent round trips (the task's lengths and table entry, then its
// windows) and its stores; the ring's depth shows where a block takes
// several tasks (PERF.md, section 6).
#include "datapath.cuh"

namespace libra {

// Bytes of the policy table (off, lo, hi and live) a block copies into
// shared memory; a larger table is read from global memory.
constexpr int kTableBudget = 8192;

struct FusedArgs {
  const int* stream;
  const int* ks;
  const int* txks;
  const int* meta_len;
  const int* total_len;
  const int* tables;
  int* pool;
  int* meta;
  int* out;
  const int* off;
  const int* lo;
  const int* hi;
  const int* live;
  const int* meta_ks;
  int* verdict;
  int s, p_ext, page, pps, meta_max, r, k;
  int tpp;        // tiles a page
  int row_tasks;  // 1 + pps * tpp
  int per, extra;  // tasks a block (set by launch_ring)
  // ring layout, in words of a slot: the tile (or first-page) window of
  // the stream at 0, of the RX keystream at off_ks; the metadata window at
  // off_meta and the metadata keystream's at off_mks
  int depth, slot_words, off_ks, off_meta, off_mks;
  bool table_in_smem;
};

// The slot layout and shared-memory bytes of a launch (mirrored by
// fused_round_smem_bytes in selective_copy.py).
inline size_t ring_layout(FusedArgs* a) {
  const bool ks = a->ks != nullptr, policy = a->verdict != nullptr;
  const int tile = up4(a->page < kTile ? a->page : kTile) + 4;
  const int mw = up4(a->meta_max < kTile ? a->meta_max : kTile);
  a->off_ks = tile;
  a->off_meta = policy ? tile * (1 + ks) : 0;
  a->off_mks = a->off_meta + mw;
  const int need = a->off_mks + (policy && a->meta_ks ? mw : 0);
  a->slot_words = tile * (1 + ks) > need ? tile * (1 + ks) : need;
  int table = policy ? 4 * (3 * a->r * a->k + a->r) : 0;
  a->table_in_smem = policy && table <= kTableBudget;
  table = a->table_in_smem ? up4(table) : 0;
  return ring_bytes(a->depth, a->slot_words) + table;
}

// Staged metadata tokens of a row: [0, min(meta_len, meta_max, S, kTile)).
__device__ __forceinline__ int meta_staged(int mlen, const FusedArgs& a) {
  int n = mlen < a.meta_max ? mlen : a.meta_max;
  n = n < 0 ? 0 : n;
  n = n < a.s ? n : a.s;
  return n < kTile ? n : kTile;
}

// Staged metadata-keystream tokens: [0, min(meta_len, meta_max, kTile)).
__device__ __forceinline__ int mks_staged(int mlen, const FusedArgs& a) {
  const int n = mlen < a.meta_max ? mlen : a.meta_max;
  return n < 0 ? 0 : (n < kTile ? n : kTile);
}

// Staged payload positions of the policy's first-page window.
__device__ __forceinline__ int pay_staged(int mlen, int tlen,
                                          const FusedArgs& a) {
  long long w = (long long)tlen - mlen;
  w = w < a.page ? w : a.page;
  w = w < kTile ? w : kTile;
  return w < 0 ? 0 : (int)w;
}

// The metadata task's first-page window: stream positions
// min(meta_len + p, S - 1) for the staged p.
template <bool kBulk>
__device__ __forceinline__ Window first_page_window(int mlen, int tlen,
                                                    const FusedArgs& a) {
  const int wp = pay_staged(mlen, tlen, a);
  if (wp == 0) return {0, 0};
  const long long lo = mlen < 0 ? 0 : (mlen > a.s - 1 ? a.s - 1 : mlen);
  long long hi = (long long)mlen + wp;
  hi = hi < a.s ? hi : a.s;
  return window(lo, hi > lo ? hi : lo + 1, kBulk);
}

// A tile task's stream window: the anchored lanes' positions.
template <bool kBulk>
__device__ __forceinline__ Window tile_window(const Task& k,
                                              const FusedArgs& a) {
  if (k.pid < 0 || k.pid >= a.p_ext || k.len == 0) return {0, 0};
  const long long pos0 = (long long)k.mlen + k.page_slot * a.page + k.lo;
  const long long lo = pos0 < 0 ? 0 : pos0;
  const long long hi = pos0 + k.len < a.s ? pos0 + k.len : a.s;
  return window(lo, hi, kBulk);
}

template <bool kBulk>
__global__ void __launch_bounds__(kRingThreads)
    fused_round_kernel(const FusedArgs a) {
  extern __shared__ __align__(16) int smem[];
  const Ring g = ring_at(smem, a.depth, a.slot_words);
  int* table = reinterpret_cast<int*>(g.bars + a.depth);
  int t0, t1;
  block_range(a.per, a.extra, &t0, &t1);
  const int rk = a.r * a.k;
  const bool has_policy = a.verdict != nullptr;
  // a block whose range holds a row's metadata task copies the table
  const int row0 = a.table_in_smem ? t0 / a.row_tasks : 0;
  const bool copy_table = a.table_in_smem && t0 < t1 &&
                          (t0 == row0 * a.row_tasks ||
                           (row0 + 1) * a.row_tasks < t1);
  const int* off = copy_table ? table : a.off;
  const int* lo = copy_table ? table + rk : a.lo;
  const int* hi = copy_table ? table + 2 * rk : a.hi;
  const int* live = a.live == nullptr ? nullptr
                    : copy_table      ? table + 3 * rk
                                      : a.live;

  // Task: b; page_slot jj (-1: the metadata task) and its tile [lo, lo +
  // n); pid = tables[b, jj]; mlen; len = live payload lanes of the tile
  // (a prefix; 0 for a -1 entry), for the metadata task total_len; base =
  // the token in slot word 0 of the stream window
  auto load = [&](int t) {
    Task k;
    k.b = t / a.row_tasks;
    const int r = t - k.b * a.row_tasks - 1;
    k.mlen = a.meta_len[k.b];
    const int tlen = a.total_len[k.b];
    if (r < 0) {
      k.page_slot = -1;
      k.lo = k.n = k.pid = 0;
      k.len = tlen;
      k.base = (int)first_page_window<kBulk>(k.mlen, tlen, a).base;
      return k;
    }
    k.page_slot = r / a.tpp;
    k.lo = (r - k.page_slot * a.tpp) * kTile;
    k.n = min(kTile, a.page - k.lo);
    k.pid = a.tables[(int64_t)k.b * a.pps + k.page_slot];
    const long long nl = (long long)tlen - k.mlen -
                         ((long long)k.page_slot * a.page + k.lo);
    k.len = k.pid < 0 || nl <= 0 ? 0 : (nl >= k.n ? k.n : (int)nl);
    k.base = (int)tile_window<kBulk>(k, a).base;
    return k;
  };
  auto plan = [&](const Task& k, auto&& visit) {
    const int* srow = a.stream + (int64_t)k.b * a.s;
    const int* krow = a.ks ? a.ks + (int64_t)k.b * a.s : nullptr;
    const Window w = k.page_slot >= 0 ? tile_window<kBulk>(k, a)
                     : has_policy    ? first_page_window<kBulk>(k.mlen,
                                                                k.len, a)
                                     : Window{0, 0};
    if (w.words > 0) {
      visit(0, srow + w.base, w.words);
      if (krow) visit(a.off_ks, krow + w.base, w.words);
    }
    if (k.page_slot >= 0) return;
    const int nm = meta_staged(k.mlen, a);
    if (nm > 0) visit(a.off_meta, srow, kBulk ? up4(nm) : nm);
    const int nk = mks_staged(k.mlen, a);
    if (has_policy && a.meta_ks && nk > 0)
      visit(a.off_mks, a.meta_ks + (int64_t)k.b * a.meta_max,
            kBulk ? up4(nk) : nk);
  };
  auto prologue = [&] {
    if (!copy_table) return;
    for (int i = threadIdx.x; i < rk; i += blockDim.x) {
      const int o = a.off[i], l = a.lo[i], h = a.hi[i];
      table[i] = o;
      table[rk + i] = l;
      table[2 * rk + i] = h;
    }
    if (a.live != nullptr)
      for (int i = threadIdx.x; i < a.r; i += blockDim.x)
        table[3 * rk + i] = a.live[i];
  };

  // a page tile: anchor its live lanes and write the output
  auto tile_task = [&](const Task& k, const int* slot, auto&& wait) {
    const bool writable = k.pid >= 0 && k.pid < a.p_ext;
    const int rd = k.pid < 0 ? 0 : (writable ? k.pid : a.p_ext - 1);
    const int nlive = k.len;
    const long long pos0 = (long long)k.mlen + k.page_slot * a.page + k.lo;
    // every live lane anchored: the tile's window lies inside the row
    const bool inside = writable && pos0 >= 0 && pos0 + nlive <= a.s;
    const int shift = (int)(pos0 - k.base);  // slot word of lane 0
    int* prow = a.pool + (int64_t)rd * a.page + k.lo;
    const int64_t obase = ((int64_t)k.b * a.pps + k.page_slot) * a.page + k.lo;
    int* out = a.out + obase;
    const int* tx = a.txks ? a.txks + obase : nullptr;
    const int* sks = slot + a.off_ks;
    // lane l's token: anchored from the slot, or the pool's (edge lanes)
    auto token = [&](int l, bool* anchored) {
      const long long pos = pos0 + l;
      *anchored = writable && pos >= 0 && pos < a.s;
      if (!*anchored) return prow[l];
      const int i = shift + l;
      return a.ks ? slot[i] ^ sks[i] : slot[i];
    };
    if (kBulk) {
      constexpr int kGroups = kTile / (4 * kRingThreads);
      int4 tv[kGroups];
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        const int l = 4 * (threadIdx.x + q * kRingThreads);
        tv[q] = make_int4(0, 0, 0, 0);
        if (tx != nullptr && l < nlive)
          tv[q] = *reinterpret_cast<const int4*>(tx + l);
      }
      wait();
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        const int l = 4 * (threadIdx.x + q * kRingThreads);
        if (l >= k.n) continue;
        if (l >= nlive) {
          *reinterpret_cast<int4*>(out + l) = make_int4(0, 0, 0, 0);
          continue;
        }
        int4 v = make_int4(0, 0, 0, 0);
        if (inside && l + 3 < nlive) {  // the common case: four anchored
          const int i = shift + l;
          v = make_int4(slot[i], slot[i + 1], slot[i + 2], slot[i + 3]);
          if (a.ks) {
            v.x ^= sks[i];
            v.y ^= sks[i + 1];
            v.z ^= sks[i + 2];
            v.w ^= sks[i + 3];
          }
          *reinterpret_cast<int4*>(prow + l) = v;
        } else {
          int t[4] = {0, 0, 0, 0};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (l + e >= nlive) continue;
            bool an;
            t[e] = token(l + e, &an);
            if (an) prow[l + e] = t[e];
          }
          v = make_int4(t[0], t[1], t[2], t[3]);
        }
        const int4 x = tv[q];  // dead lanes of the output are zero
        *reinterpret_cast<int4*>(out + l) = make_int4(
            v.x ^ x.x, l + 1 < nlive ? v.y ^ x.y : 0,
            l + 2 < nlive ? v.z ^ x.z : 0, l + 3 < nlive ? v.w ^ x.w : 0);
      }
    } else {
      constexpr int kLanes = kTile / kRingThreads;
      int tv[kLanes];
#pragma unroll
      for (int q = 0; q < kLanes; ++q) {
        const int l = threadIdx.x + q * kRingThreads;
        tv[q] = tx != nullptr && l < nlive ? tx[l] : 0;
      }
      wait();
#pragma unroll
      for (int q = 0; q < kLanes; ++q) {
        const int l = threadIdx.x + q * kRingThreads;
        if (l >= k.n) continue;
        int o = 0;
        if (l < nlive) {
          bool an;
          const int v = token(l, &an);
          if (an) prow[l] = v;
          o = v ^ tv[q];
        }
        out[l] = o;
      }
    }
  };

  // the metadata task: compact meta[b, :meta_max] and take the verdict
  auto meta_task = [&](const Task& k, const int* slot, auto&& wait) {
    const int mlen = k.mlen;
    const long long plen = (long long)k.len - mlen;
    const int* srow = a.stream + (int64_t)k.b * a.s;
    const int nm = meta_staged(mlen, a);
    wait();
    auto meta_tok = [&](int i) {  // stream[min(i, S - 1)] for i < meta_len
      const int src = i < a.s ? i : a.s - 1;
      return src < nm ? slot[a.off_meta + src] : srow[src];
    };
    // with a policy table warp 0 takes the verdict while the other warps
    // compact the metadata
    const int first = has_policy ? 32 : 0;
    for (int i = threadIdx.x - first; i >= 0 && i < a.meta_max;
         i += blockDim.x - first)
      a.meta[(int64_t)k.b * a.meta_max + i] = i < mlen ? meta_tok(i) : 0;
    if (!has_policy || threadIdx.x >= 32) return;
    const int nk = mks_staged(mlen, a);
    const int* mks = a.meta_ks ? a.meta_ks + (int64_t)k.b * a.meta_max
                               : nullptr;
    const int wp = pay_staged(mlen, k.len, a);
    const int* krow = a.ks ? a.ks + (int64_t)k.b * a.s : nullptr;
    auto meta_at = [&](int o) {
      const int v = meta_tok(o);
      if (mks == nullptr) return v;
      return v ^ (o < nk ? slot[a.off_mks + o] : mks[o]);
    };
    auto pay_at = [&](int p) {
      long long pos = (long long)mlen + p;
      pos = pos > a.s - 1 ? a.s - 1 : (pos < 0 ? 0 : pos);
      if (p < wp) {
        const int i = (int)(pos - k.base);
        return krow ? slot[i] ^ slot[a.off_ks + i] : slot[i];
      }
      return krow ? srow[pos] ^ krow[pos] : srow[pos];
    };
    const int best = first_match_warp(off, lo, hi, live, a.r, a.k, mlen,
                                      a.meta_max, plen, a.page, true, meta_at,
                                      pay_at);
    if (threadIdx.x == 0) a.verdict[k.b] = best;
  };

  auto consume = [&](Task k, const int* slot, auto&& wait) {
    if (k.page_slot < 0)
      meta_task(k, slot, wait);
    else
      tile_task(k, slot, wait);
  };
  ring_walk<kBulk>(g, t0, t1, load, plan, prologue, consume);
}

}  // namespace libra

// depth: the ring's slots a block (>= 2; the wrapper maps n_buffers = 0 to
// its default depth).
extern "C" int libra_fused_round(
    const void* stream, const void* ks, const void* txks,
    const void* meta_len, const void* total_len, const void* tables,
    void* pool, void* meta, void* out, const void* off, const void* lo,
    const void* hi, const void* live, const void* meta_ks, void* verdict,
    int b, int s, int p_ext, int page, int pps, int meta_max, int r, int k,
    int depth, void* cuda_stream) {
  if (depth < 2) return (int)cudaErrorInvalidValue;
  libra::FusedArgs a;
  a.stream = (const int*)stream;
  a.ks = (const int*)ks;
  a.txks = (const int*)txks;
  a.meta_len = (const int*)meta_len;
  a.total_len = (const int*)total_len;
  a.tables = (const int*)tables;
  a.pool = (int*)pool;
  a.meta = (int*)meta;
  a.out = (int*)out;
  a.off = (const int*)off;
  a.lo = (const int*)lo;
  a.hi = (const int*)hi;
  a.live = (const int*)live;
  a.meta_ks = (const int*)meta_ks;
  a.verdict = (int*)verdict;
  a.s = s;
  a.p_ext = p_ext;
  a.page = page;
  a.pps = pps;
  a.meta_max = meta_max;
  a.r = r;
  a.k = k;
  a.tpp = (page + libra::kTile - 1) / libra::kTile;
  a.row_tasks = 1 + pps * a.tpp;
  const long long tasks = (long long)b * a.row_tasks;
  a.depth = depth;
  const size_t smem = libra::ring_layout(&a);
  const bool bulk = s % 4 == 0 && page % 4 == 0 && meta_max % 4 == 0 &&
                    libra::aligned16({stream, ks, txks, pool, out, meta_ks});
  const cudaStream_t st = (cudaStream_t)cuda_stream;
  return bulk ? libra::launch_ring(libra::fused_round_kernel<true>, a,
                                   tasks, smem, st)
              : libra::launch_ring(libra::fused_round_kernel<false>, a,
                                   tasks, smem, st);
}
