// L7 policy first match over one round's metadata block.
//
// Replaces the Pallas kernel `policy_match` (body `_policy_kernel`, shared
// condition body `_policy_rule_match`) of
// src/repro/kernels/selective_copy.py:265 (:233, :204); semantics are those
// of `policy_match_ref` in kernels/ref.py.
//
// One warp per message, four messages per 128-thread block. Handles
// R == 0 (every row answers R), K > 32, R > 32, meta_len == 0, and a null
// live / keystream / payload.
//
// Bound on the H100: bytes, and tiny (the [B] verdicts, the condition
// table and the few tokens the conditions read: 0.0003 us at the
// deployment), under a floor of about 5 us for a launch that does
// nothing. What lies above the floor is a chain of dependent global round
// trips: evaluated condition by condition (live, then the condition, then
// the token it names, then the next condition) a rule costs 2K + 1 of
// them. The TPU kernel loads the message's whole metadata row and payload
// window and evaluates every condition at once; so does this one, in one
// round trip:
//   * the warp copies the message's metadata row, its keystream row and
//     its payload window row into its slice of shared memory (cp.async,
//     16 bytes a copy where aligned), and while those fly loads meta_len,
//     payload_len, live and the first condition entries of its lanes
//     (lane i takes the flattened (rule, cond) entries i, i + 32, ... of
//     a chunk of 32 rules);
//   * a condition then reads its token from shared memory; a rule holds
//     when it is live and none of its K entries fails (a failing entry
//     sets its rule's flag in shared memory, so K is free); the first
//     holding rule is __ffs of the chunk's ballot, chunk by chunk.
// A row too wide for the shared-memory budget is read from global memory
// at the condition instead (the chain again, for that row only). Measured
// at the deployment (PERF.md, section 6): the window gathered at the
// condition instead of staged, staging through registers or by TMA bulk
// copies, the table loads issued before the copies, and 1 or 2 warps a
// block (the staged bytes over more SMs) were each no faster.
#include "datapath.cuh"

namespace libra {

constexpr int kPolicyThreads = 128;
constexpr int kPolicyWarps = kPolicyThreads / 32;
// a block's staged rows: dynamic shared memory that needs no opt-in
constexpr int kStageBytes = 48 * 1024;
// condition entries a lane loads before it evaluates them
constexpr int kBatch = 4;

__device__ __forceinline__ void copy16(int* dst, const int* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Copy n words of src into dst, the warp's lanes sharing the copies.
__device__ __forceinline__ void stage_row(int* dst, const int* src, int n,
                                          bool vec, int lane) {
  if (vec) {
    for (int i = 4 * lane; i < n; i += 128) copy16(dst + i, src + i);
  } else {
    for (int i = lane; i < n; i += 32) copy4(dst + i, src + i);
  }
}

// Shared-memory words of one warp: 32 rule flags, then the staged rows.
struct WarpLayout {
  int meta, ks, pay, words;  // offsets (-1: not staged) and the total
};

__host__ __device__ inline WarpLayout warp_layout(int m, int w, bool has_ks,
                                                  bool has_payload,
                                                  bool stage_meta,
                                                  bool stage_pay) {
  WarpLayout l{-1, -1, -1, 32};
  if (stage_meta) {
    l.meta = l.words;
    l.words += up4(m);
    if (has_ks) {
      l.ks = l.words;
      l.words += up4(m);
    }
  }
  if (stage_pay && has_payload) {
    l.pay = l.words;
    l.words += up4(w);
  }
  return l;
}

__global__ void __launch_bounds__(kPolicyThreads) policy_match_kernel(
    const int* __restrict__ meta, const int* __restrict__ meta_len,
    const int* __restrict__ off, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ ks,
    const int* __restrict__ live, const int* __restrict__ payload,
    const int* __restrict__ payload_len, int* __restrict__ out, int b_rows,
    int m, int r, int k, int w, WarpLayout lay, bool meta_vec,
    bool pay_vec) {
  extern __shared__ __align__(16) int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kPolicyWarps + warp;
  if (b >= b_rows) return;  // warp-uniform: whole warps leave together
  int* const mine = smem + warp * lay.words;
  int* const flag = mine;  // the current chunk's rule flags (1: fails)
  const int64_t mrow = (int64_t)b * m;
  const int64_t prow = (int64_t)b * w;
  const bool has_ks = ks != nullptr;
  const bool has_payload = payload != nullptr;
  // one round trip: the rows into shared memory, the lengths, the first
  // chunk's live flags and entries (below) into registers
  if (lay.meta >= 0)
    stage_row(mine + lay.meta, meta + mrow, m, meta_vec, lane);
  if (lay.ks >= 0) stage_row(mine + lay.ks, ks + mrow, m, meta_vec, lane);
  if (lay.pay >= 0)
    stage_row(mine + lay.pay, payload + prow, w, pay_vec, lane);
  const int mlen = __ldg(meta_len + b);
  const long long plen = has_payload ? __ldg(payload_len + b) : 0;
  auto meta_at = [&](int o) {
    const int v = lay.meta >= 0 ? mine[lay.meta + o] : meta[mrow + o];
    if (!has_ks) return v;
    return v ^ (lay.ks >= 0 ? mine[lay.ks + o] : ks[mrow + o]);
  };
  auto pay_at = [&](int p) {
    return lay.pay >= 0 ? mine[lay.pay + p] : payload[prow + p];
  };
  int best = r;
  for (int base = 0; base < r; base += 32) {
    const int rule = base + lane;
    const bool alive =
        rule < r && (live == nullptr || __ldg(live + rule) > 0);
    const int e1 = (r - base < 32 ? r : base + 32) * k;
    // a chunk's entries, kBatch a lane at a time: all loaded, then
    // evaluated (the first batch's loads fly with the staged rows); one
    // pass at least, which sets the flags and waits for the copies
    int e0 = base * k;
    do {
      int o[kBatch], l[kBatch], h[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + 32 * u + lane;
        o[u] = e < e1 ? __ldg(off + e) : kPad;
        l[u] = e < e1 ? __ldg(lo + e) : 0;
        h[u] = e < e1 ? __ldg(hi + e) : 0;
      }
      // a lane's own flag: the last chunk's ballot has read it
      if (e0 == base * k) flag[lane] = alive ? 0 : 1;
      copies_wait();
      __syncwarp();  // every lane's copies and flags are visible
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + 32 * u + lane;
        if (e < e1 && !cond_holds(o[u], l[u], h[u], mlen, m, plen, w,
                                  has_payload, meta_at, pay_at))
          flag[e / k - base] = 1;
      }
      e0 += 32 * kBatch;
    } while (e0 < e1);
    __syncwarp();
    const unsigned hold = __ballot_sync(kFullMask, flag[lane] == 0);
    if (hold != 0) {
      best = base + __ffs(hold) - 1;
      break;
    }
  }
  copies_wait();  // none outlives the warp (with R == 0 none was awaited)
  if (lane == 0) out[b] = best;
}

}  // namespace libra

extern "C" int libra_policy_match(const void* meta, const void* meta_len,
                                  const void* off, const void* lo,
                                  const void* hi, const void* ks,
                                  const void* live, const void* payload,
                                  const void* payload_len, void* out, int b,
                                  int m, int r, int k, int w,
                                  void* cuda_stream) {
  using namespace libra;
  const bool has_ks = ks != nullptr, has_payload = payload != nullptr;
  // stage the metadata (and keystream) rows, then the payload window, each
  // where the block's rows fit kStageBytes
  auto fits = [&](WarpLayout l) {
    return (size_t)kPolicyWarps * l.words * 4 <= (size_t)kStageBytes;
  };
  const bool stage_meta =
      fits(warp_layout(m, w, has_ks, has_payload, true, false));
  const bool stage_pay =
      fits(warp_layout(m, w, has_ks, has_payload, stage_meta, true));
  const WarpLayout lay =
      warp_layout(m, w, has_ks, has_payload, stage_meta, stage_pay);
  const int blocks = (b + kPolicyWarps - 1) / kPolicyWarps;
  policy_match_kernel<<<blocks, kPolicyThreads,
                        (size_t)kPolicyWarps * lay.words * 4,
                        (cudaStream_t)cuda_stream>>>(
      (const int*)meta, (const int*)meta_len, (const int*)off,
      (const int*)lo, (const int*)hi, (const int*)ks, (const int*)live,
      (const int*)payload, (const int*)payload_len, (int*)out, b, m, r, k, w,
      lay, (m & 3) == 0 && aligned16({meta, ks}),
      (w & 3) == 0 && aligned16({payload}));
  return (int)cudaGetLastError();
}
