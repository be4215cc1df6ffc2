// Shared pieces of the four batched-datapath kernels (sm_90a).
//
// Conventions for every kernel in this directory:
//   * all data is int32; every offset into a 2-D tensor is computed in
//     64 bits ((int64_t)row * width + col), so a [32769, 1024] pool or a
//     [B, S] stream never overflows an int index;
//   * a kernel launches on the caller's stream, allocates nothing and does
//     not synchronise; its C entry point returns cudaGetLastError() so the
//     Python wrapper can raise on a refused launch;
//   * optional operands arrive as null pointers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace libra {

constexpr int kPad = -1;          // padding condition slot (always holds)
constexpr int kPayloadBase = -2;  // off <= -2: payload position -off - 2
constexpr unsigned kFullMask = 0xffffffffu;

// Threads for a block that walks one page of `page` lanes: a multiple of
// 32, at most 256. Lanes are strided by blockDim.x, so each warp touches
// 32 neighbouring tokens per access (coalesced whatever the alignment).
inline int page_threads(int page) {
  int t = ((page + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

// Compact row b's metadata prefix: meta[b, i] = stream[b, min(i, S - 1)]
// for i < meta_len[b], else 0. Run by every thread of one block.
__device__ __forceinline__ void meta_row(const int* __restrict__ stream,
                                         int mlen, int* __restrict__ meta,
                                         int b, int s, int meta_max) {
  const int64_t row = (int64_t)b * s;
  for (int i = threadIdx.x; i < meta_max; i += blockDim.x) {
    const int src = i < s ? i : s - 1;
    meta[(int64_t)b * meta_max + i] = i < mlen ? stream[row + src] : 0;
  }
}

// One policy condition against one message. `meta_at(off)` returns the
// (decrypted) metadata token at 0 <= off < min(mlen, M); `pay_at(pos)`
// returns the plaintext first-page window token at 0 <= pos < min(plen, W).
template <class MetaAt, class PayAt>
__device__ __forceinline__ bool cond_holds(int off, int lo, int hi, int mlen,
                                           int m, long long plen, int w,
                                           bool has_payload, MetaAt meta_at,
                                           PayAt pay_at) {
  if (off == kPad) return true;
  if (off >= 0) {
    if (off >= mlen || off >= m) return false;
    const int v = meta_at(off);
    return v >= lo && v <= hi;
  }
  if (!has_payload) return false;
  const long long pos = kPayloadBase - (long long)off;  // no INT_MIN overflow
  if (pos >= plen || pos >= w) return false;
  const int v = pay_at((int)pos);
  return v >= lo && v <= hi;
}

// First matching rule of a dense [R, K] condition table for ONE message,
// evaluated by one whole warp: lanes take rules lane, lane + 32, ...; each
// chunk of 32 rules is reduced with __reduce_min_sync over
// (rule_ok ? r : R), and the scan stops at the first chunk with a match.
// Every lane of the warp must call it; all lanes return the same value.
// Returns R when no rule matches (and for R == 0).
template <class MetaAt, class PayAt>
__device__ __forceinline__ int first_match_warp(
    const int* __restrict__ off, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ live, int r, int k,
    int mlen, int m, long long plen, int w, bool has_payload, MetaAt meta_at,
    PayAt pay_at) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < r; base += 32) {
    const int rule = base + lane;
    bool ok = rule < r;
    if (ok && live != nullptr) ok = live[rule] > 0;
    for (int c = 0; ok && c < k; ++c) {
      const int64_t i = (int64_t)rule * k + c;
      ok = cond_holds(off[i], lo[i], hi[i], mlen, m, plen, w, has_payload,
                      meta_at, pay_at);
    }
    const int best = __reduce_min_sync(kFullMask, ok ? rule : r);
    if (best < r) return best;
  }
  return r;
}

}  // namespace libra
