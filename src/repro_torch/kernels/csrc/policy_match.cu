// L7 policy first match over one round's metadata block.
//
// Replaces the Pallas kernel `policy_match` (body `_policy_kernel`, shared
// condition body `_policy_rule_match`) of
// src/repro/kernels/selective_copy.py:265 (:233, :204); semantics are those
// of `policy_match_ref` in kernels/ref.py.
//
// One warp per message, four messages per 128-thread block. The warp's
// lanes take rules lane, lane + 32, ... and the first match is a warp
// min-reduction (first_match_warp in datapath.cuh). A message reads only
// the metadata tokens and first-page window positions its conditions name.
// Handles R == 0 (every row answers R), K > 32 (a lane loops over its
// rule's conditions), meta_len == 0, and a null live / keystream / payload.
//
// Bound on the H100: bytes, and small: the [B] verdicts, the condition
// table (read once per warp, from L2 after the first) and the few
// metadata tokens each message is tested on. The launch itself dominates
// at proxy round sizes; the design keeps it to one launch and no shared
// memory so the block count is the only thing that grows with B.
#include "datapath.cuh"

namespace libra {

constexpr int kPolicyThreads = 128;

__global__ void policy_match_kernel(
    const int* __restrict__ meta, const int* __restrict__ meta_len,
    const int* __restrict__ off, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ ks,
    const int* __restrict__ live, const int* __restrict__ payload,
    const int* __restrict__ payload_len, int* __restrict__ out, int b_rows,
    int m, int r, int k, int w) {
  const int b = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (b >= b_rows) return;  // warp-uniform: whole warps leave together
  const int64_t mrow = (int64_t)b * m;
  const bool has_payload = payload != nullptr;
  const long long plen = has_payload ? payload_len[b] : 0;
  auto meta_at = [&](int o) {
    const int v = meta[mrow + o];
    return ks != nullptr ? (v ^ ks[mrow + o]) : v;
  };
  auto pay_at = [&](int p) { return payload[(int64_t)b * w + p]; };
  const int best = first_match_warp(off, lo, hi, live, r, k, meta_len[b], m,
                                    plen, w, has_payload, meta_at, pay_at);
  if ((threadIdx.x & 31) == 0) out[b] = best;
}

}  // namespace libra

extern "C" int libra_policy_match(const void* meta, const void* meta_len,
                                  const void* off, const void* lo,
                                  const void* hi, const void* ks,
                                  const void* live, const void* payload,
                                  const void* payload_len, void* out, int b,
                                  int m, int r, int k, int w,
                                  void* cuda_stream) {
  const int per_block = libra::kPolicyThreads / 32;
  const int blocks = (b + per_block - 1) / per_block;
  libra::policy_match_kernel<<<blocks, libra::kPolicyThreads, 0,
                               (cudaStream_t)cuda_stream>>>(
      (const int*)meta, (const int*)meta_len, (const int*)off,
      (const int*)lo, (const int*)hi, (const int*)ks, (const int*)live,
      (const int*)payload, (const int*)payload_len, (int*)out, b, m, r, k, w);
  return (int)cudaGetLastError();
}
