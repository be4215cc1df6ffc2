// One scheduling round in one launch: anchor + RX decrypt + policy verdict
// + egress gather (+ TX encrypt).
//
// Replaces the Pallas kernel `_fused_round_impl` (body
// `_fused_round_kernel`) of src/repro/kernels/selective_copy.py:554
// (:417); semantics are those of `fused_round_ref` in kernels/ref.py.
//
// Grid (B, 1 + pps), with no dependency between blocks:
//   * block (b, 0) compacts row b's metadata and, when a policy table is
//     given, one warp computes the verdict. It reads the metadata tokens
//     straight from the stream (XOR meta_ks) and the first-page window from
//     stream ^ keystream at min(meta_len + p, S - 1), never from the pool,
//     so it does not wait for the anchoring blocks.
//   * block (b, j >= 1) anchors payload page j - 1 of row b (XOR the RX
//     keystream) and writes the same tokens, XOR the TX keystream, to
//     out[b, (j-1)*page : j*page] while they are still in registers. A lane
//     is live iff the table entry is >= 0 and rel < total_len - meta_len;
//     a live lane whose stream position falls outside [0, S) is not
//     anchored and gathers the pool's current token, as the plain version
//     (gather after scatter) does. Dead lanes of the output are zero.
// The Pallas VMEM staging ring (n_buffers) has no counterpart here.
//
// Precondition: a round's page ids are distinct across messages, so
// anchoring blocks write disjoint rows and a block's gather reads only the
// row it wrote. The scratch row is never written.
//
// Bound on the H100: bytes. Read the payload lanes of the stream (and RX
// keystream, TX keystream), write them once to the pool and once to the
// output, plus the metadata block; the policy table and verdicts are
// noise. Warps touch 32 neighbouring tokens per access (coalesced at any
// meta_len); the fused launch saves the second pass over the pool that the
// separate gather kernel pays.
#include "datapath.cuh"

namespace libra {

__global__ void fused_round_kernel(
    const int* __restrict__ stream, const int* __restrict__ ks,
    const int* __restrict__ txks, const int* __restrict__ meta_len,
    const int* __restrict__ total_len, const int* __restrict__ tables,
    int* __restrict__ pool, int* __restrict__ meta, int* __restrict__ out,
    const int* __restrict__ off, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ live,
    const int* __restrict__ meta_ks, int* __restrict__ verdict, int s,
    int p_ext, int page, int pps, int meta_max, int r, int k) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int mlen = meta_len[b];
  const long long plen = (long long)total_len[b] - mlen;
  const int64_t row = (int64_t)b * s;
  if (j == 0) {
    meta_row(stream, mlen, meta, b, s, meta_max);
    if (verdict != nullptr && threadIdx.x < 32) {
      auto meta_at = [&](int o) {
        const int v = stream[row + (o < s ? o : s - 1)];
        return meta_ks != nullptr ? (v ^ meta_ks[(int64_t)b * meta_max + o])
                                  : v;
      };
      auto pay_at = [&](int p) {
        long long pos = (long long)mlen + p;
        pos = pos > s - 1 ? s - 1 : (pos < 0 ? 0 : pos);
        const int v = stream[row + pos];
        return ks != nullptr ? (v ^ ks[row + pos]) : v;
      };
      const int best = first_match_warp(off, lo, hi, live, r, k, mlen,
                                        meta_max, plen, page, true, meta_at,
                                        pay_at);
      if (threadIdx.x == 0) verdict[b] = best;
    }
    return;
  }
  const int jj = j - 1;
  const int pid = tables[(int64_t)b * pps + jj];
  const bool has = pid >= 0;
  const bool writable = has && pid < p_ext;
  const int rd = !has ? 0 : (pid >= p_ext ? p_ext - 1 : pid);
  int* __restrict__ dst = pool + (int64_t)rd * page;
  const long long rel0 = (long long)jj * page;
  const int64_t obase = ((int64_t)b * pps + jj) * page;
  for (int lane = threadIdx.x; lane < page; lane += blockDim.x) {
    const long long rel = rel0 + lane;
    int o = 0;
    if (has && rel < plen) {
      const long long pos = mlen + rel;
      int tok;
      if (writable && pos >= 0 && pos < s) {
        tok = stream[row + pos];
        if (ks != nullptr) tok ^= ks[row + pos];
        dst[lane] = tok;
      } else {
        tok = dst[lane];
      }
      o = txks != nullptr ? (tok ^ txks[obase + lane]) : tok;
    }
    out[obase + lane] = o;
  }
}

}  // namespace libra

extern "C" int libra_fused_round(
    const void* stream, const void* ks, const void* txks,
    const void* meta_len, const void* total_len, const void* tables,
    void* pool, void* meta, void* out, const void* off, const void* lo,
    const void* hi, const void* live, const void* meta_ks, void* verdict,
    int b, int s, int p_ext, int page, int pps, int meta_max, int r, int k,
    void* cuda_stream) {
  const dim3 grid(b, 1 + pps);
  libra::fused_round_kernel<<<grid, libra::page_threads(page), 0,
                              (cudaStream_t)cuda_stream>>>(
      (const int*)stream, (const int*)ks, (const int*)txks,
      (const int*)meta_len, (const int*)total_len, (const int*)tables,
      (int*)pool, (int*)meta, (int*)out, (const int*)off, (const int*)lo,
      (const int*)hi, (const int*)live, (const int*)meta_ks, (int*)verdict,
      s, p_ext, page, pps, meta_max, r, k);
  return (int)cudaGetLastError();
}
