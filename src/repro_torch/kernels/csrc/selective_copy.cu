// RX plane: selective copy of the metadata prefix + in-place payload anchor.
//
// Replaces the Pallas kernel `_selective_copy_impl` (body `_fused_kernel`)
// of src/repro/kernels/selective_copy.py:94 (:57); semantics are those of
// `selective_copy_ref` / `selective_copy_crypto_ref` in kernels/ref.py.
//
// Grid (B, 1 + pps): block (b, 0) compacts row b's metadata into
// meta[b, :meta_max]; block (b, j >= 1) anchors payload page j - 1 of row b
// into pool[tables[b, j - 1]], XORing the RX keystream when one is given.
// Payload token rel (stream position meta_len + rel) is written iff
// rel < total_len - meta_len, 0 <= meta_len + rel < S and the table entry
// names a pool row; -1 entries write nothing. The scratch row is never
// written (the Pallas kernel passed it through; here nothing touches it).
//
// Precondition: a round's page ids are distinct across messages (the
// allocator hands each page to one message), so blocks write disjoint rows
// and may run in any order. The stream position is read directly (masked
// < S), as the plain version does; the Pallas window clamp is not carried.
//
// Bound on the H100: bytes. The work is a copy: read the payload lanes of
// the stream (and keystream), write the same number of pool tokens, plus
// the [B, meta_max] metadata. Each warp touches 32 neighbouring tokens per
// access, so reads and writes are coalesced whatever meta_len's alignment;
// blocks that own no page return at once.
#include "datapath.cuh"

namespace libra {

__global__ void selective_copy_kernel(
    const int* __restrict__ stream, const int* __restrict__ ks,
    const int* __restrict__ meta_len, const int* __restrict__ total_len,
    const int* __restrict__ tables, int* __restrict__ pool,
    int* __restrict__ meta, int s, int p_ext, int page, int pps,
    int meta_max) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int mlen = meta_len[b];
  if (j == 0) {
    meta_row(stream, mlen, meta, b, s, meta_max);
    return;
  }
  const int jj = j - 1;
  const int pid = tables[(int64_t)b * pps + jj];
  if (pid < 0 || pid >= p_ext) return;
  const long long plen = (long long)total_len[b] - mlen;
  const int64_t row = (int64_t)b * s;
  int* __restrict__ dst = pool + (int64_t)pid * page;
  const long long rel0 = (long long)jj * page;
  for (int lane = threadIdx.x; lane < page; lane += blockDim.x) {
    const long long rel = rel0 + lane;
    const long long pos = mlen + rel;
    if (rel >= plen || pos < 0 || pos >= s) continue;
    const int tok = stream[row + pos];
    dst[lane] = ks != nullptr ? (tok ^ ks[row + pos]) : tok;
  }
}

}  // namespace libra

extern "C" int libra_selective_copy(const void* stream, const void* ks,
                                    const void* meta_len,
                                    const void* total_len, const void* tables,
                                    void* pool, void* meta, int b, int s,
                                    int p_ext, int page, int pps, int meta_max,
                                    void* cuda_stream) {
  const dim3 grid(b, 1 + pps);
  libra::selective_copy_kernel<<<grid, libra::page_threads(page), 0,
                                 (cudaStream_t)cuda_stream>>>(
      (const int*)stream, (const int*)ks, (const int*)meta_len,
      (const int*)total_len, (const int*)tables, (int*)pool, (int*)meta, s,
      p_ext, page, pps, meta_max);
  return (int)cudaGetLastError();
}

extern "C" const char* libra_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
