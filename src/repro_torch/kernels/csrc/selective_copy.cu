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
// names a pool row; -1 entries write nothing, and no pool word outside a
// message's payload is written. The scratch row is never written (the
// Pallas kernel passed it through; here nothing touches it).
//
// Precondition: a round's page ids are distinct across messages (the
// allocator hands each page to one message), so blocks write disjoint rows
// and may run in any order. The stream position is read directly (masked
// < S), as the plain version does; the Pallas window clamp is not carried.
//
// Bound on the H100: bytes, 1.27 us at the deployment (a 4.25 MB copy),
// under a floor of about 5 us for a launch that does nothing. Above the
// floor the time was a chain of dependent global round trips (about 0.6 us
// each), not bandwidth, so the kernel keeps the chain at two:
//   1. the parameters: a payload block's threads issue meta_len[b],
//      total_len[b] and tables[b, j - 1] together, before any branch
//      depends on one of them; the metadata block loads its row without
//      waiting for meta_len (meta_row);
//   2. the data: a thread owns 16-byte groups of its page (256 threads x 4
//      tokens = one 1024-token page; a larger page gives a thread 2 or 4
//      groups a pass) and issues every stream and keystream load of the
//      pass, one a word and predicated on the word being payload, before
//      its first store. A group whose four words are all payload stores
//      as one int4 when pool rows are 16-byte aligned (page % 4 == 0),
//      otherwise word by word.
// Loading aligned int4 covers and shifting the words across lanes
// (__shfl_down_sync) measured slower than one load a word at the
// deployment, and fewer, wider blocks (4 or 16 pages a block) slower than
// one page a block (PERF.md, section 6).
#include "datapath.cuh"

namespace libra {

constexpr int kCopyThreads = 256;

// NG: 16-byte groups a thread takes per pass (the page's groups over the
// block's threads: 1, 2 or 4). pool_vec: page % 4 == 0 and the pool
// 16-byte aligned.
template <int NG>
__global__ void __launch_bounds__(kCopyThreads) selective_copy_kernel(
    const int* __restrict__ stream, const int* __restrict__ ks,
    const int* __restrict__ meta_len, const int* __restrict__ total_len,
    const int* __restrict__ tables, int* __restrict__ pool,
    int* __restrict__ meta, int s, int p_ext, int page, int pps,
    int meta_max, bool pool_vec) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  if (j == 0) {
    meta_row(stream, __ldg(meta_len + b), meta, b, s, meta_max);
    return;
  }
  const int jj = j - 1;
  // round trip 1: the three parameters, independent loads
  const int mlen = __ldg(meta_len + b);
  const int tlen = __ldg(total_len + b);
  const int pid = __ldg(tables + (int64_t)b * pps + jj);
  if (pid < 0 || pid >= p_ext) return;  // block-uniform
  const long long plen = (long long)tlen - mlen;
  const long long rel0 = (long long)jj * page;
  const long long q = mlen + rel0;  // stream position of the page's token 0
  const int64_t row = (int64_t)b * s;
  int* __restrict__ dst = pool + (int64_t)pid * page;
  const bool has_ks = ks != nullptr;
  const int groups = (page + 3) >> 2;
  for (int first = 0; first < groups; first += NG * blockDim.x) {
    int t[NG][4], k[NG][4];
    bool ok[NG][4];
    // round trip 2: every load of the pass before any store
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int l0 = 4 * (first + g * blockDim.x + threadIdx.x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long pos = q + l0 + i;
        ok[g][i] = l0 + i < page && rel0 + l0 + i < plen && pos >= 0 &&
                   pos < s;
        t[g][i] = ok[g][i] ? __ldg(stream + row + pos) : 0;
        k[g][i] = ok[g][i] && has_ks ? __ldg(ks + row + pos) : 0;
      }
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int l0 = 4 * (first + g * blockDim.x + threadIdx.x);
      if (l0 >= page) continue;
      if (pool_vec && ok[g][0] && ok[g][1] && ok[g][2] && ok[g][3]) {
        *reinterpret_cast<int4*>(dst + l0) =
            make_int4(t[g][0] ^ k[g][0], t[g][1] ^ k[g][1],
                      t[g][2] ^ k[g][2], t[g][3] ^ k[g][3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (ok[g][i]) dst[l0 + i] = t[g][i] ^ k[g][i];
      }
    }
  }
}

template <int NG>
int launch_copy(const int* stream, const int* ks, const int* meta_len,
                const int* total_len, const int* tables, int* pool,
                int* meta, int b, int s, int p_ext, int page, int pps,
                int meta_max, int threads, cudaStream_t cuda_stream) {
  const dim3 grid(b, 1 + pps);
  selective_copy_kernel<NG><<<grid, threads, 0, cuda_stream>>>(
      stream, ks, meta_len, total_len, tables, pool, meta, s, p_ext, page,
      pps, meta_max, (page & 3) == 0 && aligned16({pool}));
  return (int)cudaGetLastError();
}

}  // namespace libra

extern "C" int libra_selective_copy(const void* stream, const void* ks,
                                    const void* meta_len,
                                    const void* total_len, const void* tables,
                                    void* pool, void* meta, int b, int s,
                                    int p_ext, int page, int pps, int meta_max,
                                    void* cuda_stream) {
  const int groups = (page + 3) / 4;
  const int threads = libra::page_threads(groups);  // <= kCopyThreads
  const int per = (groups + threads - 1) / threads;
  auto* launch = per == 1   ? libra::launch_copy<1>
                 : per == 2 ? libra::launch_copy<2>
                            : libra::launch_copy<4>;
  return launch((const int*)stream, (const int*)ks, (const int*)meta_len,
                (const int*)total_len, (const int*)tables, (int*)pool,
                (int*)meta, b, s, p_ext, page, pps, meta_max, threads,
                (cudaStream_t)cuda_stream);
}

extern "C" const char* libra_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
