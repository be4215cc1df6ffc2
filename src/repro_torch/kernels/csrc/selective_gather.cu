// TX plane: gather each message's anchored payload out of the pool.
//
// Replaces the Pallas kernel `selective_gather` (body `_gather_kernel`) of
// src/repro/kernels/selective_copy.py:364 (:343); semantics are those of
// `selective_gather_ref` in kernels/ref.py.
//
// Grid (B, pps): block (b, j) writes out[b, j*page:(j+1)*page] from pool
// row tables[b, j], zero where the entry is -1 or the payload position is
// at or past lengths[b], XORing the payload-relative TX keystream when one
// is given. The pool is only read. A row id past the pool reads the last
// row, as the plain version's clamped index does.
//
// Bound on the H100: bytes (read the valid pool lanes and keystream, write
// the [B, pps*page] output). When page % 4 == 0 every page starts on a
// 16-byte boundary in the pool, the keystream and the output, so a thread
// moves four tokens per int4 access; a ragged page edge falls back to
// one token per access.
#include "datapath.cuh"

namespace libra {

__global__ void selective_gather_kernel(
    const int* __restrict__ pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, const int* __restrict__ ks,
    int* __restrict__ out, int p_ext, int page, int pps) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int pid = tables[(int64_t)b * pps + j];
  const bool has = pid >= 0;
  const int rd = !has ? 0 : (pid >= p_ext ? p_ext - 1 : pid);
  const int* __restrict__ src = pool + (int64_t)rd * page;
  const long long ln = lengths[b];
  const long long rel0 = (long long)j * page;
  const int64_t obase = ((int64_t)b * pps + j) * page;
  if ((page & 3) == 0) {
    for (int l = threadIdx.x * 4; l < page; l += blockDim.x * 4) {
      int4 v = make_int4(0, 0, 0, 0);
      if (has && rel0 + l + 3 < ln) {
        v = *reinterpret_cast<const int4*>(src + l);
        if (ks != nullptr) {
          const int4 k = *reinterpret_cast<const int4*>(ks + obase + l);
          v.x ^= k.x; v.y ^= k.y; v.z ^= k.z; v.w ^= k.w;
        }
      } else if (has) {
        int t[4] = {0, 0, 0, 0};
        for (int q = 0; q < 4; ++q) {
          if (rel0 + l + q < ln) {
            t[q] = src[l + q];
            if (ks != nullptr) t[q] ^= ks[obase + l + q];
          }
        }
        v = make_int4(t[0], t[1], t[2], t[3]);
      }
      *reinterpret_cast<int4*>(out + obase + l) = v;
    }
    return;
  }
  for (int lane = threadIdx.x; lane < page; lane += blockDim.x) {
    int v = 0;
    if (has && rel0 + lane < ln) {
      v = src[lane];
      if (ks != nullptr) v ^= ks[obase + lane];
    }
    out[obase + lane] = v;
  }
}

}  // namespace libra

extern "C" int libra_selective_gather(const void* pool, const void* tables,
                                      const void* lengths, const void* ks,
                                      void* out, int b, int p_ext, int page,
                                      int pps, void* cuda_stream) {
  const dim3 grid(b, pps);
  const int threads = (page & 3) == 0 ? libra::page_threads((page + 3) / 4)
                                      : libra::page_threads(page);
  libra::selective_gather_kernel<<<grid, threads, 0,
                                   (cudaStream_t)cuda_stream>>>(
      (const int*)pool, (const int*)tables, (const int*)lengths,
      (const int*)ks, (int*)out, p_ext, page, pps);
  return (int)cudaGetLastError();
}
