// Blockwise online-softmax attention for prefill (sm_90a, float32).
//
// Replaces the Pallas kernel `flash_attention` (body `_flash_kernel`) of
// src/repro/kernels/flash_attention.py:82 (:30), forward only (the TPU
// kernel has no backward); semantics are those of `flash_attention_ref` in
// kernels/ref.py: q [B, Hq, Sq, hd] over k/v [B, Hkv, Skv, hd] at the
// implicit positions arange, query head h reading KV head h / (Hq / Hkv),
// with causal and sliding-window masks -> out [B, Hq, Sq, hd].
//
// Grid (query tile, query head, batch row); 256 threads. A block stages its
// kBQ x hd query tile (pre-scaled) once, then walks the kBK-key tiles of
// its KV head: K (transposed) and V go to shared memory, each thread
// computes a 4 x 4 block of scores from float4 reads, the 16 threads that
// share a query row reduce its max and sum with warp shuffles, the weights
// go back to shared memory (transposed), and each thread accumulates a
// 4-row x hd/16-column block of the output in registers. The running
// (m, l) of its four rows lives in registers of every thread of the row.
//
// Tiles wholly above the diagonal (causal) or wholly outside the window are
// skipped, as the Pallas kernel skips them. Unlike the Pallas kernel, which
// asserts Sq % block_q == 0, the tails are masked here: query rows past Sq
// compute on zeros and are not written, keys past Skv are masked. Prefill
// pads a sequence only to a multiple of the page size. A masked score is
// -1e30 and its weight is set to 0 after the exponential; the output is
// acc / max(l, 1e-30). A row with no valid key at all (only possible with
// a window and Sq > Skv) gives 0, as the Pallas kernel does; the jnp
// reference gives the mean of V there.
//
// Bound on the H100: operations. Causal prefill does 4 x Sq^2 / 2 x hd FLOP
// per (batch row, query head) on Sq x hd x 4 B of q and out, about 32
// FLOP per byte at Sq = 1024, hd = 128, above the card's float32
// FLOP-to-byte ratio (67 TFLOP/s over 3.35 TB/s = 20). The design keeps
// the scores on chip and reuses each staged K/V tile across 64 query rows;
// it uses plain float32 FMA (no tensor cores, no TMA, no overlap of the
// next tile's loads with this tile's math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace libra {

constexpr float kFlashNegInf = -1e30f;
constexpr int kFlashThreads = 256;  // 16 x 16: tx = key / column group
constexpr int kBQ = 64;             // query rows per block (4 per thread)
constexpr int kBK = 64;             // keys per tile (4 per thread)
constexpr int kLD = kBQ + 4;        // padded row of a transposed tile

template <int HD>
constexpr size_t flash_smem_bytes() {
  // qs [HD][kLD], ks [HD][kLD], vs [kBK][HD], ps [kBK][kLD]
  return sizeof(float) * ((size_t)2 * HD * kLD + (size_t)kBK * HD +
                          (size_t)kBK * kLD);
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int hq, int hkv,
    int sq, int skv, int causal, int window) {
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  constexpr int CN = HD / 16;  // output columns per thread: tx + 16 * c
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // q tile * scale, transposed [HD][kLD]
  float* ks = qs + HD * kLD;    // K tile, transposed [HD][kLD]
  float* vs = ks + HD * kLD;    // V tile [kBK][HD]
  float* ps = vs + kBK * HD;    // weights, transposed [kBK][kLD]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float scale = 1.0f / sqrtf((float)HD);
  const int64_t qbase = ((int64_t)bi * hq + h) * sq * HD;
  const int64_t kbase = ((int64_t)bi * hkv + hk) * skv * HD;

  for (int e = tid; e < kBQ * HD; e += kFlashThreads) {
    const int r = e / HD, d = e - r * HD;
    const int qi = q0 + r;
    qs[d * kLD + r] = qi < sq ? q[qbase + (int64_t)qi * HD + d] * scale : 0.f;
  }
  float acc[4][CN];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kFlashNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (skv + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    if (window > 0 && q0 - (k0 + kBK - 1) >= window) continue;
    __syncthreads();  // q staged; the previous tile's readers are done
    for (int e = tid; e < kBK * HD; e += kFlashThreads) {
      const int c = e / HD, d = e - c * HD;
      const int kj = k0 + c;
      const int64_t off = kbase + (int64_t)kj * HD + d;
      ks[d * kLD + c] = kj < skv ? k[off] : 0.f;
      vs[c * HD + d] = kj < skv ? v[off] : 0.f;
    }
    __syncthreads();

    // scores of rows ty*4 + i against keys tx*4 + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[d * kLD + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ks[d * kLD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // online softmax: a query row's 64 scores sit in the 16 lanes of one
    // half-warp (same ty), so xor-shuffles over offsets 8..1 reduce it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      bool ok[4];
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        ok[j] = kj < skv && (!causal || qi >= kj) &&
                (window <= 0 || qi - kj < window);
        if (!ok[j]) s[i][j] = kFlashNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - mx) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[i] - mx);
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&ps[(tx * 4 + j) * kLD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc[rows ty*4 + i][columns tx + 16 c] += P V
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&ps[c * kLD + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int cc = 0; cc < CN; ++cc) {
        const float vv = vs[c * HD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* o = out + qbase + (int64_t)qi * HD;
#pragma unroll
    for (int c = 0; c < CN; ++c) o[tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int HD>
int launch_flash(const float* q, const float* k, const float* v, float* out,
                 int b, int hq, int hkv, int sq, int skv, int causal,
                 int window, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HD>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_attention_kernel<HD><<<grid, kFlashThreads, smem, stream>>>(
      q, k, v, out, hq, hkv, sq, skv, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace libra

extern "C" int libra_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int hq,
                                     int hkv, int sq, int skv, int hd,
                                     int causal, int window,
                                     void* cuda_stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  switch (hd) {
    case 16:
      return libra::launch_flash<16>(qf, kf, vf, of, b, hq, hkv, sq, skv,
                                     causal, window, st);
    case 32:
      return libra::launch_flash<32>(qf, kf, vf, of, b, hq, hkv, sq, skv,
                                     causal, window, st);
    case 64:
      return libra::launch_flash<64>(qf, kf, vf, of, b, hq, hkv, sq, skv,
                                     causal, window, st);
    case 96:
      return libra::launch_flash<96>(qf, kf, vf, of, b, hq, hkv, sq, skv,
                                     causal, window, st);
    case 128:
      return libra::launch_flash<128>(qf, kf, vf, of, b, hq, hkv, sq, skv,
                                      causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
