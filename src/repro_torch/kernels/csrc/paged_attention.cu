// Paged decode attention over a block-table KV pool (sm_90a, float32).
//
// Replaces the Pallas kernel `paged_attention` (body `_paged_kernel`) of
// src/repro/kernels/paged_attention.py:84 (:28); semantics are those of
// `paged_attention_ref` in kernels/ref.py: the partial softmax statistics
// (acc [B, Hq, hd], m [B, Hq], l [B, Hq]) of q [B, Hq, hd] over the pages
// tables [B, pps] names in pool [P, page, 2, Hkv, hd].
//
// One block per (batch row, KV head) serves that head's G = Hq / Hkv query
// heads (in blocks of up to kMaxG), so each K/V row is read from device
// memory once per group. Where the TPU grid walks the table slots in order
// with one running (m, l, acc), the block's kWarps warps each walk every
// kWarps-th slot with running (m, l, acc) of their own in registers: a
// lane holds hd / 32 of each query head's q and acc, loads kChunk keys' K
// and V rows at once (so a warp keeps 2 x kChunk x hd / 32 loads in
// flight), takes each score with a warp all-reduce, and rescales once per
// chunk. The warps' partials are combined at the end through shared
// memory, with the same rescaling as a flash-decode combine across chips.
//
// Masking follows the reference: slots with pid < 0 are skipped, and a key
// at pos = page_pos + t is valid when pos <= seq_len and, for window > 0,
// seq_len - pos < window. Only valid keys are read and scored: an invalid
// key's weight is 0 in the reference (set after the exponential) and its
// -1e30 score never raises the max, so skipping it gives the same (m, l,
// acc). A row with no valid key returns m = -1e30, l = 0, acc = 0: no NaN.
// (An idle engine slot has its parking page and seq_len 0: one valid key.)
//
// Bound on the H100: bytes. A decode step reads every valid key's K and V
// once (ctx x 2 x Hkv x hd x 4 B per row) and does 4 x Hq x hd FLOP per
// key, far below the float32 rate. The design reads each K/V row once per
// group and keeps the scores in registers; with B x Hkv blocks (64 at the
// serving shape) only about half the SMs stream, and a chunk's loads are
// not overlapped with the previous chunk's math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace libra {

constexpr float kAttnNegInf = -1e30f;
constexpr int kWarps = 8;   // warps per block, each on every kWarps-th slot
constexpr int kMaxG = 8;    // query heads per block
constexpr int kChunk = 8;   // keys loaded at once by a warp

template <int HD>
__global__ void __launch_bounds__(kWarps * 32) paged_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ pool,
    const int* __restrict__ tables, const int* __restrict__ page_pos,
    const int* __restrict__ seq_lens, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int hq, int hkv,
    int page, int pps, int window) {
  constexpr int VEC = (HD + 31) / 32;  // elements of a row per lane
  __shared__ float s_m[kWarps][kMaxG], s_l[kWarps][kMaxG];
  __shared__ float s_acc[kWarps][kMaxG][HD];
  const int gn = hq / hkv;
  const int n_gblk = (gn + kMaxG - 1) / kMaxG;
  const int h = blockIdx.x / n_gblk, g0 = (blockIdx.x % n_gblk) * kMaxG;
  const int bi = blockIdx.y;
  const int gcount = min(kMaxG, gn - g0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float scale = 1.0f / sqrtf((float)HD);
  const int64_t qrow = ((int64_t)bi * hq + (int64_t)h * gn + g0) * HD;

  float qv[kMaxG][VEC], acc[kMaxG][VEC], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kAttnNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int d = lane + 32 * v;
      qv[g][v] = (g < gcount && d < HD) ? q[qrow + g * HD + d] * scale : 0.f;
      acc[g][v] = 0.f;
    }
  }
  const long long slen = seq_lens[bi];
  const int64_t tok = 2LL * hkv * HD;  // one key position of a page
  for (int j = warp; j < pps; j += kWarps) {
    const int pid = tables[(int64_t)bi * pps + j];
    if (pid < 0) continue;  // uniform over the warp
    const long long base = page_pos[(int64_t)bi * pps + j];
    long long hi = slen - base + 1;  // valid t: lo <= t < hi
    if (hi > page) hi = page;
    long long lo = 0;
    if (window > 0 && slen - window + 1 - base > 0) lo = slen - window + 1 - base;
    if (hi <= lo) continue;
    const float* kp = pool + (int64_t)pid * page * tok + (int64_t)h * HD;
    for (int t0 = (int)lo; t0 < (int)hi; t0 += kChunk) {
      const int n = min(kChunk, (int)hi - t0);
      float kr[kChunk][VEC], vr[kChunk][VEC];
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const int d = lane + 32 * v;
          const bool in = c < n && d < HD;
          const int64_t off = (int64_t)(t0 + c) * tok + d;
          kr[c][v] = in ? kp[off] : 0.f;
          vr[c][v] = in ? kp[off + (int64_t)hkv * HD] : 0.f;
        }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= gcount) break;  // uniform over the block
        float s[kChunk];
        float mx = m[g];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          float part = 0.f;
#pragma unroll
          for (int v = 0; v < VEC; ++v) part = fmaf(qv[g][v], kr[c][v], part);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          s[c] = part;
          if (c < n) mx = fmaxf(mx, part);
        }
        const float alpha = expf(m[g] - mx);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          s[c] = c < n ? expf(s[c] - mx) : 0.f;
          sum += s[c];
        }
        l[g] = l[g] * alpha + sum;
        m[g] = mx;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float a = acc[g][v] * alpha;
#pragma unroll
          for (int c = 0; c < kChunk; ++c) a = fmaf(s[c], vr[c][v], a);
          acc[g][v] = a;
        }
      }
    }
  }

  // combine the warps' partials
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= gcount) break;
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int d = lane + 32 * v;
      if (d < HD) s_acc[warp][g][d] = acc[g][v];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < gcount * HD; e += blockDim.x) {
    const int g = e / HD, d = e - g * HD;
    float mx = kAttnNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += s_acc[w][g][d] * expf(s_m[w][g] - mx);
    acc_out[qrow + e] = a;
  }
  for (int g = threadIdx.x; g < gcount; g += blockDim.x) {
    float mx = kAttnNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += s_l[w][g] * expf(s_m[w][g] - mx);
    const int64_t row = (int64_t)bi * hq + (int64_t)h * gn + g0 + g;
    m_out[row] = mx;
    l_out[row] = sum;
  }
}

template <int HD>
int launch_paged(const void* q, const void* pool, const void* tables,
                 const void* page_pos, const void* seq_lens, void* acc,
                 void* m, void* l, int b, int hq, int hkv, int page, int pps,
                 int window, cudaStream_t stream) {
  const int n_gblk = (hq / hkv + kMaxG - 1) / kMaxG;
  paged_attention_kernel<HD><<<dim3(hkv * n_gblk, b), kWarps * 32, 0,
                               stream>>>(
      (const float*)q, (const float*)pool, (const int*)tables,
      (const int*)page_pos, (const int*)seq_lens, (float*)acc, (float*)m,
      (float*)l, hq, hkv, page, pps, window);
  return (int)cudaGetLastError();
}

}  // namespace libra

extern "C" int libra_paged_attention(const void* q, const void* pool,
                                     const void* tables, const void* page_pos,
                                     const void* seq_lens, void* acc, void* m,
                                     void* l, int b, int hq, int hkv, int hd,
                                     int page, int pps, int window,
                                     void* cuda_stream) {
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define LIBRA_PAGED(HD)                                                      \
  case HD:                                                                   \
    return libra::launch_paged<HD>(q, pool, tables, page_pos, seq_lens, acc, \
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
