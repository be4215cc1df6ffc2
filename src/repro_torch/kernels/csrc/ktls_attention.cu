// Decode attention over float32 or int8-quantised K/V, and the dequantise
// pass (sm_90a): the kernels of the kTLS-analogue bench.
//
// Replaces no Pallas kernel. `benchmarks/bench_ktls_analogue.py` measures
// three jitted functions (`plain`, `sw_mode`, `hw_mode`, l.41-62) whose
// point is fusion: `sw_mode` dequantises the whole int8 payload into a new
// float buffer and then attends (a separate pass, the software-kTLS
// encrypt-and-copy); `hw_mode` dequantises inside the contraction, which
// XLA fuses into the attention's read (the NIC-inline analogue). Eager
// PyTorch would run `hw_mode` as the same separate passes as `sw_mode`, so
// the port computes the three functions with these kernels:
//
// * `ktls_attention_kernel<float>`: softmax(q k^T) v of q [B, Hq, hd] over
//   every key of kv [B, ctx, 2, Hkv, hd] (K at index 0, V at 1 of the third
//   axis), with no 1/sqrt(hd) scale and no mask, as the reference attends;
//   query head h reads KV head h / (Hq / Hkv). `plain` and `sw_mode`'s
//   attention.
// * `ktls_attention_kernel<int8_t>`: the same over kq int8 with amax
//   [B, ctx, 2, Hkv, 1] float32; each K/V element is turned into
//   float(q) * amax / 127 in registers before it is used, so no float K/V
//   buffer exists. `hw_mode`.
// * `ktls_dequant_kernel`: float(q) * amax / 127 of every element into a
//   new [B, ctx, 2, Hkv, hd] float32 buffer. `sw_mode`'s separate pass.
//   Bit-identical to `ktls_dequant_ref`: the same product, then the
//   correctly rounded quotient (div127 below).
//
// Semantics are those of `ktls_attention_ref` and `ktls_dequant_ref` in
// kernels/ref.py.
//
// Bound on the H100: bytes. A key costs 4 x hd FLOP a query head against
// 2 x hd x 4 bytes of float K/V (2 x hd + 8 bytes int8 with its two amax),
// far below either compute peak. At the bench's shape (B = 8, 12 heads of
// 64, ctx 4096) the float KV is 201.3 MB (60.1 us at 3.35 TB/s), the int8
// KV with its amax 53.5 MB (16.0 us); the dequantise pass reads 53.5 MB
// and writes 201.3 MB (76.1 us).
//
// Design (simple first; a split over ctx, 16-byte int8 loads and cp.async
// are later work):
//
// * One block of kThreads a (batch, query head): B x Hq = 96 blocks at the
//   bench's shape, fewer than the card's 132 SMs.
// * kLanes = 8 lanes score one key: each holds 8 of q's 64 dims in
//   registers and reads the same 8 dims of K and V (two float4 loads each,
//   contiguous 128 B per quarter-warp, or one 8-byte int8 word and the
//   row's amax), so a dot product takes 3 shuffles within the group and no
//   shared memory.
// * A block's kGroups groups take keys g, g + kGroups, ... and U keys a
//   step (U = 2 for float, 4 for int8, whose raw words take fewer
//   registers). The raw words of the next step are loaded into registers
//   before the current step is dequantised and scored, so a step's
//   arithmetic overlaps the next step's loads.
// * Each group keeps its own online softmax (m, l, and its lanes' 8 dims
//   of acc); a key costs one exp: exp(m - s) when s raises the max, else
//   exp(s - m). The groups' partials merge in shared memory at the end:
//   M = max m, L = sum l exp(m - M), out = sum acc exp(m - M) / L. A group
//   with no key keeps m = -1e30, l = 0, acc = 0 and weighs 0.
// * x / 127 is computed as the correctly rounded quotient without a
//   division instruction sequence (div127): q = x * RN(1/127), then one
//   fma correction, exact for every x of a row whose amax lies in
//   [2^-80, 2^120] (tested once a row; other rows divide). A first int8
//   kernel that divided took twice the float kernel's time at ctx 4096
//   (PERF.md, section 6); the product with the reciprocal alone rounds
//   otherwise in 4.7 % of cases.
#include <cuda_runtime.h>
#include <stdint.h>

namespace libra {
namespace ktls {

constexpr int kHd = 64;
constexpr int kLanes = 8;                    // lanes a key
constexpr int kDims = kHd / kLanes;          // dims a lane
constexpr int kThreads = 512;
constexpr int kGroups = kThreads / kLanes;   // keys in flight a step
constexpr float kNegInf = -1e30f;
constexpr float kInv127 = 1.f / 127.f;       // RN(1/127)

// RN(x / 127), bit for bit the IEEE quotient, for x = +0 and 2^-80 <=
// |x| <= 2^127: q = RN(x z), r = RN(x - 127 q) (one fma), RN(q + r z)
// (one fma). Every step scales exactly by a power of two while no
// intermediate is subnormal or infinite, so one binade stands for the
// range: it is checked for every float of [1, 2), both signs, in
// tests/test_torch_ktls_analogue.py.
__device__ __forceinline__ float div127(float x) {
  const float q = x * kInv127;
  return fmaf(fmaf(-q, 127.f, x), kInv127, q);
}

// Whether every x = RN(q * amax) of an int8 q lies where div127 is exact:
// x = +0, or 2^-80 <= |x| <= 128 amax <= 2^127. A row outside (never at the
// bench: amax = max|x| + 1e-9) divides. The card checks both paths for
// every float32 bit pattern as amax (chip_smoke.py, phase 22).
__device__ __forceinline__ bool div127_exact(float amax) {
  return amax >= 0x1p-80f && amax <= 0x1p120f;
}

__device__ __forceinline__ float dequant_slow(int8_t qv, float amax) {
  return (float)qv * amax / 127.f;
}

// The raw words of one K or V row that lane c reads, and their values.
template <typename T>
struct Raw;

template <>
struct Raw<float> {
  float4 a, b;                               // dims 4c.. and 32 + 4c..
  static constexpr int kUnroll = 2;
  __device__ static int dim(int c, int j) {
    return j < 4 ? 4 * c + j : kHd / 2 + 4 * c + (j - 4);
  }
  __device__ void fetch(const float* __restrict__ row,
                        const float* __restrict__ /*amax*/, int c) {
    a = *reinterpret_cast<const float4*>(row + 4 * c);
    b = *reinterpret_cast<const float4*>(row + kHd / 2 + 4 * c);
  }
  __device__ void values(float x[kDims]) const {
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};

template <>
struct Raw<int8_t> {
  int2 w;                                    // dims 8c..8c+7
  float amax;
  static constexpr int kUnroll = 4;
  __device__ static int dim(int c, int j) { return kDims * c + j; }
  __device__ void fetch(const int8_t* __restrict__ row,
                        const float* __restrict__ amax_row, int c) {
    w = *reinterpret_cast<const int2*>(row + kDims * c);
    amax = *amax_row;
  }
  __device__ signed char code(int j) const {
    return (signed char)((j < 4 ? w.x : w.y) >> (8 * (j & 3)));
  }
  // float(q) * amax / 127, dequantised in registers
  __device__ void values(float x[kDims]) const {
    if (div127_exact(amax)) {
#pragma unroll
      for (int j = 0; j < kDims; ++j) x[j] = div127((float)code(j) * amax);
    } else {
#pragma unroll
      for (int j = 0; j < kDims; ++j) x[j] = dequant_slow(code(j), amax);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ktls_attention_kernel(const float* __restrict__ q, const T* __restrict__ kv,
                      const float* __restrict__ amax, float* __restrict__ out,
                      int ctx, int hq, int hkv) {
  constexpr int U = Raw<T>::kUnroll;
  constexpr int kStep = kGroups * U;
  __shared__ float sm_m[kGroups];
  __shared__ float sm_l[kGroups];
  __shared__ float sm_acc[kGroups][kHd];

  const int bh = blockIdx.x;                 // b * hq + h
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kh = h / (hq / hkv);
  const int c = threadIdx.x & (kLanes - 1);
  const int grp = threadIdx.x / kLanes;

  float qr[kDims];
#pragma unroll
  for (int j = 0; j < kDims; ++j)
    qr[j] = q[(int64_t)bh * kHd + Raw<T>::dim(c, j)];

  // element (b, t, s, kh, 0) of kv is ((b * ctx + t) * 2 + s) * hkv * hd
  // + kh * hd; its amax is ((b * ctx + t) * 2 + s) * hkv + kh. A key past
  // ctx reads key 0 and is not scored.
  const int64_t row0 = (int64_t)b * ctx * 2;
  Raw<T> nk[U], nv[U];
  auto fetch_step = [&](int t0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * kGroups + grp;
      const int64_t rk = (row0 + 2LL * (t < ctx ? t : 0)) * hkv + kh;
      const int64_t rv = rk + hkv;
      nk[u].fetch(kv + rk * kHd, amax + rk, c);
      nv[u].fetch(kv + rv * kHd, amax + rv, c);
    }
  };

  float m = kNegInf, l = 0.f, acc[kDims];
#pragma unroll
  for (int j = 0; j < kDims; ++j) acc[j] = 0.f;
  fetch_step(0);
  for (int t0 = 0; t0 < ctx; t0 += kStep) {
    Raw<T> ck[U], cv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ck[u] = nk[u];
      cv[u] = nv[u];
    }
    if (t0 + kStep < ctx) fetch_step(t0 + kStep);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[kDims];
      ck[u].values(x);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kDims; ++j) s += qr[j] * x[j];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (t0 + u * kGroups + grp >= ctx) continue;
      cv[u].values(x);
      if (s > m) {
        const float sc = expf(m - s);
        l = l * sc + 1.f;
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[j] = acc[j] * sc + x[j];
        m = s;
      } else {
        const float p = expf(s - m);
        l += p;
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[j] += p * x[j];
      }
    }
  }

  if (c == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
#pragma unroll
  for (int j = 0; j < kDims; ++j) sm_acc[grp][Raw<T>::dim(c, j)] = acc[j];
  __syncthreads();
  if (threadIdx.x < kHd) {
    const int d = threadIdx.x;
    float mx = kNegInf;
    for (int g = 0; g < kGroups; ++g) mx = fmaxf(mx, sm_m[g]);
    float lsum = 0.f, o = 0.f;
    for (int g = 0; g < kGroups; ++g) {
      const float w = expf(sm_m[g] - mx);
      lsum += sm_l[g] * w;
      o += sm_acc[g][d] * w;
    }
    out[(int64_t)bh * kHd + d] = o / lsum;
  }
}

// Four elements a thread (hd % 4 == 0: they share one amax) or one.
template <int kVec>
__global__ void ktls_dequant_kernel(const int8_t* __restrict__ kq,
                                    const float* __restrict__ amax,
                                    float* __restrict__ out, int64_t n,
                                    int hd) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i * kVec < n; i += stride) {
    const float a = amax[i * kVec / hd];
    const bool exact = div127_exact(a);
    if (kVec == 4) {
      const char4 v = reinterpret_cast<const char4*>(kq)[i];
      float4 o;
      if (exact) {
        o.x = div127((float)v.x * a);
        o.y = div127((float)v.y * a);
        o.z = div127((float)v.z * a);
        o.w = div127((float)v.w * a);
      } else {
        o.x = dequant_slow(v.x, a);
        o.y = dequant_slow(v.y, a);
        o.z = dequant_slow(v.z, a);
        o.w = dequant_slow(v.w, a);
      }
      reinterpret_cast<float4*>(out)[i] = o;
    } else {
      out[i] = exact ? div127((float)kq[i] * a) : dequant_slow(kq[i], a);
    }
  }
}

}  // namespace ktls
}  // namespace libra

extern "C" int libra_ktls_attention(const void* q, const void* kv,
                                    const void* amax, void* out, int b,
                                    int hq, int hkv, int ctx, int hd,
                                    int int8_kv, void* cuda_stream) {
  using namespace libra::ktls;
  if (hd != kHd || hkv < 1 || hq % hkv != 0 || ctx < 1 ||
      (int8_kv && amax == nullptr))
    return (int)cudaErrorInvalidValue;
  // float4 / 8-byte loads of each row
  if ((uintptr_t)kv & 15) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  const int blocks = b * hq;
  if (int8_kv)
    ktls_attention_kernel<int8_t><<<blocks, kThreads, 0, st>>>(
        (const float*)q, (const int8_t*)kv, (const float*)amax, (float*)out,
        ctx, hq, hkv);
  else
    ktls_attention_kernel<float><<<blocks, kThreads, 0, st>>>(
        (const float*)q, (const float*)kv, nullptr, (float*)out, ctx, hq,
        hkv);
  return (int)cudaGetLastError();
}

extern "C" int libra_ktls_dequant(const void* kq, const void* amax, void* out,
                                  int rows, int hd, void* cuda_stream) {
  if (rows < 1 || hd < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  const int64_t n = (int64_t)rows * hd;
  const int threads = 256;
  const bool vec = (hd & 3) == 0 && (((uintptr_t)kq & 3) == 0) &&
                   (((uintptr_t)out & 15) == 0);
  const int64_t items = vec ? n / 4 : n;
  const int64_t want = (items + threads - 1) / threads;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  if (vec)
    libra::ktls::ktls_dequant_kernel<4><<<blocks, threads, 0, st>>>(
        (const int8_t*)kq, (const float*)amax, (float*)out, n, hd);
  else
    libra::ktls::ktls_dequant_kernel<1><<<blocks, threads, 0, st>>>(
        (const int8_t*)kq, (const float*)amax, (float*)out, n, hd);
  return (int)cudaGetLastError();
}
