// Stabilised chunkwise-parallel mLSTM scan (sm_90a, float32).
//
// Replaces the Pallas kernel `mlstm_scan` (body `_mlstm_kernel`) of
// src/repro/kernels/mlstm_scan.py:73 (:26); semantics are those of
// `mlstm_chunked_ref` in kernels/ref.py, the twin of the JAX package's
// `mlstm_cell_chunked` (models/ssm.py:201): q/k/v [B, H, S, dh] and the
// gates log_i/log_f [B, H, S] (log_f log-sigmoided) -> h [B, H, S, dh],
// plus the final state C [B, H, dh, dh], n [B, H, dh] and m [B, H], which
// the TPU kernel keeps in VMEM scratch and drops. S need not be a multiple
// of the chunk: rows past S read as the JAX function's padding (q, k, v 0,
// log_i -1e30, log_f 0) and are not written.
//
// Design. The TPU kernel holds the whole C [dh, dh] in VMEM; at dh = 512
// that is 1 MiB, and a block has at most 227 KB of shared memory. So C's
// value columns are split: the grid is (B*H, dh/DV), each block keeps its
// [dh, DV] tile of C in shared memory (DV = 64: 128 KB) and walks the
// chunks of its (row, head) in order, the TPU's "arbitrary" chunk axis. Per
// chunk, 256 threads (16 x 16, each a 4 x 4 tile at chunk 64) do:
//   0. the gates: cumsum A of log_f, the row stabiliser
//      m_loc = max(max_{s<=t} A_t - A_s + li_s, A_t + m), the end-of-chunk
//      m_new and decay, the key weights exp(A_T - A_s + li_s - m_new);
//   1. q kT [c, c] and q C [c, DV] in one pass over the head dim, q and k
//      staged through shared memory DK = 64 dims at a time (k pre-scaled by
//      1/sqrt(dh), as the Pallas kernel does), and q.n;
//   2. h = ((S o qk) v + exp(A + m - m_loc) q C) /
//          max(|rowsum(S o qk) + exp(A + m - m_loc) q.n|, exp(-m_loc));
//   3. C = decay C + (k w)T v on the block's tile, DU = 64 key dims at a
//      time, and n = decay n + sum_s k w.
// Every block recomputes the gates, q kT, q.n and n for itself (one q kT
// is c/dh = 1/8 of q C at dh 512); only the block of value tile 0 writes
// n and m. Shared memory at dh 512, chunk 64:
// C tile 131072 B, q/k slices 34816 B (reused for the weighted k of step
// 3), v tile 16384 B, (S o qk)T 17408 B, gates, n and m 3856 B: 203536 B
// of the 232448 a block may have, one block per SM, opted in with
// cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// Numerics: accurate expf, float32 FMA, no tensor cores; -1e30 for masked
// and padded steps, as the TPU kernel.
//
// Bound on the H100: operations. Per (row, head, chunk) the function does
// 2 (c^2 dh + c^2 dh + c dh^2 + c dh^2) FLOP (q kT, (S o qk) v, q C,
// (k w)T v): 75.5 MFLOP at c 64, dh 512, on 4 x c x dh x 4 B of q, k, v
// and h, 2.4 kFLOP per byte. This first version recomputes q kT in each of
// the dh/DV blocks of a head (1.39x the work at dh 512), loads its slices
// with no overlap of the next slice's loads with this slice's math, and
// uses plain float32 FMA: no wgmma, no TMA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace libra {

constexpr float kMlstmNegInf = -1e30f;
constexpr int kMlstmThreads = 256;  // 16 x 16: ty rows, tx columns

template <int CH, int HD>
struct MlstmTile {
  static constexpr int DV = HD < 64 ? HD : 64;  // value columns per block
  static constexpr int DK = HD < 64 ? HD : 64;  // q/k dims staged per step 1
  static constexpr int DU = HD < 64 ? HD : 64;  // key dims per step 3
  static constexpr int RT = CH / 16;            // chunk rows per thread
  static constexpr int ST = CH / 16;            // keys per thread (q kT)
  static constexpr int CT = DV / 16;            // value columns per thread
  static constexpr int UT = DU / 16;            // key dims per thread (step 3)
  static constexpr int LD = CH + 4;             // padded row of a [*, CH] tile
  // offsets in floats into dynamic shared memory
  static constexpr int kC = 0;                  // C tile [HD][DV]
  static constexpr int kQ = kC + HD * DV;       // q slice, transposed [DK][LD]
  static constexpr int kK = kQ + DK * LD;       // k slice, transposed [DK][LD]
  static constexpr int kKW = kQ;                // weighted k [CH][DU] (step 3)
  static constexpr int kV = kK + DK * LD;       // v tile [CH][DV]
  static constexpr int kP = kV + CH * DV;       // (S o qk), transposed [CH][LD]
  static constexpr int kA = kP + CH * LD;       // gates, 7 x [CH]
  static constexpr int kN = kA + 7 * CH;        // n [HD]
  static constexpr int kS = kN + HD;            // m, m_new, decay
  static constexpr int kFloats = kS + 4;
  static_assert(CH % 16 == 0 && HD % 16 == 0, "chunk and dh: multiples of 16");
  static_assert(HD % DV == 0 && HD % DK == 0 && HD % DU == 0, "dh tiling");
  static_assert(CH * DU <= 2 * DK * LD, "weighted k must fit the q/k slices");
};

// N consecutive floats of shared memory, 16- or 8-byte loads where N allows
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&r)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x; r[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = p[i];
  }
}

template <int CH, int HD>
__global__ void __launch_bounds__(kMlstmThreads) mlstm_scan_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ log_i,
    const float* __restrict__ log_f, float* __restrict__ h,
    float* __restrict__ c_out, float* __restrict__ n_out,
    float* __restrict__ m_out, int s_len) {
  using T = MlstmTile<CH, HD>;
  constexpr int DV = T::DV, DK = T::DK, DU = T::DU, LD = T::LD;
  constexpr int RT = T::RT, ST = T::ST, CT = T::CT, UT = T::UT;
  extern __shared__ __align__(16) float smem[];
  float* cs = smem + T::kC;
  float* qs = smem + T::kQ;
  float* ks = smem + T::kK;
  float* kw = smem + T::kKW;
  float* vs = smem + T::kV;
  float* ps = smem + T::kP;
  float* a_s = smem + T::kA;       // cumsum of log_f
  float* li_s = a_s + CH;          // log_i
  float* mloc = li_s + CH;         // row stabiliser m_loc
  float* einter = mloc + CH;       // exp(A + m - m_loc)
  float* gk = einter + CH;         // exp(w_end - m_new) / sqrt(dh)
  float* qn = gk + CH;             // q . n
  float* den = qn + CH;            // denominator
  float* nv = smem + T::kN;        // n [HD]
  float* sc = smem + T::kS;        // m, m_new, decay

  const int bh = blockIdx.x, j0 = blockIdx.y * DV;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float scale = 1.0f / sqrtf((float)HD);
  const int64_t xbase = (int64_t)bh * s_len * HD;
  const int64_t gbase = (int64_t)bh * s_len;

  for (int e = tid; e < HD * DV; e += kMlstmThreads) cs[e] = 0.f;
  for (int e = tid; e < HD; e += kMlstmThreads) nv[e] = 0.f;
  if (tid == 0) sc[0] = kMlstmNegInf;

  for (int c0 = 0; c0 < s_len; c0 += CH) {
    // ---- 0. gates and the v tile -------------------------------------
    if (tid < CH) {
      const bool in = c0 + tid < s_len;
      li_s[tid] = in ? log_i[gbase + c0 + tid] : kMlstmNegInf;
      a_s[tid] = in ? log_f[gbase + c0 + tid] : 0.f;
    }
#pragma unroll 4
    for (int e = tid; e < CH * DV; e += kMlstmThreads) {
      const int s = e / DV, j = e - s * DV;
      vs[e] = c0 + s < s_len ? v[xbase + (int64_t)(c0 + s) * HD + j0 + j]
                             : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < CH; ++t) {  // inclusive cumsum
        acc += a_s[t];
        a_s[t] = acc;
      }
      const float m_prev = sc[0];
      float m_new = acc + m_prev;
      for (int s = 0; s < CH; ++s) m_new = fmaxf(m_new, acc - a_s[s] + li_s[s]);
      sc[1] = m_new;
      sc[2] = expf(acc + m_prev - m_new);
    }
    __syncthreads();
    if (tid < CH) {
      const int t = tid;
      const float at = a_s[t], binter = at + sc[0];
      float ml = binter;
      for (int s = 0; s <= t; ++s) ml = fmaxf(ml, at - a_s[s] + li_s[s]);
      mloc[t] = ml;
      einter[t] = expf(binter - ml);
      gk[t] = expf(a_s[CH - 1] - at + li_s[t] - sc[1]) * scale;
    }

    // ---- 1. q kT, q C (the block's columns) and q . n ----------------
    float acc_qk[RT][ST], acc_qc[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < ST; ++j) acc_qk[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) acc_qc[i][j] = 0.f;
    }
    float qn_acc = 0.f;
    for (int d0 = 0; d0 < HD; d0 += DK) {
      __syncthreads();  // the previous slice's readers are done
#pragma unroll 4
      for (int e = tid; e < CH * DK; e += kMlstmThreads) {
        const int t = e / DK, d = e - t * DK;
        const bool in = c0 + t < s_len;
        const int64_t off = xbase + (int64_t)(c0 + t) * HD + d0 + d;
        qs[d * LD + t] = in ? q[off] : 0.f;
        ks[d * LD + t] = in ? k[off] * scale : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < DK; ++d) {
        float a[RT], b[ST], c[CT];
        lds<RT>(&qs[d * LD + ty * RT], a);
        lds<ST>(&ks[d * LD + tx * ST], b);
        lds<CT>(&cs[(d0 + d) * DV + tx * CT], c);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
#pragma unroll
          for (int j = 0; j < ST; ++j)
            acc_qk[i][j] = fmaf(a[i], b[j], acc_qk[i][j]);
#pragma unroll
          for (int j = 0; j < CT; ++j)
            acc_qc[i][j] = fmaf(a[i], c[j], acc_qc[i][j]);
        }
      }
      if (tid < CH) {
#pragma unroll 8
        for (int d = 0; d < DK; ++d)
          qn_acc = fmaf(qs[d * LD + tid], nv[d0 + d], qn_acc);
      }
    }
    if (tid < CH) qn[tid] = qn_acc;
    __syncthreads();

    // ---- 2. h ----------------------------------------------------------
    // P[t][s] = exp(W - m_loc) * qk, W = A_t - A_s + li_s for s <= t, else
    // -1e30; a row's CH keys sit in the 16 lanes of one half-warp (same ty)
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int t = ty * RT + i;
      const float at = a_s[t], ml = mloc[t];
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        const int s = tx * ST + j;
        const float w = s <= t ? at - a_s[s] + li_s[s] : kMlstmNegInf;
        const float p = expf(w - ml) * acc_qk[i][j];
        acc_qk[i][j] = p;
        rowsum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, o);
      if (tx == 0) den[t] = rowsum + einter[t] * qn[t];
#pragma unroll
      for (int j = 0; j < ST; ++j) ps[(tx * ST + j) * LD + t] = acc_qk[i][j];
    }
    __syncthreads();
    {
      float acc[RT][CT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int s = 0; s < CH; ++s) {
        float p[RT], w[CT];
        lds<RT>(&ps[s * LD + ty * RT], p);
        lds<CT>(&vs[s * DV + tx * CT], w);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int t = ty * RT + i;
        if (c0 + t >= s_len) continue;
        const float ei = einter[t];
        const float dn = fmaxf(fabsf(den[t]), expf(-mloc[t]));
        float* o = h + xbase + (int64_t)(c0 + t) * HD + j0 + tx * CT;
#pragma unroll
        for (int j = 0; j < CT; ++j)
          o[j] = (acc[i][j] + ei * acc_qc[i][j]) / dn;
      }
    }

    // ---- 3. C = decay C + (k w)T v, n = decay n + sum_s k w -----------
    const float decay = sc[2];
    for (int u0 = 0; u0 < HD; u0 += DU) {
      __syncthreads();  // q/k slices (step 1) or the last kw read are done
#pragma unroll 4
      for (int e = tid; e < CH * DU; e += kMlstmThreads) {
        const int s = e / DU, d = e - s * DU;
        kw[e] = c0 + s < s_len
                    ? k[xbase + (int64_t)(c0 + s) * HD + u0 + d] * gk[s]
                    : 0.f;
      }
      __syncthreads();
      float acc[UT][CT];
#pragma unroll
      for (int i = 0; i < UT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int s = 0; s < CH; ++s) {
        float a[UT], b[CT];
        lds<UT>(&kw[s * DU + ty * UT], a);
        lds<CT>(&vs[s * DV + tx * CT], b);
#pragma unroll
        for (int i = 0; i < UT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < UT; ++i) {
        float* crow = &cs[(u0 + ty * UT + i) * DV + tx * CT];
#pragma unroll
        for (int j = 0; j < CT; ++j) crow[j] = decay * crow[j] + acc[i][j];
      }
      if (tid < DU) {
        float sum = 0.f;
        for (int s = 0; s < CH; ++s) sum += kw[s * DU + tid];
        nv[u0 + tid] = decay * nv[u0 + tid] + sum;
      }
    }
    __syncthreads();  // the v tile and gates are read; next chunk may load
    if (tid == 0) sc[0] = sc[1];
  }

  __syncthreads();
  float* cdst = c_out + (int64_t)bh * HD * HD + j0;
  for (int e = tid; e < HD * DV; e += kMlstmThreads) {
    const int d = e / DV, j = e - d * DV;
    cdst[(int64_t)d * HD + j] = cs[e];
  }
  if (blockIdx.y == 0) {
    for (int e = tid; e < HD; e += kMlstmThreads)
      n_out[(int64_t)bh * HD + e] = nv[e];
    if (tid == 0) m_out[bh] = sc[0];
  }
}

template <int CH, int HD>
int launch_mlstm(const float* q, const float* k, const float* v,
                 const float* li, const float* lf, float* h, float* c,
                 float* n, float* m, int bh, int s_len, cudaStream_t stream) {
  using T = MlstmTile<CH, HD>;
  constexpr size_t smem = sizeof(float) * T::kFloats;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlstm_scan_kernel<CH, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(bh, HD / T::DV);
  mlstm_scan_kernel<CH, HD><<<grid, kMlstmThreads, smem, stream>>>(
      q, k, v, li, lf, h, c, n, m, s_len);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mlstm_chunk(int chunk, const float* q, const float* k,
                       const float* v, const float* li, const float* lf,
                       float* h, float* c, float* n, float* m, int bh,
                       int s_len, cudaStream_t st) {
  switch (chunk) {
    case 16:
      return launch_mlstm<16, HD>(q, k, v, li, lf, h, c, n, m, bh, s_len, st);
    case 32:
      return launch_mlstm<32, HD>(q, k, v, li, lf, h, c, n, m, bh, s_len, st);
    case 64:
      return launch_mlstm<64, HD>(q, k, v, li, lf, h, c, n, m, bh, s_len, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace libra

extern "C" int libra_mlstm_scan(const void* q, const void* k, const void* v,
                                const void* log_i, const void* log_f,
                                void* h, void* c, void* n, void* m, int bh,
                                int s_len, int hd, int chunk,
                                void* cuda_stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* lif = (const float*)log_i;
  const float* lff = (const float*)log_f;
  float* hf = (float*)h;
  float* cf = (float*)c;
  float* nf = (float*)n;
  float* mf = (float*)m;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  switch (hd) {
    case 16:
      return libra::launch_mlstm_chunk<16>(chunk, qf, kf, vf, lif, lff, hf,
                                           cf, nf, mf, bh, s_len, st);
    case 32:
      return libra::launch_mlstm_chunk<32>(chunk, qf, kf, vf, lif, lff, hf,
                                           cf, nf, mf, bh, s_len, st);
    case 64:
      return libra::launch_mlstm_chunk<64>(chunk, qf, kf, vf, lif, lff, hf,
                                           cf, nf, mf, bh, s_len, st);
    case 512:
      return libra::launch_mlstm_chunk<512>(chunk, qf, kf, vf, lif, lff, hf,
                                            cf, nf, mf, bh, s_len, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
