// paged_gqa_decode: flash-decoding over the paged KV pool, one query token
// per slot, query heads grouped by kv head.
//
//   q      [B, KVH, G, D]            (T = float or bf16)
//   k_pool [n_blocks, BS, KVH, D]    v_pool [n_blocks, BS, KVH, DV]
//   table  int32 [B, Tw]             kv_len int32 [B]
//   out    float32 [B, KVH, G, DV]
//
// Replaces src/repro/kernels/flash_attention.py::paged_gqa_decode
// (_paged_gqa_body).  Bound on the H100: device-memory bytes — every K/V
// position a slot owns is read once, and a decode query does 2*(D+DV)
// FLOPs per position.  Design: one CTA per (slot, kv head) holds the G
// query rows in shared memory and walks the slot's block table itself,
// stopping at ceil(kv_len / BS) (the reference's trailing trash tiles are
// fully masked, so stopping there gives its result).  Each step loads
// physical block table[b, j] of K and V into shared memory, scores the G
// queries against it, applies the kv_len mask, the optional sliding window
// (kpos > kv_len - 1 - window) and the optional softcap cap*tanh(s/cap)
// exactly as the reference body does, and updates the f32 online-softmax
// state m/l/acc.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPairs = 8;  // (g, c) accumulators per thread: G*DV <= 1024
constexpr float kNeg = -1e30f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp,
                        const int* __restrict__ table,
                        const int* __restrict__ kv_len, float* __restrict__ out,
                        int KVH, int G, int D, int DV, int BS, int Tw,
                        float scale, int window, float cap) {
  extern __shared__ float smem[];
  float* qs = smem;            // [G, D]
  float* ks = qs + G * D;      // [BS, D]
  float* vs = ks + BS * D;     // [BS, DV]
  float* ps = vs + BS * DV;    // [G, BS] scores, then probabilities
  float* ms = ps + G * BS;     // [G] running max
  float* ls = ms + G;          // [G] running denominator
  float* cs = ls + G;          // [G] this step's rescale factor

  const int tid = threadIdx.x;
  const int b = blockIdx.x / KVH;
  const int h = blockIdx.x % KVH;
  const int L = kv_len[b];
  const int steps = min((L + BS - 1) / BS, Tw);

  const T* qrow = q + (size_t)blockIdx.x * G * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(qrow[i]);
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNeg;
    ls[g] = 0.f;
  }
  float acc[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) acc[i] = 0.f;

  for (int j = 0; j < steps; ++j) {
    __syncthreads();  // previous step done with ks/vs/ps
    const size_t pid = (size_t)table[(size_t)b * Tw + j];
    for (int i = tid; i < BS * D; i += kThreads) {
      const int t = i / D, d = i % D;
      ks[i] = to_f32(kp[((pid * BS + t) * KVH + h) * D + d]);
    }
    for (int i = tid; i < BS * DV; i += kThreads) {
      const int t = i / DV, d = i % DV;
      vs[i] = to_f32(vp[((pid * BS + t) * KVH + h) * DV + d]);
    }
    __syncthreads();
    for (int i = tid; i < G * BS; i += kThreads) {
      const int g = i / BS, t = i % BS;
      float s = 0.f;
      // rotate the start column by t so the lanes of a warp (consecutive
      // t) read different shared-memory banks
      for (int dd = 0; dd < D; ++dd) {
        const int d = (dd + t) % D;
        s = fmaf(qs[g * D + d], ks[t * D + d], s);
      }
      s *= scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      const int kpos = j * BS + t;
      bool ok = kpos < L;
      if (window >= 0) ok = ok && kpos > L - 1 - window;
      ps[i] = ok ? s : kNeg;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      const float m_prev = ms[g];
      float m_new = m_prev;
      for (int t = 0; t < BS; ++t) m_new = fmaxf(m_new, ps[g * BS + t]);
      float sum = 0.f;
      for (int t = 0; t < BS; ++t) {
        const int kpos = j * BS + t;
        bool ok = kpos < L;
        if (window >= 0) ok = ok && kpos > L - 1 - window;
        const float p = ok ? expf(ps[g * BS + t] - m_new) : 0.f;
        ps[g * BS + t] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      ls[g] = ls[g] * corr + sum;
      ms[g] = m_new;
      cs[g] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int pair = tid + i * kThreads;
      if (pair >= G * DV) break;
      const int g = pair / DV, c = pair % DV;
      float a = acc[i] * cs[g];
      for (int t = 0; t < BS; ++t) a = fmaf(ps[g * BS + t], vs[t * DV + c], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  float* orow = out + (size_t)blockIdx.x * G * DV;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int pair = tid + i * kThreads;
    if (pair >= G * DV) break;
    const int g = pair / DV;
    orow[pair] = acc[i] / fmaxf(ls[g], 1e-30f);
  }
}

}  // namespace

extern "C" int paged_gqa_decode_smem_bytes(int G, int D, int DV, int BS) {
  return (G * D + BS * D + BS * DV + G * BS + 3 * G) * (int)sizeof(float);
}

extern "C" int paged_gqa_decode_launch(const void* q, const void* k_pool,
                                       const void* v_pool, const void* table,
                                       const void* kv_len, void* out, int B,
                                       int KVH, int G, int D, int DV, int BS,
                                       int Tw, float scale, int window,
                                       float cap, int dtype, void* stream) {
  if (G * DV > kThreads * kMaxPairs) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = paged_gqa_decode_smem_bytes(G, D, DV, BS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * KVH);
  if (dtype == REPRO_DTYPE_F32) {
    paged_gqa_decode_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), static_cast<const int*>(table),
        static_cast<const int*>(kv_len), static_cast<float*>(out), KVH, G, D,
        DV, BS, Tw, scale, window, cap);
  } else if (dtype == REPRO_DTYPE_BF16) {
    paged_gqa_decode_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool),
        static_cast<const int*>(table), static_cast<const int*>(kv_len),
        static_cast<float*>(out), KVH, G, D, DV, BS, Tw, scale, window, cap);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
