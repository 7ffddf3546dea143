// paged_gqa_verify: flash-decoding over the paged KV pool for a span of S
// consecutive query tokens per slot, query heads grouped by kv head.  The
// one-token decode is the span S = 1: ``paged_gqa_decode`` and
// ``paged_gqa_verify`` (kernels/flash_attention.py) both launch this kernel,
// each with its own launch counter.
//
//   q      [B, S, KVH, G, D]         (T = float or bf16)
//   k_pool [n_blocks, BS, KVH, D]    v_pool [n_blocks, BS, KVH, DV]
//   table  int32 [B, Tw]             kv_len int32 [B] (for span offset 0)
//   out    float32 [B, S, KVH, G, DV]
//
// Replaces src/repro/kernels/flash_attention.py::paged_gqa_decode
// (_paged_gqa_body) and ::paged_gqa_verify, which launches paged_gqa_decode
// once per span offset i with kv_len + i.  Bound on the H100: device-memory
// bytes — every K/V position a slot owns is read once, against
// 2 * (D + DV) FLOPs per query row and position; S separate launches would
// read each slot's blocks S times.  Design: ONE launch for the span.  A CTA
// per (slot, kv head) holds all S * G query rows of that kv head in shared
// memory (rows are split into several CTAs only when S * G * DV exceeds the
// 1024 accumulators of 128 threads) and walks the slot's block table
// itself, up to ceil((kv_len + S - 1) / BS) (the reference's trailing trash
// tiles are fully masked, so stopping there gives its result).  Each step
// loads physical block table[b, j] of K and V into shared memory and
// scores the rows against it.  Row (i, g) sees kv_len + i positions: it
// applies its own kv_len mask, the optional sliding window
// (kpos > kv_len + i - 1 - window) and the optional softcap
// cap * tanh(s / cap) as the reference body does, updates its f32
// online-softmax state m / l / acc, and stops updating at its own
// ceil((kv_len + i) / BS) steps.  A row's operations — the score dot with
// its rotated start column, the sequential softmax over a block by one
// thread, the accumulator update over the block — never depend on the
// other rows, so span offset i equals an S = 1 launch at kv_len + i bit for
// bit.  S = 1 runs the decode instance (Span = false): every row sees
// kv_len, so the per-row lengths and checks compile away, and the CTA's
// rows are one contiguous run of q and of out.  The decode launches are
// latency-bound (about one CTA per SM at 8 slots), so this matters: an
// instance with per-row checks and a strided q load ran up to 26% slower
// on the H100.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPairs = 8;  // (row, c) accumulators per thread: R*DV <= 1024
constexpr float kNeg = -1e30f;

// Span = false is the S = 1 (decode) instance: every row sees kv_len
// positions, so the per-row lengths and step checks compile away.
template <typename T, bool Span>
__global__ void __launch_bounds__(kThreads)
paged_gqa_verify_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp,
                        const int* __restrict__ table,
                        const int* __restrict__ kv_len, float* __restrict__ out,
                        int S, int KVH, int G, int D, int DV, int BS, int Tw,
                        int rows_per_cta, float scale, int window, float cap) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.y * rows_per_cta;            // first span row (i*G+g)
  const int R = min(rows_per_cta, S * G - r0);         // rows of this CTA
  float* qs = smem;            // [R, D]
  float* ks = qs + R * D;      // [BS, D]
  float* vs = ks + BS * D;     // [BS, DV]
  float* ps = vs + BS * DV;    // [R, BS] scores, then probabilities
  float* ms = ps + R * BS;     // [R] running max
  float* ls = ms + R;          // [R] running denominator
  float* cs = ls + R;          // [R] this step's rescale factor
  int* rlen = reinterpret_cast<int*>(cs + R);  // [R] positions row r sees
  int* rsteps = rlen + R;      // [R] block steps row r updates in

  const int tid = threadIdx.x;
  const int b = blockIdx.x / KVH;
  const int h = blockIdx.x % KVH;
  const int L0 = kv_len[b];
  // the last row of the CTA sees the most positions
  const int steps = min((L0 + (r0 + R - 1) / G + BS - 1) / BS, Tw);

  if (Span) {
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = r0 + i / D, d = i % D;
      const int si = r / G, g = r % G;
      qs[i] = to_f32(q[((((size_t)b * S + si) * KVH + h) * G + g) * D + d]);
    }
  } else {  // S = 1: the CTA's rows are one contiguous run of q
    const T* qrow = q + ((size_t)blockIdx.x * G + r0) * D;
    for (int i = tid; i < R * D; i += kThreads) qs[i] = to_f32(qrow[i]);
  }
  for (int r = tid; r < R; r += kThreads) {
    ms[r] = kNeg;
    ls[r] = 0.f;
    if (Span) {
      rlen[r] = L0 + (r0 + r) / G;
      rsteps[r] = min((rlen[r] + BS - 1) / BS, Tw);
    }
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
    for (int i = tid; i < R * BS; i += kThreads) {
      const int r = i / BS, t = i % BS;
      const int L = Span ? rlen[r] : L0;
      float s = 0.f;
      // rotate the start column by t so the lanes of a warp (consecutive
      // t) read different shared-memory banks
      for (int dd = 0; dd < D; ++dd) {
        const int d = (dd + t) % D;
        s = fmaf(qs[r * D + d], ks[t * D + d], s);
      }
      s *= scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      const int kpos = j * BS + t;
      bool ok = kpos < L;
      if (window >= 0) ok = ok && kpos > L - 1 - window;
      ps[i] = ok ? s : kNeg;
    }
    __syncthreads();
    for (int r = tid; r < R; r += kThreads) {
      if (Span && j >= rsteps[r]) continue;  // past this row's walk
      const int L = Span ? rlen[r] : L0;
      const float m_prev = ms[r];
      float m_new = m_prev;
      for (int t = 0; t < BS; ++t) m_new = fmaxf(m_new, ps[r * BS + t]);
      float sum = 0.f;
      for (int t = 0; t < BS; ++t) {
        const int kpos = j * BS + t;
        bool ok = kpos < L;
        if (window >= 0) ok = ok && kpos > L - 1 - window;
        const float p = ok ? expf(ps[r * BS + t] - m_new) : 0.f;
        ps[r * BS + t] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      ls[r] = ls[r] * corr + sum;
      ms[r] = m_new;
      cs[r] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int pair = tid + i * kThreads;
      if (pair >= R * DV) break;
      const int r = pair / DV, c = pair % DV;
      if (Span && j >= rsteps[r]) continue;
      float a = acc[i] * cs[r];
      for (int t = 0; t < BS; ++t) a = fmaf(ps[r * BS + t], vs[t * DV + c], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  // S = 1: the CTA's output rows are one contiguous run
  float* orow = out + ((size_t)blockIdx.x * G + r0) * DV;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int pair = tid + i * kThreads;
    if (pair >= R * DV) break;
    const int r = pair / DV, c = pair % DV;
    const float v = acc[i] / fmaxf(ls[r], 1e-30f);
    if (Span) {
      const int si = (r0 + r) / G, g = (r0 + r) % G;
      out[((((size_t)b * S + si) * KVH + h) * G + g) * DV + c] = v;
    } else {
      orow[pair] = v;
    }
  }
}

template <typename T, bool Span>
int launch_rows(const void* q, const void* k_pool, const void* v_pool,
                const void* table, const void* kv_len, void* out, int B,
                int S, int KVH, int G, int D, int DV, int BS, int Tw,
                float scale, int window, float cap, cudaStream_t st) {
  const int rows_per_cta = min(S * G, kThreads * kMaxPairs / DV);
  const int smem = (rows_per_cta * D + BS * D + BS * DV + rows_per_cta * BS
                    + 5 * rows_per_cta) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_gqa_verify_kernel<T, Span>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B * KVH, (S * G + rows_per_cta - 1) / rows_per_cta);
  paged_gqa_verify_kernel<T, Span><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(kv_len), static_cast<float*>(out), S, KVH, G, D,
      DV, BS, Tw, rows_per_cta, scale, window, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* kv_len, void* out, int B, int S,
           int KVH, int G, int D, int DV, int BS, int Tw, float scale,
           int window, float cap, cudaStream_t st) {
  if (S == 1)
    return launch_rows<T, false>(q, k_pool, v_pool, table, kv_len, out, B, S,
                                 KVH, G, D, DV, BS, Tw, scale, window, cap,
                                 st);
  return launch_rows<T, true>(q, k_pool, v_pool, table, kv_len, out, B, S,
                              KVH, G, D, DV, BS, Tw, scale, window, cap, st);
}

}  // namespace

extern "C" int paged_gqa_verify_launch(const void* q, const void* k_pool,
                                       const void* v_pool, const void* table,
                                       const void* kv_len, void* out, int B,
                                       int S, int KVH, int G, int D, int DV,
                                       int BS, int Tw, float scale, int window,
                                       float cap, int dtype, void* stream) {
  if (DV > kThreads * kMaxPairs) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(q, k_pool, v_pool, table, kv_len, out, B, S, KVH, G,
                         D, DV, BS, Tw, scale, window, cap, st);
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, kv_len, out, B, S,
                                 KVH, G, D, DV, BS, Tw, scale, window, cap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
