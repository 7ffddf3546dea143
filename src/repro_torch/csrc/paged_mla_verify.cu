// paged_mla_verify: absorbed MLA flash-decoding over the paged latent pool
// for a span of S consecutive query tokens per slot.  The one-token decode
// is the span S = 1: ``paged_mla_decode`` and ``paged_mla_verify``
// (kernels/flash_attention.py) both launch this kernel, each with its own
// launch counter.
//
//   q_lat  float32 [B, S, H, R]   q_pe float32 [B, S, H, RD]
//   ckv    [n_blocks, BS, R]      kpe  [n_blocks, BS, RD]   (T = float or bf16)
//   table  int32 [B, Tw]          kv_len int32 [B] (for span offset 0)
//   out    float32 [B, S, H, R]   latent context; the caller up-projects it
//
// Replaces src/repro/kernels/flash_attention.py::paged_mla_decode
// (_paged_mla_body) and ::paged_mla_verify, which launches paged_mla_decode
// once per span offset i with kv_len + i.  Scores are
// (q_lat . ckv + q_pe . kpe) * scale and the value operand is the latent
// cache itself.  Bound on the H100: device-memory bytes — every latent
// position a slot owns is read once, (R + RD) values, against
// 2 * (R + RD) + 2 * R FLOPs per query row and position; S separate
// launches would read each slot's blocks S times.  Design: the TPU kernel
// keeps all H heads' [H, R] f32 accumulator of a slot in VMEM; at
// deepseek-v2-lite width that is 16 x 512 x 4 B = 32 KB per span row, too
// much for one CTA's registers, so the heads split across CTAs: ONE launch
// for the span, a CTA per (slot, head) holding that head's span rows (up to
// kMaxRows per CTA; a longer span splits into more CTAs along grid.y), 128
// threads, each keeping R / 128 accumulator columns per row in registers.
// The CTA walks the slot's block table itself up to
// ceil((kv_len + S - 1) / BS) (the reference's trailing trash tiles are
// fully masked, so stopping there gives its result).  Each step stages
// physical block table[b, j] as f32 rows [ckv | kpe] in shared memory with
// 16-byte loads, several in flight per thread before any is used (at 8
// slots there is about one CTA per SM, so load latency is what a step
// waits on).  Row i sees kv_len + i positions and stops updating at its own
// ceil((kv_len + i) / BS) steps.  A row's operations — one warp per (row,
// position) score dot with lane-strided columns and a shuffle sum, the
// sequential softmax over a block by one thread, the accumulator update —
// never depend on the other rows, so span offset i equals an S = 1 launch
// at kv_len + i bit for bit.  S = 1 runs the one-row instance of the
// kernel, whose accumulator is R / 128 registers per thread instead of
// kMaxRows times that.  The H CTAs of a slot read the same blocks, the
// first from device memory and the rest mostly from L2; few slots give few
// CTAs, and a split over the kv axis with a combine pass is later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairs = 8;  // accumulator columns per thread: R <= 1024
constexpr int kMaxRows = 4;   // span rows per CTA (acc is kMaxRows x kMaxPairs)
constexpr float kNeg = -1e30f;
constexpr int kInFlight = 4;  // 16-byte loads per thread issued before use

// Stage `rows` x `cols` elements of `src` (row-major) as f32 into `dst` with
// leading dimension `ld`.  16-byte vector loads when every row starts
// 16-byte aligned, element loads otherwise.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const T* __restrict__ src,
                                           int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int n = rows * cols;
  if (cols % V == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n / V;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int base = 0; base < nv; base += kThreads * kInFlight) {
      uint4 buf[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int v = base + u * kThreads + threadIdx.x;
        if (v < nv) buf[u] = __ldg(s4 + v);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int v = base + u * kThreads + threadIdx.x;
        if (v < nv) {
          const T* e = reinterpret_cast<const T*>(&buf[u]);
          const int t = (v * V) / cols, c = (v * V) % cols;
#pragma unroll
          for (int k = 0; k < V; ++k) dst[t * ld + c + k] = to_f32(e[k]);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      dst[(i / cols) * ld + i % cols] = to_f32(src[i]);
  }
}

template <typename T, int MaxRows>
__global__ void __launch_bounds__(kThreads)
paged_mla_verify_kernel(const float* __restrict__ q_lat,
                        const float* __restrict__ q_pe,
                        const T* __restrict__ ckv, const T* __restrict__ kpe,
                        const int* __restrict__ table,
                        const int* __restrict__ kv_len,
                        float* __restrict__ out, int S, int H, int R, int RD,
                        int BS, int Tw, float scale) {
  extern __shared__ float smem[];
  const int D = R + RD;
  const int i0 = blockIdx.y * MaxRows;          // first span row of this CTA
  const int NR = min(MaxRows, S - i0);           // rows of this CTA
  float* qs = smem;            // [NR, D]  row i's query: q_lat | q_pe
  float* ks = qs + NR * D;     // [BS, D]  row t: ckv(t) | kpe(t)
  float* ps = ks + BS * D;     // [NR, BS] scores, then probabilities
  __shared__ float m_s[MaxRows], l_s[MaxRows], c_s[MaxRows];
  __shared__ int st_s[MaxRows];  // block steps row r updates in

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int L0 = kv_len[b] + i0;                 // positions row 0 sees
  const int steps = min((L0 + NR - 1 + BS - 1) / BS, Tw);

  for (int r = 0; r < NR; ++r) {
    const size_t row = ((size_t)b * S + i0 + r) * H + h;
    for (int i = tid; i < R; i += kThreads) qs[r * D + i] = q_lat[row * R + i];
    for (int i = tid; i < RD; i += kThreads)
      qs[r * D + R + i] = q_pe[row * RD + i];
  }
  if (tid < NR) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
    st_s[tid] = min((L0 + tid + BS - 1) / BS, Tw);
  }
  float acc[MaxRows][kMaxPairs];
#pragma unroll
  for (int r = 0; r < MaxRows; ++r)
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) acc[r][i] = 0.f;

  for (int j = 0; j < steps; ++j) {
    __syncthreads();  // previous step done with ks / ps
    const size_t pid = (size_t)table[(size_t)b * Tw + j];
    stage_rows(ks, D, ckv + pid * BS * R, BS, R);
    stage_rows(ks + R, D, kpe + pid * BS * RD, BS, RD);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MaxRows; ++r) {
      if (r >= NR) break;
      for (int t = warp; t < BS; t += kWarps) {
        float s = 0.f;
        for (int d = lane; d < D; d += 32)
          s = fmaf(qs[r * D + d], ks[t * D + d], s);
        s = warp_sum(s);
        if (lane == 0)
          ps[r * BS + t] = (j * BS + t < L0 + r) ? s * scale : kNeg;
      }
    }
    __syncthreads();
    if (tid < NR && j < st_s[tid]) {
      const int r = tid, L = L0 + r;
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int t = 0; t < BS; ++t) m_new = fmaxf(m_new, ps[r * BS + t]);
      float sum = 0.f;
      for (int t = 0; t < BS; ++t) {
        const float p = (j * BS + t < L) ? expf(ps[r * BS + t] - m_new) : 0.f;
        ps[r * BS + t] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      l_s[r] = l_s[r] * corr + sum;
      m_s[r] = m_new;
      c_s[r] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MaxRows; ++r) {
      if (r >= NR || j >= st_s[r]) continue;
      const float corr = c_s[r];
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        const int c = tid + i * kThreads;
        if (c >= R) break;
        float a = acc[r][i] * corr;
        for (int t = 0; t < BS; ++t) a = fmaf(ps[r * BS + t], ks[t * D + c], a);
        acc[r][i] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MaxRows; ++r) {
    if (r >= NR) break;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    float* orow = out + (((size_t)b * S + i0 + r) * H + h) * R;
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int c = tid + i * kThreads;
      if (c >= R) break;
      orow[c] = acc[r][i] * inv;
    }
  }
}

template <typename T, int MaxRows>
int launch_rows(const void* q_lat, const void* q_pe, const void* ckv,
                const void* kpe, const void* table, const void* kv_len,
                void* out, int B, int S, int H, int R, int RD, int BS, int Tw,
                float scale, cudaStream_t st) {
  const int rows = min(S, MaxRows);
  const int smem = ((R + RD) * (rows + BS) + rows * BS) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_mla_verify_kernel<T, MaxRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B * H, (S + MaxRows - 1) / MaxRows);
  paged_mla_verify_kernel<T, MaxRows><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_pe),
      static_cast<const T*>(ckv), static_cast<const T*>(kpe),
      static_cast<const int*>(table), static_cast<const int*>(kv_len),
      static_cast<float*>(out), S, H, R, RD, BS, Tw, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q_lat, const void* q_pe, const void* ckv,
           const void* kpe, const void* table, const void* kv_len, void* out,
           int B, int S, int H, int R, int RD, int BS, int Tw, float scale,
           cudaStream_t st) {
  if (S == 1)
    return launch_rows<T, 1>(q_lat, q_pe, ckv, kpe, table, kv_len, out, B, S,
                             H, R, RD, BS, Tw, scale, st);
  return launch_rows<T, kMaxRows>(q_lat, q_pe, ckv, kpe, table, kv_len, out,
                                  B, S, H, R, RD, BS, Tw, scale, st);
}

}  // namespace

extern "C" int paged_mla_verify_launch(const void* q_lat, const void* q_pe,
                                       const void* ckv_pool,
                                       const void* kpe_pool, const void* table,
                                       const void* kv_len, void* out, int B,
                                       int S, int H, int R, int RD, int BS,
                                       int Tw, float scale, int dtype,
                                       void* stream) {
  if (R > kThreads * kMaxPairs) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(q_lat, q_pe, ckv_pool, kpe_pool, table, kv_len, out,
                         B, S, H, R, RD, BS, Tw, scale, st);
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(q_lat, q_pe, ckv_pool, kpe_pool, table,
                                 kv_len, out, B, S, H, R, RD, BS, Tw, scale,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}
