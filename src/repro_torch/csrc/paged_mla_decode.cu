// paged_mla_decode: absorbed MLA flash-decoding over the paged latent pool,
// one query token per slot.
//
//   q_lat  float32 [B, H, R]      q_pe float32 [B, H, RD]
//   ckv    [n_blocks, BS, R]      kpe  [n_blocks, BS, RD]   (T = float or bf16)
//   table  int32 [B, Tw]          kv_len int32 [B]
//   out    float32 [B, H, R]      latent context; the caller up-projects it
//
// Replaces src/repro/kernels/flash_attention.py::paged_mla_decode
// (_paged_mla_body).  Scores are (q_lat . ckv + q_pe . kpe) * scale and the
// value operand is the latent cache itself.  Bound on the H100: device-memory
// bytes — every latent position a slot owns is read once, (R + RD) values,
// against 2 * (R + RD) + 2 * R FLOPs per head.  Design: the TPU kernel keeps
// all H heads' [H, R] f32 accumulator of a slot in VMEM; at deepseek-v2-lite
// width that is 16 x 512 x 4 B = 32 KB, too much for one CTA's registers, so
// the heads split across CTAs: one CTA per (slot, head), 128 threads, each
// thread owning R / 128 accumulator columns.  The CTA walks the slot's block
// table itself up to ceil(kv_len / BS) (the reference's trailing trash tiles
// are fully masked, so stopping there gives its result).  Each step stages
// physical block table[b, j] as f32 rows [ckv | kpe] in shared memory with
// 16-byte loads, several in flight per thread before any is used (at 8 slots
// there is one CTA per SM, so load latency is what a step waits on); one
// warp per position computes the concatenated (R + RD)-long score dot, the
// kv_len mask applies as in the reference, and the f32 online-softmax state
// m / l / acc is updated.  The H CTAs of a slot read the same blocks, the
// first from device memory and the rest mostly from L2.  Few slots give few
// CTAs; a split over the kv axis with a combine pass is later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairs = 8;  // accumulator columns per thread: R <= 1024
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_mla_decode_kernel(const float* __restrict__ q_lat,
                        const float* __restrict__ q_pe,
                        const T* __restrict__ ckv, const T* __restrict__ kpe,
                        const int* __restrict__ table,
                        const int* __restrict__ kv_len,
                        float* __restrict__ out, int H, int R, int RD, int BS,
                        int Tw, float scale) {
  extern __shared__ float smem[];
  const int D = R + RD;
  float* qs = smem;          // [D]      this head's query: q_lat | q_pe
  float* ks = qs + D;        // [BS, D]  row t: ckv(t) | kpe(t)
  float* ps = ks + BS * D;   // [BS]     scores, then probabilities
  __shared__ float m_s, l_s, c_s;  // running max, denominator, rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;  // slot * H + head
  const int b = bh / H;
  const int L = kv_len[b];
  const int steps = min((L + BS - 1) / BS, Tw);

  for (int i = tid; i < R; i += kThreads) qs[i] = q_lat[(size_t)bh * R + i];
  for (int i = tid; i < RD; i += kThreads) qs[R + i] = q_pe[(size_t)bh * RD + i];
  if (tid == 0) {
    m_s = kNeg;
    l_s = 0.f;
  }
  float acc[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) acc[i] = 0.f;

  for (int j = 0; j < steps; ++j) {
    __syncthreads();  // previous step done with ks / ps
    const size_t pid = (size_t)table[(size_t)b * Tw + j];
    stage_rows(ks, D, ckv + pid * BS * R, BS, R);
    stage_rows(ks + R, D, kpe + pid * BS * RD, BS, RD);
    __syncthreads();
    for (int t = warp; t < BS; t += kWarps) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s = fmaf(qs[d], ks[t * D + d], s);
      s = warp_sum(s);
      if (lane == 0) ps[t] = (j * BS + t < L) ? s * scale : kNeg;
    }
    __syncthreads();
    if (tid == 0) {
      const float m_prev = m_s;
      float m_new = m_prev;
      for (int t = 0; t < BS; ++t) m_new = fmaxf(m_new, ps[t]);
      float sum = 0.f;
      for (int t = 0; t < BS; ++t) {
        const float p = (j * BS + t < L) ? expf(ps[t] - m_new) : 0.f;
        ps[t] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      l_s = l_s * corr + sum;
      m_s = m_new;
      c_s = corr;
    }
    __syncthreads();
    const float corr = c_s;
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int c = tid + i * kThreads;
      if (c >= R) break;
      float a = acc[i] * corr;
      for (int t = 0; t < BS; ++t) a = fmaf(ps[t], ks[t * D + c], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  const float inv = 1.f / fmaxf(l_s, 1e-30f);
  float* orow = out + (size_t)bh * R;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int c = tid + i * kThreads;
    if (c >= R) break;
    orow[c] = acc[i] * inv;
  }
}

template <typename T>
int launch(const void* q_lat, const void* q_pe, const void* ckv,
           const void* kpe, const void* table, const void* kv_len, void* out,
           int B, int H, int R, int RD, int BS, int Tw, float scale,
           cudaStream_t st) {
  const int smem = ((R + RD) * (BS + 1) + BS) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_mla_decode_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_mla_decode_kernel<T><<<B * H, kThreads, smem, st>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_pe),
      static_cast<const T*>(ckv), static_cast<const T*>(kpe),
      static_cast<const int*>(table), static_cast<const int*>(kv_len),
      static_cast<float*>(out), H, R, RD, BS, Tw, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_mla_decode_launch(const void* q_lat, const void* q_pe,
                                       const void* ckv_pool,
                                       const void* kpe_pool, const void* table,
                                       const void* kv_len, void* out, int B,
                                       int H, int R, int RD, int BS, int Tw,
                                       float scale, int dtype, void* stream) {
  if (R > kThreads * kMaxPairs) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(q_lat, q_pe, ckv_pool, kpe_pool, table, kv_len, out,
                         B, H, R, RD, BS, Tw, scale, st);
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(q_lat, q_pe, ckv_pool, kpe_pool, table,
                                 kv_len, out, B, H, R, RD, BS, Tw, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
