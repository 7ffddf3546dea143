// flash_attention: fused attention over [BH, S, D], the prefill-shaped
// sibling of the paged decode kernels: O[bh] = softmax(mask(cap(Q K^T *
// scale))) V with q [BH, Sq, d], k [BH, Sk, d], v [BH, Sk, dv].
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_kernel
// (_fa_body).  Its semantics are kept: scale, then the softcap
// cap*tanh(s/cap), then the mask (causal qpos >= kpos, window qpos - kpos <
// window, qpos = q_off + i); masked scores are -1e30 and their p is forced
// to 0, the online-softmax m / l / acc state is f32, and the output is acc
// / max(l, 1e-30), so a row masked everywhere gives 0.  No block is skipped
// (the reference runs fully masked blocks too).  Ragged Sq and Sk are
// masked in the kernel.
//
// Bound on the H100: at the serving prefill widths the operations (2*(d +
// dv) FLOPs per query-key pair against (d + dv) values read once per key
// tile per q tile).  Design: one CTA of 8 warps per (bh, 32-row q tile);
// the q tile and each 32-key K / V tile are staged in f32 shared memory
// (d, dv <= 256; above 48 KB the launcher opts in to the larger dynamic
// shared memory).  Each warp owns 4 query rows; lane j scores key j of the
// tile for its 4 rows (one K read feeds 4 FMAs), the row max and sum are
// warp shuffles, and each lane accumulates dv/32 output columns of its 4
// rows, the probabilities broadcast by shuffle.  f32 FMAs throughout (no
// tensor cores yet): later work is mma / wgmma tiles and block skipping.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kBKv = 32;                    // keys per tile (one per lane)
constexpr int kMaxD = 256;
constexpr int kNV = kMaxD / 32;             // output columns per lane
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

size_t smem_bytes(int d, int dv) {
  return sizeof(float) * ((size_t)kBQ * d + (size_t)kBKv * (d + 1) + (size_t)kBKv * dv);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int d,
             int dv, float scale, int causal, int window, float cap,
             int q_off) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [kBQ][d]
  float* ks = qs + kBQ * d;         // [kBKv][d + 1]: lane j reads row j
  float* vs = ks + kBKv * (d + 1);  // [kBKv][dv]
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;  // this warp's rows in the tile
  const T* qb = q + (size_t)bh * Sq * d;
  const T* kb = k + (size_t)bh * Sk * d;
  const T* vb = v + (size_t)bh * Sk * dv;

  for (int i = threadIdx.x; i < kBQ * d; i += blockDim.x) {
    const int r = i / d;
    qs[i] = q0 + r < Sq ? to_f32(qb[(size_t)q0 * d + i]) : 0.f;
  }
  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp][kNV];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = kNeg;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kNV; ++c) acc[r][c] = 0.f;
  }

  for (int j0 = 0; j0 < Sk; j0 += kBKv) {
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    for (int i = threadIdx.x; i < kBKv * d; i += blockDim.x) {
      const int j = i / d, c = i % d;
      ks[j * (d + 1) + c] = j0 + j < Sk ? to_f32(kb[(size_t)j0 * d + i]) : 0.f;
    }
    for (int i = threadIdx.x; i < kBKv * dv; i += blockDim.x) {
      const int j = i / dv;
      vs[i] = j0 + j < Sk ? to_f32(vb[(size_t)j0 * dv + i]) : 0.f;
    }
    __syncthreads();

    // scores of key j0 + lane against this warp's rows
    float s[kRowsPerWarp] = {};
    const float* kr = ks + lane * (d + 1);
    const float* qr = qs + r0 * d;
    for (int c = 0; c < d; ++c) {
      const float kv = kr[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(qr[r * d + c], kv, s[r]);
    }
    const int kpos = j0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float sr = s[r] * scale;
      if (cap > 0.f) sr = cap * tanhf(sr / cap);
      const int qpos = q_off + q0 + r0 + r;
      bool live = kpos < Sk;
      if (causal) live = live && qpos >= kpos;
      if (window >= 0) live = live && qpos - kpos < window;
      sr = live ? sr : kNeg;
      const float m_new = fmaxf(m_i[r], warp_max(sr));
      p[r] = live ? expf(sr - m_new) : 0.f;
      const float corr = expf(m_i[r] - m_new);
      l_i[r] = l_i[r] * corr + warp_sum(p[r]);
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < kNV; ++c) acc[r][c] *= corr;
    }
    // acc[r][:] += sum_j p[r][j] * v[j][:], lane owning columns lane + 32c
    for (int j = 0; j < kBKv; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = __shfl_sync(0xffffffffu, p[r], j);
      const float* vr = vs + j * dv;
#pragma unroll
      for (int c = 0; c < kNV; ++c) {
        const int col = lane + 32 * c;
        if (col < dv) {
          const float vv = vr[col];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(pj[r], vv, acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + r0 + r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l_i[r], 1e-30f);
    T* orow = o + ((size_t)bh * Sq + row) * dv;
#pragma unroll
    for (int c = 0; c < kNV; ++c) {
      const int col = lane + 32 * c;
      if (col < dv) orow[col] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Sk, int d, int dv, float scale, int causal, int window,
           float cap, int q_off, cudaStream_t s) {
  if (d <= 0 || dv <= 0 || d > kMaxD || dv > kMaxD || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(d, dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_kernel<T><<<grid, kWarps * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, d, dv, scale,
      causal, window, cap, q_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window < 0: no window; cap <= 0: no softcap
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int Sq,
                                      int Sk, int d, int dv, float scale,
                                      int causal, int window, float cap,
                                      int q_off, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(q, k, v, o, BH, Sq, Sk, d, dv, scale, causal, window,
                         cap, q_off, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, d, dv, scale, causal,
                                 window, cap, q_off, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
