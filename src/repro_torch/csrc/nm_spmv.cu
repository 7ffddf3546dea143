// nm_spmv: decode-shaped Y[B, O] = X[B, K] . W_sp^T on the compressed N:M
// stream (values [O, K/M*N] + int8 in-block indices).
//
// Replaces src/repro/kernels/nm_spmv.py::nm_spmv_kernel (gather body).
// Bound on the H100: device-memory bytes.  Each weight row is read once
// (values + indices, 3/4 of a dense bf16 row at 2:4); the FLOPs are N/M of a
// dense GEMV and sit far below the FMA rate.  Design: the TPU kept a (B, bk)
// x slice resident in VMEM across the O sweep; here each CTA stages a
// K-chunk of x for up to 8 batch rows in shared memory, in x's own dtype
// (32 KB), with 16-byte loads that are all issued before the first store.
// Each warp owns one output row and streams its values and indices with
// lane-interleaved, coalesced loads, unrolled 8 deep so each lane keeps 16
// loads in flight (a decode step is latency-bound on the weight stream
// otherwise); neighbouring lanes read neighbouring slots, so their gathers
// x[b, block*M + idx] hit different banks.  Accumulation is f32 in
// registers, reduced with warp shuffles.  Batches above 8 take more CTAs
// along grid.y.
//
// nm_spmv_onehot_launch is the reference's second body (mode="onehot",
// nm_spmv.py:43-47): decompress each W tile, then a dense dot.  Same bytes
// and the same bound (the compressed stream); the dense MACs are 2 * B * O
// * K, far below the tensor-core rate.  bf16 at N:M in {1:2, 1:4, 2:4, 2:8}
// takes the tensor-core tile body of nm_mma.cuh (shared with nm_xwt) with
// the batch on n = 8 (one 8-row n-tile per warp; batches above 8 take more
// CTAs along grid.y): a cp.async ring of 256-column stages, W
// decompressed in registers straight into mma.sync A fragments, the four
// warps of a CTA sharing each stage's supersteps (summed in shared memory
// in warp order) and K split across CTAs so that every decode shape fills
// the card (partial sums added in split order by a second kernel; no float
// atomics).  The plan comes from the wrapper (kernels/nm_spmv.py).  f32,
// and bf16 at other N:M, keep the first body: one CTA per 32 output rows
// and 8 batch rows, per K step of 64 the x tile staged and the W tile
// decompressed (nm_tile.cuh) into f32 shared memory, one f32 FMA dot per
// (row, batch) thread.
#include "nm_mma.cuh"

namespace {

constexpr int kWarps = 8;             // warps per CTA
constexpr int kRows = 1;              // output rows per warp
constexpr int kBGroup = 8;            // batch rows per CTA
constexpr int kStageBytes = 32768;    // x chunk: 8 * kc * sizeof(T)

// xs[b][k] = x[b0 + b][k0 + k] for k < klen, b < nb.  vec: K and the chunk
// are multiples of 16/sizeof(T) and x is 16-byte aligned, so each thread
// moves 16-byte runs, one per batch row, all loads in flight together.
template <typename T>
__device__ __forceinline__ void stage_x(T* xs, const T* x, int K, int k0,
                                        int klen, int kc, int b0, int nb,
                                        bool vec) {
  constexpr int VK = 16 / sizeof(T);
  if (vec) {
    for (int v = threadIdx.x; v < klen / VK; v += blockDim.x) {
      uint4 run[kBGroup];
#pragma unroll
      for (int b = 0; b < kBGroup; ++b)
        if (b < nb)
          run[b] = *reinterpret_cast<const uint4*>(
              x + (size_t)(b0 + b) * K + k0 + v * VK);
#pragma unroll
      for (int b = 0; b < kBGroup; ++b)
        if (b < nb) *reinterpret_cast<uint4*>(xs + b * kc + v * VK) = run[b];
    }
  } else {
    for (int b = 0; b < nb; ++b)
      for (int k = threadIdx.x; k < klen; k += blockDim.x)
        xs[b * kc + k] = x[(size_t)(b0 + b) * K + k0 + k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 4)
nm_spmv_kernel(const T* __restrict__ x, const T* __restrict__ vals,
               const int8_t* __restrict__ idx, T* __restrict__ y, int B,
               int O, int K, int n, int m, int kc, int nshift, bool vec) {
  __shared__ __align__(16) unsigned char stage[kStageBytes];
  T* xs = reinterpret_cast<T*>(stage);  // [8][kc]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * kWarps + warp) * kRows;
  const int b0 = blockIdx.y * kBGroup;
  const int nb = min(kBGroup, B - b0);
  const int nnz = K / m * n;

  float acc[kRows][kBGroup];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int b = 0; b < kBGroup; ++b) acc[r][b] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kc) {
    const int klen = min(kc, K - k0);
    __syncthreads();  // every warp is done with the previous chunk
    stage_x(xs, x, K, k0, klen, kc, b0, nb, vec);
    __syncthreads();
    const int e0 = k0 / m * n;  // first slot of this chunk
    const int ecount = klen / m * n;
#pragma unroll 8
    for (int e = lane; e < ecount; e += 32) {
      const int blk = nshift >= 0 ? (e >> nshift) : (e / n);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int o = row0 + r;
        if (o >= O) continue;
        const size_t at = (size_t)o * nnz + e0 + e;
        const float w = to_f32(vals[at]);
        const T* col = xs + blk * m + idx[at];
#pragma unroll
        for (int b = 0; b < kBGroup; ++b)
          if (b < nb) acc[r][b] = fmaf(w, to_f32(col[b * kc]), acc[r][b]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int o = row0 + r;
#pragma unroll
    for (int b = 0; b < kBGroup; ++b) {
      const float s = warp_sum(acc[r][b]);
      if (lane == 0 && o < O && b < nb) y[(size_t)(b0 + b) * O + o] = from_f32<T>(s);
    }
  }
}

template <typename T>
int launch(const void* x, const void* vals, const void* idx, void* y, int B,
           int O, int K, int n, int m, cudaStream_t s) {
  constexpr int VK = 16 / sizeof(T);
  // chunk: fills the stage, a multiple of M and of the 16-byte run
  const int kmax = kStageBytes / (kBGroup * (int)sizeof(T));
  int unit = m;
  while (unit % VK) unit += m;
  const int kc = kmax - kmax % unit;
  if (kc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = K % VK == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int nshift = (n & (n - 1)) == 0 ? __builtin_ctz(n) : -1;
  const dim3 grid((O + kWarps * kRows - 1) / (kWarps * kRows),
                  (B + kBGroup - 1) / kBGroup);
  nm_spmv_kernel<T><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(vals),
      static_cast<const int8_t*>(idx), static_cast<T*>(y), B, O, K, n, m, kc,
      nshift, vec);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ onehot body

constexpr int kOhRows = 32;                  // output rows per CTA
constexpr int kOhThreads = kOhRows * kBGroup;  // one (row, batch) each

template <typename T>
__global__ void __launch_bounds__(kOhThreads)
nm_spmv_onehot_kernel(const T* __restrict__ x, const T* __restrict__ vals,
                      const int8_t* __restrict__ idx, T* __restrict__ y,
                      int B, int O, int K, int n, int m) {
  __shared__ float xs[kBGroup][nm::kBK + 1];
  __shared__ float ws[kOhRows][nm::kBK + 1];
  const int tid = threadIdx.x;
  const int r = tid / kBGroup, b = tid % kBGroup;
  const int o0 = blockIdx.x * kOhRows;
  const int b0 = blockIdx.y * kBGroup;
  const int nb = min(kBGroup, B - b0);
  const nm::Int8Idx reader{idx, K / m * n};
  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += nm::kBK) {
    __syncthreads();  // every thread is done with the previous tiles
    for (int i = tid; i < kBGroup * nm::kBK; i += kOhThreads) {
      const int bb = i / nm::kBK, kk = i % nm::kBK;
      const int k = k0 + kk;
      xs[bb][kk] = (bb < nb && k < K) ? to_f32(x[(size_t)(b0 + bb) * K + k]) : 0.f;
    }
    nm::decompress_tile(vals, reader, kOhRows, o0, k0, O, K, n, m,
                        [&](int c, int kk, float v) { ws[c][kk] = v; });
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < nm::kBK; ++kk) acc = fmaf(ws[r][kk], xs[b][kk], acc);
  }
  if (o0 + r < O && b < nb) y[(size_t)(b0 + b) * O + o0 + r] = from_f32<T>(acc);
}

template <typename T>
int launch_onehot(const void* x, const void* vals, const void* idx, void* y,
                  int B, int O, int K, int n, int m, cudaStream_t s) {
  if (m <= 0 || nm::kBK % m != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((O + kOhRows - 1) / kOhRows, (B + kBGroup - 1) / kBGroup);
  nm_spmv_onehot_kernel<T><<<grid, kOhThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(vals),
      static_cast<const int8_t*>(idx), static_cast<T*>(y), B, O, K, n, m);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- onehot body, bf16 tensor cores

using nm::mma::Int8Stream;
using nm::mma::TileArgs;

template <int N, int M>
__global__ void __launch_bounds__(256)
nm_spmv_onehot_mma_kernel(TileArgs<Int8Stream> a) {
  nm::mma::tile_body<N, M, 1>(a);
}

__global__ void nm_spmv_onehot_reduce_kernel(const float* ws, __nv_bfloat16* y,
                                             int count, int splits) {
  nm::mma::reduce_splits(ws, y, count, splits);
}

template <int N, int M>
int run_onehot_mma(const TileArgs<Int8Stream>& a, cudaStream_t s) {
  static int smem_set = 48 * 1024;  // per kernel, in this library
  return nm::mma::launch<N, M, 1>(nm_spmv_onehot_mma_kernel<N, M>,
                                  nm_spmv_onehot_reduce_kernel, a, s, smem_set);
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

int launch_onehot_mma(const void* x, const void* vals, const void* idx, void* y,
                      int B, int O, int K, int n, int m,
                      const nm::mma::Plan& plan, const nm::mma::Layout& ly,
                      void* ws, cudaStream_t s) {
  if (plan.nt != 1 || m <= 0 || K % m) return static_cast<int>(cudaErrorInvalidValue);
  const int nnz = K / m * n;
  TileArgs<Int8Stream> a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.vals = static_cast<const __nv_bfloat16*>(vals);
  a.idx = Int8Stream{static_cast<const int8_t*>(idx), nnz,
                     nnz % 16 == 0 && aligned(idx, 16)};
  a.y = static_cast<__nv_bfloat16*>(y);
  a.ws = static_cast<float*>(ws);
  a.R = B, a.O = O, a.K = K;
  a.pl = plan;
  a.ly = ly;
  a.vvec = nnz % 8 == 0 && aligned(vals, 16);
  a.xvec = K % 8 == 0 && aligned(x, 16);
  if (n == 1 && m == 2) return run_onehot_mma<1, 2>(a, s);
  if (n == 1 && m == 4) return run_onehot_mma<1, 4>(a, s);
  if (n == 2 && m == 4) return run_onehot_mma<2, 4>(a, s);
  if (n == 2 && m == 8) return run_onehot_mma<2, 8>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int nm_spmv_launch(const void* x, const void* vals, const void* idx,
                              void* y, int B, int O, int K, int n, int m,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32) return launch<float>(x, vals, idx, y, B, O, K, n, m, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(x, vals, idx, y, B, O, K, n, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// plan: the tensor-core body's launch plan (nt, ws, wo, wk, ss, stages,
// splits, kper) and its stage layout (vstride, istride, xstride, stage)
// from the wrapper, nt = 0 for the first body; ws: the f32 split workspace
// [splits, B, O] when splits > 1.
extern "C" int nm_spmv_onehot_launch(const void* x, const void* vals,
                                     const void* idx, void* y, int B, int O,
                                     int K, int n, int m, int dtype, int nt,
                                     int wrows, int wo, int wk, int ss,
                                     int stages, int splits, int kper, int vstride,
                                     int istride, int xstride, int stage, void* ws,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt != 0) {
    if (dtype != REPRO_DTYPE_BF16) return static_cast<int>(cudaErrorInvalidValue);
    const nm::mma::Plan plan{nt, wrows, wo, wk, ss, stages, splits, kper};
    const nm::mma::Layout ly{vstride, istride, xstride, stage, 0, 0, 0};
    return launch_onehot_mma(x, vals, idx, y, B, O, K, n, m, plan, ly, ws, s);
  }
  if (dtype == REPRO_DTYPE_F32)
    return launch_onehot<float>(x, vals, idx, y, B, O, K, n, m, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch_onehot<__nv_bfloat16>(x, vals, idx, y, B, O, K, n, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
