// nm_xwt: prefill-shaped Y[S, O] = X[S, K] . W_sp^T, W compressed N:M
// (values [O, K/M*N] + int8 in-block indices).
//
// Replaces src/repro/kernels/nm_spmm.py::nm_xwt_kernel (_xwt_body with
// _decompress_tile, int8 indices).  Bound on the H100: at the serving
// prefill lengths the compressed weight bytes bound it (the sparse MACs at
// the bf16 tensor-core rate take less time than reading the weights once).
// Design: one CTA per output tile loops over K.  Per step it stages the X
// tile in shared memory and decompresses the W tile into a dense tile in
// shared memory with the reference's block*M + idx placement; each thread
// issues all of its global loads (16-byte runs where the shapes allow)
// before its first shared store, since an unpipelined K loop is bound by
// load latency.  bf16 tiles (64x64, K step 64) feed mma.sync m16n8k16
// tensor-core products with f32 accumulators, eight warps of 32x16 each;
// f32 tiles (32x64) take an f32 FMA loop with 2x4 register micro-tiles.
// Ragged S, O and K edges are masked in the loads and the store; nothing is
// padded.  Not yet: TMA, wgmma, a multi-stage pipeline.
#include "common.cuh"

namespace {

constexpr int kBK = 64;  // K per step (a multiple of M)

// Dense [rows, kBK] tile of W rows c0.. at K offset k0, written through
// put(row_in_tile, col_in_tile, value).
template <typename T, typename Put>
__device__ __forceinline__ void decompress_tile(const T* vals,
                                                const int8_t* idx, int rows,
                                                int c0, int k0, int O, int K,
                                                int n, int m, Put put) {
  const int nblk = kBK / m;
  const int nnz = K / m * n;
  for (int i = threadIdx.x; i < rows * nblk; i += blockDim.x) {
    const int c = i / nblk;
    const int j = i % nblk;
    const int row = c0 + c;
    const int kb = k0 + j * m;  // first column of this M-block
    const bool live = row < O && kb < K;
    const size_t e = (size_t)row * nnz + (size_t)(kb / m) * n;
    for (int p = 0; p < m; ++p) {
      float v = 0.f;
      if (live) {
        for (int s = 0; s < n; ++s)
          if (idx[e + s] == p) v += to_f32(vals[e + s]);
      }
      put(c, j * m + p, v);
    }
  }
}

// ------------------------------------------------------------ f32: FMA path

constexpr int kFBM = 32, kFBN = 64, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
nm_xwt_f32_kernel(const float* __restrict__ x, const float* __restrict__ vals,
                  const int8_t* __restrict__ idx, float* __restrict__ y,
                  int S, int O, int K, int n, int m) {
  __shared__ float xs[kFBM][kBK + 1];
  __shared__ float ws[kBK][kFBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16*j
  const int ty = tid / 16;  // output rows ty + 16*i
  const int s0 = blockIdx.y * kFBM;
  const int c0 = blockIdx.x * kFBN;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // previous step's tiles fully consumed
    for (int i = tid; i < kFBM * kBK; i += kFThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int s = s0 + r, k = k0 + kk;
      xs[r][kk] = (s < S && k < K) ? x[(size_t)s * K + k] : 0.f;
    }
    decompress_tile(vals, idx, kFBN, c0, k0, O, K, n, m,
                    [&](int c, int kk, float v) { ws[kk][c] = v; });
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float a0 = xs[ty][kk];
      const float a1 = xs[ty + 16][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = ws[kk][tx + 16 * j];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = s0 + ty + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < O) y[(size_t)s * O + c] = acc[i][j];
    }
  }
}

// --------------------------------------------------- bf16: tensor-core path

constexpr int kMBM = 64, kMBN = 64, kMThreads = 256;
constexpr int kPad = 8;  // row stride kBK+8 bf16 = 144 B: conflict-free frags
typedef __nv_bfloat16 bf16;

// X tile [kMBM, kBK] -> xs; vec: K % 8 == 0 and x 16-byte aligned, so each
// 8-column run is wholly inside or outside the matrix and moves as one
// 16-byte load.
__device__ __forceinline__ void load_x_tile(bf16 (*xs)[kBK + kPad],
                                            const bf16* x, int S, int K,
                                            int s0, int k0, bool vec) {
  if (vec) {
    for (int v = threadIdx.x; v < kMBM * kBK / 8; v += blockDim.x) {
      const int r = v / (kBK / 8), kv = (v % (kBK / 8)) * 8;
      const int s = s0 + r, k = k0 + kv;
      uint4 run = make_uint4(0, 0, 0, 0);
      if (s < S && k < K)
        run = *reinterpret_cast<const uint4*>(x + (size_t)s * K + k);
      *reinterpret_cast<uint4*>(&xs[r][kv]) = run;
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < kMBM * kBK; i += blockDim.x) {
      const int r = i / kBK, kk = i % kBK;
      const int s = s0 + r, k = k0 + kk;
      xs[r][kk] = (s < S && k < K) ? x[(size_t)s * K + k] : zero;
    }
  }
}

// W tile decompress, fast form: each thread takes a run of 8 consecutive
// slots of one row (one 16-byte value load + one 8-byte index load, issued
// before any store), which covers 8/n whole M-blocks, and writes their
// 8*M/n dense columns: zeros, then the n values at block*M + idx.  Needs n
// to divide 8, nnz % 8 == 0 and aligned operands (checked by the launcher).
__device__ __forceinline__ void decompress_runs(bf16 (*ws)[kBK + kPad],
                                                const bf16* vals,
                                                const int8_t* idx, int O,
                                                int K, int n, int m, int c0,
                                                int k0) {
  const int nnz = K / m * n;
  const int runs = kBK / m * n / 8;  // 8-slot runs per row per K step
  const bf16 zero = __float2bfloat16(0.f);
  for (int v = threadIdx.x; v < kMBN * runs; v += blockDim.x) {
    const int c = v / runs, q = v % runs;
    const int row = c0 + c;
    const int slot = k0 / m * n + q * 8;  // first slot of the run
    const int col0 = q * 8 / n * m;       // its first dense column
    const bool live = row < O && slot < nnz;
    bf16 vv[8];
    int8_t ii[8];
    if (live) {
      const uint4 rv = *reinterpret_cast<const uint4*>(vals + (size_t)row * nnz + slot);
      const uint2 ri = *reinterpret_cast<const uint2*>(idx + (size_t)row * nnz + slot);
      memcpy(vv, &rv, 16);
      memcpy(ii, &ri, 8);
    }
    for (int p = 0; p < 8 / n * m; ++p) ws[c][col0 + p] = zero;
    if (live) {
#pragma unroll
      for (int e = 0; e < 8; ++e) ws[c][col0 + e / n * m + ii[e]] = vv[e];
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kMThreads)
nm_xwt_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ vals,
                   const int8_t* __restrict__ idx,
                   __nv_bfloat16* __restrict__ y, int S, int O, int K, int n,
                   int m, bool vec_x, bool runs_w) {
  __shared__ __align__(16) bf16 xs[kMBM][kBK + kPad];  // [s][k]
  __shared__ __align__(16) bf16 ws[kMBN][kBK + kPad];  // [o][k]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: 32 rows x 16 cols
  const int g = lane / 4, t = lane % 4;    // mma fragment coordinates
  const int s0 = blockIdx.y * kMBM;
  const int c0 = blockIdx.x * kMBN;
  float acc[2][2][4] = {};  // [m16 tile][n8 tile][fragment]

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    load_x_tile(xs, x, S, K, s0, k0, vec_x);
    if (runs_w) {
      decompress_runs(ws, vals, idx, O, K, n, m, c0, k0);
    } else {
      decompress_tile(vals, idx, kMBN, c0, k0, O, K, n, m,
                      [&](int c, int kk, float v) {
                        ws[c][kk] = __float2bfloat16(v);  // exact: one value
                      });
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        a[mi][0] = ld_pair(&xs[r][kk + 2 * t]);
        a[mi][1] = ld_pair(&xs[r + 8][kk + 2 * t]);
        a[mi][2] = ld_pair(&xs[r][kk + 2 * t + 8]);
        a[mi][3] = ld_pair(&xs[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int c = wn * 16 + ni * 8 + g;
        b[ni][0] = ld_pair(&ws[c][kk + 2 * t]);
        b[ni][1] = ld_pair(&ws[c][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // fragment rows g and g + 8
        const int s = s0 + wm * 32 + mi * 16 + g + 8 * h;
        if (s >= S) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = c0 + wn * 16 + ni * 8 + 2 * t + q;
          if (c < O) y[(size_t)s * O + c] = __float2bfloat16(acc[mi][ni][2 * h + q]);
        }
      }
}

}  // namespace

extern "C" int nm_xwt_launch(const void* x, const void* vals, const void* idx,
                             void* y, int S, int O, int K, int n, int m,
                             int dtype, void* stream) {
  if (kBK % m != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32) {
    const dim3 grid((O + kFBN - 1) / kFBN, (S + kFBM - 1) / kFBM);
    nm_xwt_f32_kernel<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(vals),
        static_cast<const int8_t*>(idx), static_cast<float*>(y), S, O, K, n, m);
  } else if (dtype == REPRO_DTYPE_BF16) {
    const dim3 grid((O + kMBN - 1) / kMBN, (S + kMBM - 1) / kMBM);
    const auto aligned = [](const void* p, uintptr_t a) {
      return reinterpret_cast<uintptr_t>(p) % a == 0;
    };
    const int nnz = K / m * n;
    const bool vec_x = K % 8 == 0 && aligned(x, 16);
    const bool runs_w = 8 % n == 0 && nnz % 8 == 0 && (kBK / m * n) % 8 == 0
                        && aligned(vals, 16) && aligned(idx, 8);
    nm_xwt_bf16_kernel<<<grid, kMThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(vals),
        static_cast<const int8_t*>(idx), static_cast<bf16*>(y), S, O, K, n, m,
        vec_x, runs_w);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
