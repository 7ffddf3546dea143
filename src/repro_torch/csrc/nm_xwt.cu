// The tiled N:M sparse-dense products: both orientations of the reference's
// src/repro/kernels/nm_spmm.py, one kernel body each for f32 and bf16.
//
//   nm_xwt   Y[S, O] = X[S, K] . W_sp^T  (nm_xwt_kernel / _xwt_body), the
//            W indices as int8 or as the paper's bit-packed words
//            (packed=True: _unpack_indices_tile + _decompress_tile)
//   nm_spmm  C[R, C] = A_sp[R, K] . B[K, C]  (nm_spmm_kernel / _spmm_body),
//            the paper's orientation
//
// Both compute out[rows, cols] = P[rows, K] . Q[cols, K]^T with one operand
// compressed: in xwt P = X is dense and Q = W sparse; in spmm P = A is
// sparse and Q^T = B dense.  The template parameter Spmm picks which tile is
// decompressed and which is staged; the index stream is a template
// parameter (nm::Int8Idx or nm::PackedIdx), so the packed kernel differs
// from the int8 one only in its index reads and its output is the same bit
// for bit.
//
// Bound on the H100: at the serving prefill lengths the compressed weight
// bytes (the MACs at the bf16 tensor-core rate take less time than reading
// the weights once); at the CNN GEMMs' widths (K up to 4608, tens of
// thousands of columns) the operations.
//
// bf16 nm_xwt (int8 and packed) at N:M in {1:2, 1:4, 2:4, 2:8} runs the
// tensor-core tile body of nm_mma.cuh (shared with the onehot nm_spmv
// body): one CTA covers every row of a call up to 128, so W is read once;
// output columns are tiled 32-128 wide and K is split where the card would
// otherwise be empty (partial sums added in split order, no float atomics);
// a 2-4 stage cp.async ring feeds values, indices (packed words as 16-byte
// copies where a row's words are 16-byte aligned) and X; W is decompressed
// in registers into mma.sync A fragments.  The plan (tile, splits, ring)
// comes from the wrapper (kernels/nm_spmm.py mma_plan) and does not depend
// on the index format, so the packed instance sums in the int8 instance's
// order and equals it bit for bit.
//
// The first bodies stay for the rest: one CTA per output tile loops over K;
// per 64-column step it stages the dense tile and decompresses the sparse
// tile into shared memory with the reference's block*M + idx placement,
// each thread issuing all of its global loads (16-byte runs where the
// shapes allow) before its first shared store.  bf16 tiles (64x64) feed
// mma.sync m16n8k16 with f32 accumulators, eight warps of 32x16 each: this
// is nm_spmm's bf16 body and nm_xwt's at other N:M.  f32 tiles (32x64, all
// three launchers) take an f32 FMA loop with 2x4 register micro-tiles.
// Ragged edges are masked in the loads and the store; nothing is padded.
#include "nm_mma.cuh"

namespace {

using nm::kBK;
typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ f32: FMA path

constexpr int kFBM = 32, kFBN = 64, kFThreads = 256;

// P is [rows, K] (xwt: dense X; spmm: compressed A), Q is [cols, K] (xwt:
// compressed W; spmm: dense B given as [K, cols]).  dense is the dense
// operand, vals/idx the compressed one.
template <bool Spmm, class Idx>
__global__ void __launch_bounds__(kFThreads)
nm_f32_kernel(const float* __restrict__ dense, const float* __restrict__ vals,
              Idx idx, float* __restrict__ y, int rows, int cols, int K,
              int n, int m) {
  __shared__ float xs[kFBM][kBK + 1];  // P tile [row][k]
  __shared__ float ws[kBK][kFBN + 1];  // Q tile [k][col]
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16*j
  const int ty = tid / 16;  // output rows ty + 16*i
  const int s0 = blockIdx.y * kFBM;
  const int c0 = blockIdx.x * kFBN;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // previous step's tiles fully consumed
    if constexpr (Spmm) {
      nm::decompress_tile(vals, idx, kFBM, s0, k0, rows, K, n, m,
                          [&](int r, int kk, float v) { xs[r][kk] = v; });
      for (int i = tid; i < kBK * kFBN; i += kFThreads) {  // along cols
        const int kk = i / kFBN, c = i % kFBN;
        const int k = k0 + kk, col = c0 + c;
        ws[kk][c] = (k < K && col < cols) ? dense[(size_t)k * cols + col] : 0.f;
      }
    } else {
      for (int i = tid; i < kFBM * kBK; i += kFThreads) {  // along K
        const int r = i / kBK, kk = i % kBK;
        const int s = s0 + r, k = k0 + kk;
        xs[r][kk] = (s < rows && k < K) ? dense[(size_t)s * K + k] : 0.f;
      }
      nm::decompress_tile(vals, idx, kFBN, c0, k0, cols, K, n, m,
                          [&](int c, int kk, float v) { ws[kk][c] = v; });
    }
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
    if (s >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < cols) y[(size_t)s * cols + c] = acc[i][j];
    }
  }
}

// --------------------------------------------------- bf16: tensor-core path

constexpr int kMBM = 64, kMBN = 64, kMThreads = 256;
constexpr int kStride = kBK + 8;  // 144 B rows: conflict-free fragments

// X tile [kMBM, kBK] -> xs; vec: K % 8 == 0 and x 16-byte aligned, so each
// 8-column run is wholly inside or outside the matrix and moves as one
// 16-byte load.
__device__ __forceinline__ void load_x_tile(bf16 (*xs)[kStride], const bf16* x,
                                            int S, int K, int s0, int k0,
                                            bool vec) {
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

// B tile [kBK, kMBN] of B [K, C] -> transposed bt[col][k], read along C;
// vec: C % 8 == 0 and b 16-byte aligned (8-column runs, one 16-byte load).
__device__ __forceinline__ void load_bt_tile(bf16 (*bt)[kStride], const bf16* b,
                                             int K, int C, int k0, int c0,
                                             bool vec) {
  const bf16 zero = __float2bfloat16(0.f);
  if (vec) {
    for (int v = threadIdx.x; v < kBK * kMBN / 8; v += blockDim.x) {
      const int kk = v / (kMBN / 8), cv = (v % (kMBN / 8)) * 8;
      const int k = k0 + kk, c = c0 + cv;
      uint4 run = make_uint4(0, 0, 0, 0);
      if (k < K && c < C)
        run = *reinterpret_cast<const uint4*>(b + (size_t)k * C + c);
      bf16 e[8];
      memcpy(e, &run, 16);
#pragma unroll
      for (int q = 0; q < 8; ++q) bt[cv + q][kk] = e[q];
    }
  } else {
    for (int i = threadIdx.x; i < kBK * kMBN; i += blockDim.x) {
      const int kk = i / kMBN, c = i % kMBN;
      const int k = k0 + kk, col = c0 + c;
      bt[c][kk] = (k < K && col < C) ? b[(size_t)k * C + col] : zero;
    }
  }
}

using nm::mma::mma_bf16;

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// vec_dense: the dense operand's 16-byte loads (see load_x_tile /
// load_bt_tile); runs: the sparse tile through decompress_runs.
template <bool Spmm, class Idx>
__global__ void __launch_bounds__(kMThreads)
nm_bf16_kernel(const bf16* __restrict__ dense, const bf16* __restrict__ vals,
               Idx idx, bf16* __restrict__ y, int rows, int cols, int K, int n,
               int m, bool vec_dense, bool runs) {
  __shared__ __align__(16) bf16 xs[kMBM][kStride];  // P tile [row][k]
  __shared__ __align__(16) bf16 ws[kMBN][kStride];  // Q tile [col][k]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: 32 rows x 16 cols
  const int g = lane / 4, t = lane % 4;    // mma fragment coordinates
  const int s0 = blockIdx.y * kMBM;
  const int c0 = blockIdx.x * kMBN;
  float acc[2][2][4] = {};  // [m16 tile][n8 tile][fragment]

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    // the sparse tile: rows r0.. of the compressed operand into sp
    bf16 (*sp)[kStride] = Spmm ? xs : ws;
    const int r0 = Spmm ? s0 : c0;
    const int nrows = Spmm ? rows : cols;
    if constexpr (Spmm)
      load_bt_tile(ws, dense, K, cols, k0, c0, vec_dense);
    else
      load_x_tile(xs, dense, rows, K, s0, k0, vec_dense);
    if (runs) {
      nm::decompress_runs<kMBN>(sp, vals, idx, nrows, K, n, m, r0, k0);
    } else {
      nm::decompress_tile(vals, idx, kMBN, r0, k0, nrows, K, n, m,
                          [&](int c, int kk, float v) {
                            sp[c][kk] = __float2bfloat16(v);  // exact: one value
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
        if (s >= rows) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = c0 + wn * 16 + ni * 8 + 2 * t + q;
          if (c < cols) y[(size_t)s * cols + c] = __float2bfloat16(acc[mi][ni][2 * h + q]);
        }
      }
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

// out[rows, cols]; dense is X [rows, K] (xwt) or B [K, cols] (spmm)
template <bool Spmm, class Idx>
int launch(const void* dense, const void* vals, Idx idx, bool idx_runs_ok,
           void* y, int rows, int cols, int K, int n, int m, int dtype,
           void* stream) {
  if (m <= 0 || kBK % m != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32) {
    const dim3 grid((cols + kFBN - 1) / kFBN, (rows + kFBM - 1) / kFBM);
    nm_f32_kernel<Spmm, Idx><<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(dense), static_cast<const float*>(vals), idx,
        static_cast<float*>(y), rows, cols, K, n, m);
  } else if (dtype == REPRO_DTYPE_BF16) {
    const dim3 grid((cols + kMBN - 1) / kMBN, (rows + kMBM - 1) / kMBM);
    const int nnz = K / m * n;
    const int dense_minor = Spmm ? cols : K;
    const bool vec_dense = dense_minor % 8 == 0 && aligned(dense, 16);
    const bool runs = 8 % n == 0 && nnz % 8 == 0 && (kBK / m * n) % 8 == 0
                      && aligned(vals, 16) && idx_runs_ok;
    nm_bf16_kernel<Spmm, Idx><<<grid, kMThreads, 0, st>>>(
        static_cast<const bf16*>(dense), static_cast<const bf16*>(vals), idx,
        static_cast<bf16*>(y), rows, cols, K, n, m, vec_dense, runs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------- bf16 nm_xwt: the tensor-core body

using nm::mma::Int8Stream;
using nm::mma::PackedStream;
using nm::mma::TileArgs;

template <int N, int M, int NT, class Idx>
__global__ void __launch_bounds__(256) nm_xwt_mma_kernel(TileArgs<Idx> a) {
  nm::mma::tile_body<N, M, NT>(a);
}

__global__ void nm_xwt_reduce_kernel(const float* ws, bf16* y, int count,
                                     int splits) {
  nm::mma::reduce_splits(ws, y, count, splits);
}

template <int N, int M, int NT, class Idx>
int run_nt(const TileArgs<Idx>& a, cudaStream_t s) {
  static int smem_set = 48 * 1024;  // per kernel, in this library
  return nm::mma::launch<N, M, NT>(nm_xwt_mma_kernel<N, M, NT, Idx>,
                                   nm_xwt_reduce_kernel, a, s, smem_set);
}

template <int N, int M, class Idx>
int run_mma(const TileArgs<Idx>& a, cudaStream_t s) {
  switch (a.pl.nt) {
    case 1: return run_nt<N, M, 1>(a, s);
    case 4: return run_nt<N, M, 4>(a, s);
    case 8: return run_nt<N, M, 8>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class Idx>
int launch_mma(const void* x, const void* vals, Idx idx, void* y, int S, int O,
               int K, int n, int m, int dtype, const nm::mma::Plan& plan,
               const nm::mma::Layout& ly, void* ws, void* stream) {
  if (dtype != REPRO_DTYPE_BF16 || m <= 0 || K % m)
    return static_cast<int>(cudaErrorInvalidValue);
  TileArgs<Idx> a{};
  a.x = static_cast<const bf16*>(x);
  a.vals = static_cast<const bf16*>(vals);
  a.idx = idx;
  a.y = static_cast<bf16*>(y);
  a.ws = static_cast<float*>(ws);
  a.R = S, a.O = O, a.K = K;
  a.pl = plan;
  a.ly = ly;
  a.vvec = (K / m * n) % 8 == 0 && aligned(vals, 16);
  a.xvec = K % 8 == 0 && aligned(x, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 1 && m == 2) return run_mma<1, 2>(a, s);
  if (n == 1 && m == 4) return run_mma<1, 4>(a, s);
  if (n == 2 && m == 4) return run_mma<2, 4>(a, s);
  if (n == 2 && m == 8) return run_mma<2, 8>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Y[S, O] = X[S, K] . W^T, W as values [O, K/M*N] + int8 indices.  plan:
// the tensor-core body's launch plan (nt, ws, wo, wk, ss, stages, splits,
// kper) and its stage layout (vstride, istride, xstride, stage) from the
// wrapper, nt = 0 for the first bodies; ws: the f32 split workspace
// [splits, S, O] when splits > 1.
extern "C" int nm_xwt_launch(const void* x, const void* vals, const void* idx,
                             void* y, int S, int O, int K, int n, int m,
                             int dtype, int nt, int wrows, int wo, int wk,
                             int ss, int stages, int splits, int kper, int vstride,
                             int istride, int xstride, int stage, void* ws,
                             void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nnz = K / m * n;
  if (nt != 0) {
    const nm::mma::Plan plan{nt, wrows, wo, wk, ss, stages, splits, kper};
    const nm::mma::Layout ly{vstride, istride, xstride, stage, 0, 0, 0};
    const Int8Stream reader{static_cast<const int8_t*>(idx), nnz,
                            nnz % 16 == 0 && aligned(idx, 16)};
    return launch_mma(x, vals, reader, y, S, O, K, n, m, dtype, plan, ly, ws,
                      stream);
  }
  const nm::Int8Idx reader{static_cast<const int8_t*>(idx), nnz};
  return launch<false>(x, vals, reader, aligned(idx, 8), y, S, O, K, n, m,
                       dtype, stream);
}

// The same product with W's indices as the packed uint32 words of each row
// (ceil(nnz / per_word) words per row, passed as raw 32-bit patterns).
extern "C" int nm_xwt_packed_launch(const void* x, const void* vals,
                                    const void* words, void* y, int S, int O,
                                    int K, int n, int m, int dtype, int nt,
                                    int wrows, int wo, int wk, int ss,
                                    int stages, int splits, int kper, int vstride,
                                    int istride, int xstride, int stage, void* ws,
                                    void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bits = nm::index_bits(m);
  const int per_word = 32 / bits;
  const int nnz = K / m * n;
  const int wpr = (nnz + per_word - 1) / per_word;
  if (nt != 0) {
    const nm::mma::Plan plan{nt, wrows, wo, wk, ss, stages, splits, kper};
    const nm::mma::Layout ly{vstride, istride, xstride, stage, 0, 0, 0};
    const PackedStream reader{static_cast<const uint32_t*>(words), wpr, per_word,
                              wpr % 4 == 0 && aligned(words, 16)};
    return launch_mma(x, vals, reader, y, S, O, K, n, m, dtype, plan, ly, ws,
                      stream);
  }
  const nm::PackedIdx reader{static_cast<const uint32_t*>(words), wpr, bits,
                             per_word};
  return launch<false>(x, vals, reader, true, y, S, O, K, n, m, dtype, stream);
}

// C[R, Ccols] = A_sp[R, K] . B[K, Ccols], A as values [R, K/M*N] + int8
// indices.
extern "C" int nm_spmm_launch(const void* vals, const void* idx, const void* b,
                              void* c, int R, int Ccols, int K, int n, int m,
                              int dtype, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const nm::Int8Idx reader{static_cast<const int8_t*>(idx), K / m * n};
  return launch<true>(b, vals, reader, aligned(idx, 8), c, R, Ccols, K, n, m,
                      dtype, stream);
}
