// The tiled N:M sparse-dense products: both orientations of the reference's
// src/repro/kernels/nm_spmm.py, in f32 and bf16.
//
//   nm_xwt   Y[S, O] = X[S, K] . W_sp^T  (nm_xwt_kernel / _xwt_body), the
//            W indices as int8 or as the paper's bit-packed words
//            (packed=True: _unpack_indices_tile + _decompress_tile)
//   nm_spmm  C[R, C] = A_sp[R, K] . B[K, C]  (nm_spmm_kernel / _spmm_body),
//            the paper's orientation
//
// Bound on the H100: at the serving prefill lengths the compressed weight
// bytes (the MACs at the bf16 tensor-core rate take less time than reading
// the weights once); at the CNN GEMMs' widths (K up to 4608, tens of
// thousands of columns) the operations.
//
// f32 (all three launchers, every N:M with M dividing 64) runs the
// split-TF32 tensor-core body of nm_tf32.cuh: the compressed operand is
// always the mma's A (its rows are W's or A's rows), a cp.async ring feeds
// values, indices and the dense tile, each stage is decompressed into hi
// and lo TF32 tiles in shared memory, and three mma.sync passes (lo.hi,
// hi.lo, hi.hi) keep f32 accuracy.  Its plan (tile, warps, ring, K splits)
// comes from the wrapper (kernels/nm_spmm.py f32_plan).
//
// bf16 nm_xwt (int8 and packed) at N:M in {1:2, 1:4, 2:4, 2:8} runs the
// tensor-core tile body of nm_mma.cuh (shared with the onehot nm_spmv
// body): one CTA covers every row of a call up to 128, so W is read once;
// output columns are tiled 32-128 wide and K is split where the card would
// otherwise be empty (partial sums added in split order, no float atomics);
// a 2-4 stage cp.async ring feeds values, indices (packed words as 16-byte
// copies where a row's words are 16-byte aligned) and X; W is decompressed
// in registers into mma.sync A fragments.  The plan (tile, splits, ring)
// comes from the wrapper (kernels/nm_spmm.py mma_plan).
//
// Both plans do not depend on the index format, so the packed instances
// sum in the int8 instances' order and equal them bit for bit.
//
// The first bf16 body stays for nm_spmm and for nm_xwt at other N:M: one
// CTA per 64x64 output tile loops over K; per 64-column step it stages
// the dense tile and decompresses the sparse tile into shared memory with
// the reference's block*M + idx placement (out[rows, cols] = P . Q^T with
// P = X dense, Q = W sparse in xwt and P = A sparse, Q^T = B dense in
// spmm), each thread issuing all of its global loads (16-byte runs where
// the shapes allow) before its first shared store, and feeds mma.sync
// m16n8k16 with f32 accumulators, eight warps of 32x16 each.  Ragged edges
// are masked in the loads and the stores; nothing is padded.
#include "nm_tf32.cuh"

namespace {

using nm::kBK;
typedef __nv_bfloat16 bf16;

// ----------------------------------------------------- bf16: the first body

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

// The first bf16 body: out[rows, cols]; dense is X [rows, K] (xwt) or B
// [K, cols] (spmm)
template <bool Spmm, class Idx>
int launch_bf16(const void* dense, const void* vals, Idx idx, bool idx_runs_ok,
                void* y, int rows, int cols, int K, int n, int m, void* stream) {
  if (m <= 0 || kBK % m != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cols + kMBN - 1) / kMBN, (rows + kMBM - 1) / kMBM);
  const int nnz = K / m * n;
  const int dense_minor = Spmm ? cols : K;
  const bool vec_dense = dense_minor % 8 == 0 && aligned(dense, 16);
  const bool runs = 8 % n == 0 && nnz % 8 == 0 && (kBK / m * n) % 8 == 0
                    && aligned(vals, 16) && idx_runs_ok;
  nm_bf16_kernel<Spmm, Idx><<<grid, kMThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dense), static_cast<const bf16*>(vals), idx,
      static_cast<bf16*>(y), rows, cols, K, n, m, vec_dense, runs);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ f32: the split-TF32 body

using nm::tf32::Args;

template <bool Spmm, class Idx, int CN, int CM>
__global__ void __launch_bounds__(256, 2) nm_tf32_kernel(Args<Idx> a) {
  nm::tf32::tile_body<Spmm, Idx, CN, CM>(a);
}

__global__ void nm_tf32_reduce_kernel(const float* ws, float* y, int count,
                                      int splits) {
  nm::mma::reduce_splits(ws, y, count, splits);
}

template <bool Spmm, class Idx, int CN, int CM>
int run_tf32(const Args<Idx>& a, cudaStream_t s) {
  static int smem_set = 48 * 1024;  // per kernel, in this library
  auto kern = nm_tf32_kernel<Spmm, Idx, CN, CM>;
  if (a.pl.smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.pl.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = a.pl.smem;
  }
  const nm::tf32::Plan& p = a.pl;
  const int bm = 32 * p.wm, bn = 32 * p.wn;
  const dim3 grid((a.C + bn - 1) / bn, (a.R + bm - 1) / bm, p.splits);
  kern<<<grid, 32 * p.wm * p.wn, p.smem, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return static_cast<int>(e);
  const int count = a.R * a.C;
  const int blocks = min((count + 255) / 256, 132 * 8);
  nm_tf32_reduce_kernel<<<blocks, 256, 0, s>>>(a.ws, a.y, count, p.splits);
  return static_cast<int>(cudaGetLastError());
}

// out = W_sp . D^T in f32 under the wrapper's plan: R compressed rows, C
// dense columns (xwt: Y [C, R] from X [C, K]; spmm: C [R, C] from B [K,
// C]).  The N:M of the bf16 tensor-core set take compile-time instances
// (a 16-column decompress in registers); every other N:M the run-time one.
template <bool Spmm, class Idx>
int launch_tf32(const void* dense, const void* vals, Idx idx, void* y, int R,
                int C, int K, int n, int m, const nm::tf32::Plan& plan,
                void* ws, void* stream) {
  if (m <= 0 || n <= 0 || n >= m || kBK % m || K % m)
    return static_cast<int>(cudaErrorInvalidValue);
  Args<Idx> a{};
  a.dense = static_cast<const float*>(dense);
  a.vals = static_cast<const float*>(vals);
  a.idx = idx;
  a.y = static_cast<float*>(y);
  a.ws = static_cast<float*>(ws);
  a.R = R, a.C = C, a.K = K, a.n = n, a.m = m;
  a.pl = plan;
  if (!nm::tf32::check_plan<Spmm>(a))
    return static_cast<int>(cudaErrorInvalidValue);
  const int E = a.ly.ks / m * n;  // slots per stage
  a.vvec = (K / m * n) % 4 == 0 && E % 4 == 0 && aligned(vals, 16);
  a.dvec = (Spmm ? C : K) % 4 == 0 && aligned(dense, 16);
  a.ovec = C % 4 == 0 && aligned(y, 16) && aligned(ws, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 1 && m == 2) return run_tf32<Spmm, Idx, 1, 2>(a, s);
  if (n == 1 && m == 4) return run_tf32<Spmm, Idx, 1, 4>(a, s);
  if (n == 2 && m == 4) return run_tf32<Spmm, Idx, 2, 4>(a, s);
  if (n == 2 && m == 8) return run_tf32<Spmm, Idx, 2, 8>(a, s);
  return run_tf32<Spmm, Idx, 0, 0>(a, s);
}

// the int8 index stream of the f32 body: 16- or 4-byte copies where a
// stage's index bytes and the rows allow
nm::tf32::I8 tf32_int8(const void* idx, int K, int n, int m) {
  const int nnz = K / m * n, E = nm::tf32::stage_cols(m) / m * n;
  const int mode = E % 16 == 0 && nnz % 16 == 0 && aligned(idx, 16) ? 2
                   : E % 4 == 0 && nnz % 4 == 0 && aligned(idx, 4) ? 1 : 0;
  return nm::tf32::I8{static_cast<const int8_t*>(idx), nnz, mode};
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

// The launchers' twelve plan ints p0..p11.  bf16 nm_xwt: the tensor-core
// body's plan (nt, ws, wo, wk, ss, stages, splits, kper) and stage layout
// (vstride, istride, xstride, stage) from the wrapper, nt = 0 for the first
// body.  f32: the split-TF32 body's plan (wm, wn, stages, splits, kper,
// smem), then zeros.  bf16 nm_spmm takes none.  ws: the f32 split
// workspace [splits, rows, cols] of the output when the plan splits K.
#define PLAN_INTS                                                          \
  int p0, int p1, int p2, int p3, int p4, int p5, int p6, int p7, int p8, \
      int p9, int p10, int p11
#define F32_PLAN nm::tf32::Plan{p0, p1, p2, p3, p4, p5}

// Y[S, O] = X[S, K] . W^T, W as values [O, K/M*N] + int8 indices.
extern "C" int nm_xwt_launch(const void* x, const void* vals, const void* idx,
                             void* y, int S, int O, int K, int n, int m,
                             int dtype, PLAN_INTS, void* ws, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nnz = K / m * n;
  if (dtype == REPRO_DTYPE_F32)
    return launch_tf32<false>(x, vals, tf32_int8(idx, K, n, m), y, O, S, K, n,
                              m, F32_PLAN, ws, stream);
  if (dtype != REPRO_DTYPE_BF16) return static_cast<int>(cudaErrorInvalidValue);
  if (p0 != 0) {
    const nm::mma::Plan plan{p0, p1, p2, p3, p4, p5, p6, p7};
    const nm::mma::Layout ly{p8, p9, p10, p11, 0, 0, 0};
    const Int8Stream reader{static_cast<const int8_t*>(idx), nnz,
                            nnz % 16 == 0 && aligned(idx, 16)};
    return launch_mma(x, vals, reader, y, S, O, K, n, m, dtype, plan, ly, ws,
                      stream);
  }
  const nm::Int8Idx reader{static_cast<const int8_t*>(idx), nnz};
  return launch_bf16<false>(x, vals, reader, aligned(idx, 8), y, S, O, K, n, m,
                            stream);
}

// The same product with W's indices as the packed uint32 words of each row
// (ceil(nnz / per_word) words per row, passed as raw 32-bit patterns).
extern "C" int nm_xwt_packed_launch(const void* x, const void* vals,
                                    const void* words, void* y, int S, int O,
                                    int K, int n, int m, int dtype, PLAN_INTS,
                                    void* ws, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bits = nm::index_bits(m);
  const int per_word = 32 / bits;
  const int nnz = K / m * n;
  const int wpr = (nnz + per_word - 1) / per_word;
  if (dtype == REPRO_DTYPE_F32) {
    const nm::tf32::Packed reader{static_cast<const uint32_t*>(words), wpr, bits,
                                  per_word};
    return launch_tf32<false>(x, vals, reader, y, O, S, K, n, m, F32_PLAN, ws,
                              stream);
  }
  if (dtype != REPRO_DTYPE_BF16) return static_cast<int>(cudaErrorInvalidValue);
  if (p0 != 0) {
    const nm::mma::Plan plan{p0, p1, p2, p3, p4, p5, p6, p7};
    const nm::mma::Layout ly{p8, p9, p10, p11, 0, 0, 0};
    const PackedStream reader{static_cast<const uint32_t*>(words), wpr, per_word,
                              wpr % 4 == 0 && aligned(words, 16)};
    return launch_mma(x, vals, reader, y, S, O, K, n, m, dtype, plan, ly, ws,
                      stream);
  }
  const nm::PackedIdx reader{static_cast<const uint32_t*>(words), wpr, bits,
                             per_word};
  return launch_bf16<false>(x, vals, reader, true, y, S, O, K, n, m, stream);
}

// C[R, Ccols] = A_sp[R, K] . B[K, Ccols], A as values [R, K/M*N] + int8
// indices.
extern "C" int nm_spmm_launch(const void* vals, const void* idx, const void* b,
                              void* c, int R, int Ccols, int K, int n, int m,
                              int dtype, PLAN_INTS, void* ws, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nnz = K / m * n;
  if (dtype == REPRO_DTYPE_F32)
    return launch_tf32<true>(b, vals, tf32_int8(idx, K, n, m), c, R, Ccols, K,
                             n, m, F32_PLAN, ws, stream);
  if (dtype != REPRO_DTYPE_BF16) return static_cast<int>(cudaErrorInvalidValue);
  const nm::Int8Idx reader{static_cast<const int8_t*>(idx), nnz};
  return launch_bf16<true>(b, vals, reader, aligned(idx, 8), c, R, Ccols, K, n,
                           m, stream);
}
