// Shared device code of the N:M kernels (nm_xwt.cu, nm_spmv.cu): the index
// readers of the two index streams and the in-shared-memory decompress of a
// compressed tile, the counterpart of the reference's _decompress_tile and
// _unpack_indices_tile (src/repro/kernels/nm_spmm.py).  A compressed row
// holds K/M*N slots; slot e belongs to M-block e / N and its value lands at
// dense column block*M + idx.
#pragma once

#include "common.cuh"

namespace nm {

constexpr int kBK = 64;  // K per step of every N:M kernel (a multiple of M)

// int8 in-block indices [rows, nnz].
struct Int8Idx {
  const int8_t* p;
  int nnz;
  __device__ __forceinline__ int operator()(int row, int e) const {
    return p[(size_t)row * nnz + e];
  }
  // slots e .. e+7 of one row; the launcher guarantees nnz % 8 == 0 and an
  // 8-byte aligned base, so this is one 8-byte load
  __device__ __forceinline__ void load8(int row, int e, int8_t (&out)[8]) const {
    const uint2 r = *reinterpret_cast<const uint2*>(p + (size_t)row * nnz + e);
    memcpy(out, &r, 8);
  }
};

// The paper's bit-packed stream: per row, ceil(nnz / per_word) 32-bit words
// of bits-wide indices, slot s of a word at bits [s*bits, (s+1)*bits).  A
// tile need not start on a word: entry e is word e / per_word, shifted by
// (e % per_word) * bits.
struct PackedIdx {
  const uint32_t* p;
  int words_per_row, bits, per_word;
  __device__ __forceinline__ int operator()(int row, int e) const {
    const uint32_t w = p[(size_t)row * words_per_row + e / per_word];
    return (w >> ((e % per_word) * bits)) & ((1u << bits) - 1u);
  }
  __device__ __forceinline__ void load8(int row, int e, int8_t (&out)[8]) const {
#pragma unroll
    for (int q = 0; q < 8; ++q) out[q] = static_cast<int8_t>((*this)(row, e + q));
  }
};

// Dense [rows, kBK] tile of compressed rows r0.. (of R) at K offset k0,
// written through put(row_in_tile, col_in_tile, value): each M-block's
// columns are zeroed, then its N values placed at block*M + idx.  Exact:
// every dense entry receives at most one value.
template <typename T, class Idx, typename Put>
__device__ __forceinline__ void decompress_tile(const T* vals, const Idx& idx,
                                                int rows, int r0, int k0,
                                                int R, int K, int n, int m,
                                                Put put) {
  const int nblk = kBK / m;
  const int nnz = K / m * n;
  for (int i = threadIdx.x; i < rows * nblk; i += blockDim.x) {
    const int c = i / nblk;
    const int j = i % nblk;
    const int row = r0 + c;
    const int kb = k0 + j * m;  // first column of this M-block
    for (int p = 0; p < m; ++p) put(c, j * m + p, 0.f);
    if (row < R && kb < K) {
      const int e = kb / m * n;  // first slot of the block
      for (int s = 0; s < n; ++s)
        put(c, j * m + idx(row, e + s), to_f32(vals[(size_t)row * nnz + e + s]));
    }
  }
}

// bf16 fast form for a [64, kBK + pad] tile: each thread takes a run of 8
// consecutive slots of one row (one 16-byte value load + the run's 8
// indices, issued before any store), which covers 8/n whole M-blocks, and
// writes their 8*M/n dense columns: zeros, then the n values at block*M +
// idx.  Needs n to divide 8, nnz % 8 == 0, (kBK/M*N) % 8 == 0 and 16-byte
// aligned values (checked by the launcher).
template <int Rows, int Stride, class Idx>
__device__ __forceinline__ void decompress_runs(__nv_bfloat16 (*ws)[Stride],
                                                const __nv_bfloat16* vals,
                                                const Idx& idx, int R, int K,
                                                int n, int m, int r0, int k0) {
  const int nnz = K / m * n;
  const int runs = kBK / m * n / 8;  // 8-slot runs per row per K step
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int v = threadIdx.x; v < Rows * runs; v += blockDim.x) {
    const int c = v / runs, q = v % runs;
    const int row = r0 + c;
    const int slot = k0 / m * n + q * 8;  // first slot of the run
    const int col0 = q * 8 / n * m;       // its first dense column
    const bool live = row < R && slot < nnz;
    __nv_bfloat16 vv[8];
    int8_t ii[8];
    if (live) {
      const uint4 rv = *reinterpret_cast<const uint4*>(vals + (size_t)row * nnz + slot);
      memcpy(vv, &rv, 16);
      idx.load8(row, slot, ii);
    }
    for (int p = 0; p < 8 / n * m; ++p) ws[c][col0 + p] = zero;
    if (live) {
#pragma unroll
      for (int e = 0; e < 8; ++e) ws[c][col0 + e / n * m + ii[e]] = vv[e];
    }
  }
}

// bits per packed index and indices per 32-bit word at block size m
__host__ __device__ inline int index_bits(int m) {
  int b = 1;
  while ((1 << b) < m) ++b;
  return b;
}

}  // namespace nm
