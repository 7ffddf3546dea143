// The f32 N:M tile body of nm_xwt.cu, on the tensor cores in split TF32:
// out = W_sp . D^T with one compressed operand W (values [R, K/M*N] plus
// int8 or bit-packed indices) and one dense operand D, f32 in and out.  It
// serves all three f32 launchers:
//
//   nm_xwt         Y[S, O] = X[S, K] . W_sp[O, K]^T: W is the compressed
//                  operand (R = O), D = X [S, K] (the reference's
//                  nm_xwt_kernel / _xwt_body, src/repro/kernels/nm_spmm.py)
//   nm_xwt_packed  the same with the paper's bit-packed indices
//                  (_unpack_indices_tile + _decompress_tile)
//   nm_spmm        C[R, C] = A_sp[R, K] . B[K, C]: A is the compressed
//                  operand, D^T = B [K, C] (nm_spmm_kernel / _spmm_body)
//
// Inside, one orientation: the compressed rows are the mma's m (A operand),
// the dense columns its n (B operand), so the two launchers differ only in
// the dense tile's shared layout ([n][k] for X, [k][n] for B) and in where
// the output fragment is stored (Y[n][m] for xwt, C[m][n] for spmm).
//
// Bound on the H100: the operations at the CNN GEMMs' widths (the bytes
// at small K and many columns).  The f32 CUDA cores give 67 TFLOP/s; one
// TF32 tensor-core pass misses the checks' 1e-4 (a 10-bit mantissa), so
// each operand is split into hi (x with its low 13 mantissa bits cleared)
// and lo = x - hi, and three passes are summed in f32, small products
// first (lo.hi, hi.lo, then hi.hi): f32-accurate MACs at up to a third of
// the 495 TFLOP/s TF32 rate, over the dense MACs (the tensor cores do not
// skip the zeros; mma.sp takes TF32 only at 1:2).  The design:
//
// * A cp.async ring of 3-4 stages of 32 columns of K (64 at M = 64): the
//   compressed values and indices of the CTA's rows and the dense tile,
//   16-byte copies where rows are 16-byte aligned, 4-byte (or, for odd
//   int8 index rows, plain) copies otherwise, zero-filled past the edges.
//   Each thread's share of a stage's copies is fixed once per kernel, so
//   a stage costs no integer division.
// * Two A tiles in shared memory: while stage st feeds the mma from one,
//   the warps decompress stage st + 1 into the other between their k-steps
//   (one barrier per stage).  The decompress places each value at block*M
//   + idx; for the N:M of the bf16 tensor-core set it is a compile-time
//   16-column step (two 16-byte value loads, one index read, the columns
//   built in registers), for any other N:M with M dividing 64 a run-time
//   one.  Fragments are split into hi and lo in registers as they load.
// * mma.sync.m16n8k8 TF32 with f32 accumulators; each warp holds a 32 x
//   32 output tile (two m16 by four n8 tiles), at most 8 warps and 128
//   registers a thread, so two CTAs share an SM.  A fragments (and X's B
//   fragments) come with ldmatrix from rows padded to 36 floats (the 8
//   rows of one 16-byte phase on distinct banks).  B's [k][n] rows are
//   padded to n-tile + 8 floats, and a warp's four n tiles interleave
//   (lane column g of tile j is dense column 4g + j), so each lane reads
//   its four tiles' fragments as one 16-byte load, conflict-free.
// * The plan (kernels/nm_spmm.py f32_plan: warps, tile, ring, K splits)
//   comes from the wrapper and does not depend on the index format, so
//   the packed instance equals the int8 one bit for bit.  K splits write
//   f32 partial sums to a workspace the wrapper allocates; a second kernel
//   adds them in split order (no float atomics: the same bits every run).
//
// What the ablation found (tools/nm_mma_ablate.py --body tf32, NVIDIA H100
// 80GB HBM3, 700 W; PERF.md section 6): the first version (one A tile,
// hi and lo split once into shared memory, 64-column stages, one CTA an
// SM) was bound by its decompress, a latency chain with no overlap; in
// the next no part saved more than a fifth, and its SASS held a run-time
// division per copy loop per stage, which this body hoists.  In this body,
// at deep K (densenet121 L23, resnet50 conv5_3x3) the mma is the largest
// part (leaving it out saves 18%), the copies, decompress and split 3-8%
// each; at K 148 (densenet121 L1) the compressed copies (27%), the stores
// and the mma (17% each).
#pragma once

#include "nm_mma.cuh"

namespace nm {
namespace tf32 {

// K columns per ring stage: 32, or one block at M = 64
__host__ __device__ constexpr int stage_cols(int m) { return m > 32 ? 64 : 32; }

// The launch plan, computed by the Python wrapper (f32_plan).
struct Plan {
  int wm, wn;  // warps along the compressed rows and along the dense columns
  int stages;  // ring depth: 2, 3 or 4
  int splits;  // CTAs along K
  int kper;    // K columns per split, a multiple of 64
  int smem;    // the CTA's dynamic shared memory, as the wrapper sized it
};

// Byte layout of the CTA's shared memory, derived from the plan.
struct Layout {
  int ks;                         // K columns per stage: 32, or 64 at M 64
  int vstride, istride, bstride;  // row strides: values, indices, dense
  int ioff, boff;                 // index and dense tiles in a stage
  int stage;                      // bytes per ring stage
  int aoff;                       // the ring's offset (after the A tiles)
  int need;                       // bytes the CTA needs
};

// x = hi + lo: hi is x with its low 13 mantissa bits cleared (a TF32
// value), lo = x - hi exactly; the tensor cores read lo's top 19 bits.
// Two simple instructions, where cvt.rna.tf32 rounding costs more.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x4 blocks of 32-bit words (as 8x8 b16 matrices): lane l gives the
// row address of matrix l / 8; word (row g, column t) of matrix j lands in
// r[j] of lane 4g + t
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(mma::smem_addr(p)));
}

// A fixed split of rows x cpr chunks over the block's threads, computed
// once per kernel: where cpr divides the thread count, thread tid takes
// chunk tid % cpr of rows tid / cpr, + step, ...; otherwise the flattened
// range tid, tid + threads, ...
struct Chunks {
  int cpr, c, r0, step;  // step 0: the flattened loop

  __device__ __forceinline__ explicit Chunks(int n) : cpr(n), c(0), r0(0), step(0) {
    if (blockDim.x % cpr == 0) {
      c = threadIdx.x % cpr;
      r0 = threadIdx.x / cpr;
      step = blockDim.x / cpr;
    }
  }

  // f(r, c) for every r < rows, c < cpr
  template <typename F>
  __device__ __forceinline__ void run(int rows, F f) const {
    if (step) {
      for (int r = r0; r < rows; r += step) f(r, c);
    } else {
      for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) f(i / cpr, i % cpr);
    }
  }
};

// Copies of W-byte chunks (r, c), r < rows, c < ch.cpr, global src + r *
// sstride + c * W / sizeof(T) to shared dst + r * dstride + c * W, live
// where r < rlive and the chunk's first element c * W / sizeof(T) < clive
// (the launcher's alignment checks make every chunk wholly live or dead);
// dead chunks are zero-filled.  W = 1: plain byte loads and stores.  A
// thread with a fixed column walks its rows by pointer steps.
template <int W, typename T>
__device__ __forceinline__ void copy_rows(const Chunks& ch, unsigned char* dst,
                                          int dstride, const T* src,
                                          size_t sstride, int rows, int rlive,
                                          int clive) {
  constexpr int EW = W / sizeof(T);  // elements per chunk
  auto one = [&](unsigned char* d, const T* s, bool live) {
    if constexpr (W == 16)
      mma::cp16(d, live ? s : src, live);
    else if constexpr (W == 4)
      mma::cp4(d, live ? s : src, live);
    else
      *d = live ? static_cast<unsigned char>(*s) : 0;
  };
  if (ch.step) {
    const bool clive_ok = ch.c * EW < clive;
    const T* s = src + (size_t)ch.r0 * sstride + ch.c * EW;
    unsigned char* d = dst + ch.r0 * dstride + ch.c * W;
    const size_t sstep = (size_t)ch.step * sstride;
    const int dstep = ch.step * dstride;
    for (int r = ch.r0; r < rows; r += ch.step, s += sstep, d += dstep)
      one(d, s, clive_ok && r < rlive);
  } else {
    for (int i = threadIdx.x; i < rows * ch.cpr; i += blockDim.x) {
      const int r = i / ch.cpr, c = i % ch.cpr;
      one(dst + r * dstride + c * W, src + (size_t)r * sstride + c * EW,
          r < rlive && c * EW < clive);
    }
  }
}

// ------------------------------------------------------------ index streams

// int8 in-block indices [R, nnz]; a stage holds E bytes per row.
struct I8 {
  const int8_t* p;
  int nnz;
  int mode;  // 2: 16-byte copies, 1: 4-byte copies, 0: byte loads

  int row_bytes(int E) const { return E; }

  // chunks per staged row
  __device__ __forceinline__ int chunks(int E) const {
    return mode == 2 ? E / 16 : mode == 1 ? E / 4 : E;
  }

  __device__ __forceinline__ void stage(const Chunks& ch, unsigned char* dst,
                                        int stride, int rows, int r0, int R,
                                        int e0, int elive) const {
    const int8_t* src = p + (size_t)r0 * nnz + e0;
    if (mode == 2)
      copy_rows<16>(ch, dst, stride, src, nnz, rows, R - r0, elive);
    else if (mode == 1)
      copy_rows<4>(ch, dst, stride, src, nnz, rows, R - r0, elive);
    else
      copy_rows<1>(ch, dst, stride, src, nnz, rows, R - r0, elive);
  }

  // the index of absolute slot e, at stage-local slot le of a staged row
  __device__ __forceinline__ int get(const unsigned char* row, int le, int,
                                     int) const {
    return row[le];
  }

  // the P indices of stage-local slots le .. le + P - 1 (le % P == 0)
  template <int P, int M>
  __device__ __forceinline__ void get_run(const unsigned char* row, int le, int,
                                          int, int (&id)[P]) const {
    uint32_t w[(P + 3) / 4];
    if constexpr (P == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + le);
      w[0] = v.x, w[1] = v.y;
    } else {
      static_assert(P == 4, "runs of 4 or 8 slots");
      w[0] = *reinterpret_cast<const uint32_t*>(row + le);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) id[q] = (w[q / 4] >> (8 * (q % 4))) & 0xffu;
  }
};

// The paper's bit-packed stream: per row `wpr` 32-bit words of `bits`-wide
// indices, slot s of a word at bits [s*bits, (s+1)*bits).  A stage holds
// the words from wa = e0 / pw to that of its last live slot.
struct Packed {
  const uint32_t* p;
  int wpr, bits, pw;

  // words per staged row, the most a stage's E slots can touch
  __host__ __device__ int chunks(int E) const { return (E + pw - 1) / pw + 1; }
  int row_bytes(int E) const { return 4 * chunks(E); }

  __device__ __forceinline__ void stage(const Chunks& ch, unsigned char* dst,
                                        int stride, int rows, int r0, int R,
                                        int e0, int elive) const {
    if (elive <= 0) return;
    const int wa = e0 / pw, wb = (e0 + elive - 1) / pw;
    copy_rows<4>(ch, dst, stride, p + (size_t)r0 * wpr + wa, wpr, rows,
                 R - r0, min(wb + 1, wpr) - wa);
  }

  __device__ __forceinline__ int get(const unsigned char* row, int, int e,
                                     int e0) const {
    const uint32_t w = reinterpret_cast<const uint32_t*>(row)[e / pw - e0 / pw];
    return (w >> ((e % pw) * bits)) & ((1u << bits) - 1u);
  }

  // at a compile-time M: the word arithmetic by constants
  template <int P, int M>
  __device__ __forceinline__ void get_run(const unsigned char* row, int, int e,
                                          int e0, int (&id)[P]) const {
    constexpr int B = mma::bits_for(M), PW = 32 / B;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int q = 0; q < P; ++q)
      id[q] = (w[(e + q) / PW - e0 / PW] >> ((e + q) % PW * B)) & ((1u << B) - 1u);
  }
};

// ------------------------------------------------------------------ body

template <class Idx>
struct Args {
  const float* dense;  // xwt: X [C, K]; spmm: B [K, C]
  const float* vals;   // [R, K/M*N]
  Idx idx;
  float* y;   // xwt: [C, R]; spmm: [R, C]
  float* ws;  // [splits, R * C] when splits > 1
  int R, C, K, n, m;
  Plan pl;
  Layout ly;
  bool vvec;  // values rows 16-byte copyable
  bool dvec;  // dense rows 16-byte copyable
  bool ovec;  // spmm output rows 16-byte storable
};

// Decompress one 16-column group of one row at compile-time N:M (M | 16,
// 16N/M = 4 or 8 slots): its values as one or two 16-byte loads, its
// indices in one read, the 16 columns built in registers (zeros where no
// index points) and stored as 16-byte runs.  Slots past the live columns
// hold staged zeros.
template <int N, int M, class Idx>
__device__ __forceinline__ void decompress16(const Idx& idx, const float* v,
                                             const unsigned char* irow, int le,
                                             int e0, float* dst) {
  constexpr int P = 16 / M * N;
  float val[P];
  int id[P];
#pragma unroll
  for (int q = 0; q < P; q += 4) {
    const float4 f = *reinterpret_cast<const float4*>(v + le + q);
    val[q] = f.x, val[q + 1] = f.y, val[q + 2] = f.z, val[q + 3] = f.w;
  }
  idx.template get_run<P, M>(irow, le, e0 + le, e0, id);
#pragma unroll
  for (int c4 = 0; c4 < 16; c4 += 4) {
    float w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c4 + j, b = c / M;
      w[j] = 0.f;
#pragma unroll
      for (int q = 0; q < N; ++q)
        w[j] = id[b * N + q] == c % M ? val[b * N + q] : w[j];
    }
    *reinterpret_cast<float4*>(dst + c4) = make_float4(w[0], w[1], w[2], w[3]);
  }
}

// N = M = 0: N and M at run time (any N:M with M dividing 64); otherwise
// the compile-time instance of one N:M with a 16-column decompress.
template <bool Spmm, class Idx, int CN, int CM>
__device__ __forceinline__ void tile_body(const Args<Idx>& a) {
  constexpr int MT = 2, NT = 4;  // a warp: 2 m16 tiles by 4 n8 tiles
  constexpr int CKS = CM == 0 ? 0 : stage_cols(CM);
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& pl = a.pl;
  const Layout& ly = a.ly;
  const int N = CM ? CN : a.n, M = CM ? CM : a.m;
  const int KS = CKS ? CKS : ly.ks, AS = KS + 4;  // stage depth, A stride
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int wmi = warp % pl.wm, wni = warp / pl.wm;
  const int BM = 32 * pl.wm, BN = 32 * pl.wn;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * pl.kper;
  const int kend = min(a.K, kbeg + pl.kper);
  const int nst = (kend - kbeg + KS - 1) / KS;
  const int nnz = a.K / M * N;
  const int E = KS / M * N;  // slots per staged row
  float* abuf = reinterpret_cast<float*>(smem);  // two A tiles [BM][AS]
  unsigned char* ring = smem + ly.aoff;
  const int G = max(16, M);  // columns per decompress item
  // each thread's share of every stage's copies and decompress
  const Chunks vch(a.vvec ? E / 4 : E);
  const Chunks ich(a.idx.chunks(E));
  const Chunks dch(Spmm ? (a.dvec ? BN / 4 : BN) : (a.dvec ? KS / 4 : KS));
  const Chunks gch(KS / G);

  auto next = [&](int slot) { return slot + 1 == pl.stages ? 0 : slot + 1; };

  // the copies of stage st into ring slot `slot`
  auto load = [&](int st, int slot) {
    if (st < nst) {
      unsigned char* base = ring + slot * ly.stage;
      const int kb = kbeg + st * KS, ke = min(kend, kb + KS);
      const int e0 = kb / M * N, elive = (ke - kb) / M * N;
      const float* vsrc = a.vals + (size_t)m0 * nnz + e0;
      if (a.vvec)  // E % 4 == 0: 4-slot chunks, wholly live or dead
        copy_rows<16>(vch, base, ly.vstride, vsrc, nnz, BM, a.R - m0, elive);
      else
        copy_rows<4>(vch, base, ly.vstride, vsrc, nnz, BM, a.R - m0, elive);
      a.idx.stage(ich, base + ly.ioff, ly.istride, BM, m0, a.R, e0, elive);
      unsigned char* dt = base + ly.boff;
      if constexpr (Spmm) {  // B rows kb.. [k][n], along the columns
        const float* src = a.dense + (size_t)kb * a.C + n0;
        if (a.dvec)  // C % 4 == 0: 4-column chunks, wholly live or dead
          copy_rows<16>(dch, dt, ly.bstride, src, a.C, KS, ke - kb, a.C - n0);
        else
          copy_rows<4>(dch, dt, ly.bstride, src, a.C, KS, ke - kb, a.C - n0);
      } else {  // X rows n0.. [n][k], along K
        const float* src = a.dense + (size_t)n0 * a.K + kb;
        if (a.dvec)  // K % 4 == 0: 4-column chunks, wholly live or dead
          copy_rows<16>(dch, dt, ly.bstride, src, a.K, BN, a.C - n0, ke - kb);
        else
          copy_rows<4>(dch, dt, ly.bstride, src, a.K, BN, a.C - n0, ke - kb);
      }
    }
    mma::commit();  // an empty group past the end keeps the count uniform
  };

  // Decompress stage st into A tile st % 2, per (row, group of G =
  // max(16, M) columns): the value of slot s of block b at column b*M +
  // idx, every other column 0.
  auto decompress = [&](int st, int slot) {
    const unsigned char* base = ring + slot * ly.stage;
    float* at = abuf + (st & 1) * BM * AS;
    const int kb = kbeg + st * KS, ke = min(kend, kb + KS);
    const int e0 = kb / M * N, elive = (ke - kb) / M * N;
    const int P = G / M * N;
    gch.run(BM, [&](int r, int j) {
      const int c0 = j * G;
      float* dst = at + r * AS + c0;
      const float* v = reinterpret_cast<const float*>(base + r * ly.vstride);
      const unsigned char* irow = base + ly.ioff + r * ly.istride;
      const int le0 = c0 / M * N;
      if constexpr (CM != 0) {
        decompress16<CN, CM>(a.idx, v, irow, le0, e0, dst);
      } else {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < G; c += 4) *reinterpret_cast<float4*>(dst + c) = z;
        asm volatile("" ::: "memory");  // the zeros before the placed values
        if (m0 + r >= a.R) return;
        for (int s = 0; s < P && le0 + s < elive; ++s)
          dst[s / N * M + a.idx.get(irow, le0 + s, e0 + le0 + s, e0)] =
              v[le0 + s];
      }
    });
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

  // ldmatrix row addresses of this lane: A's matrices are (rows 0-7, k
  // 0-3), (rows 8-15, k 0-3), (rows 0-7, k 4-7), (rows 8-15, k 4-7), i.e.
  // a0..a3 of the m16n8k8 A fragment; X's are (n-tile j, k 0-3), (j, k
  // 4-7), (j + 1, k 0-3), (j + 1, k 4-7), i.e. b0, b1 of two n tiles.
  const int lq = lane / 8, l8 = lane % 8;
  const int arow = wmi * MT * 16 + (lq & 1) * 8 + l8, acol = (lq >> 1) * 4;
  const int brow = wni * NT * 8 + (lq >> 1) * 8 + l8, bcol = (lq & 1) * 4;
  const int ncol = wni * NT * 8 + 4 * g;  // spmm: this lane's B columns

  // The ring holds stage st (its dense tile feeds the mma), st + 1 (its
  // values are decompressed into the other A tile meanwhile) and the
  // copies of the stages after: one barrier per stage.
  for (int st = 0; st < pl.stages - 1; ++st) load(st, st);
  mma::wait_ring(pl.stages);  // stage 0 landed
  __syncthreads();
  decompress(0, 0);
  int slot = 0, fill = pl.stages - 1;  // ring slots of stages st, st + S - 1
  for (int st = 0; st < nst; ++st, slot = next(slot), fill = next(fill)) {
    mma::wait_ring(pl.stages - 1);  // stage st + 1 landed
    __syncthreads();  // A tile st % 2 written, stage st + 1 visible, the
                      // other A tile and stage st - 1 free
    load(st + pl.stages - 1, fill);
    const unsigned char* base = ring + slot * ly.stage;
    const float* at = abuf + (st & 1) * BM * AS;
    const float* bt = reinterpret_cast<const float*>(base + ly.boff);
    const int kb = kbeg + st * KS;
    const int nks = (min(kend, kb + KS) - kb + 7) / 8;  // live k-steps
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      if (ks >= nks) break;
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        ldsm_x4(ah[mi], at + (arow + mi * 16) * AS + ks * 8 + acol);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_tf32(__uint_as_float(ah[mi][q]), ah[mi][q], al[mi][q]);
      }
      float b[NT][2];
      if constexpr (Spmm) {  // n tile nj, lane column g: dense column 4g + nj
        const int bstr = ly.bstride / 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 f = *reinterpret_cast<const float4*>(
              bt + (ks * 8 + t + 4 * h) * bstr + ncol);
          b[0][h] = f.x, b[1][h] = f.y, b[2][h] = f.z, b[3][h] = f.w;
        }
      } else {
#pragma unroll
        for (int nj = 0; nj < NT; nj += 2) {
          uint32_t r[4];
          ldsm_x4(r, bt + (brow + nj * 8) * AS + ks * 8 + bcol);
          b[nj][0] = __uint_as_float(r[0]);
          b[nj][1] = __uint_as_float(r[1]);
          b[nj + 1][0] = __uint_as_float(r[2]);
          b[nj + 1][1] = __uint_as_float(r[3]);
        }
      }
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int h = 0; h < 2; ++h) split_tf32(b[nj][h], bh[nj][h], bl[nj][h]);
      // small products first, then the large one, all into one f32 sum
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) mma_tf32(acc[mi][nj], al[mi], bh[nj]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) mma_tf32(acc[mi][nj], ah[mi], bl[nj]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) mma_tf32(acc[mi][nj], ah[mi], bh[nj]);
      // the next stage's decompress among this stage's mma (a stage with
      // a next one has all its k-steps)
      if (ks == 1 && st + 1 < nst) decompress(st + 1, next(slot));
    }
  }

  // D fragment: acc[mi][nj][2h + e] is compressed row m0 + wmi*32 + mi*16 +
  // g + 8h and dense column n0 + wni*32 + nj*8 + 2t + e (spmm, whose n
  // tiles interleave: + 4(2t + e) + nj).  With splits, each split's f32
  // sums go to its slice of the workspace.
  float* out = pl.splits > 1 ? a.ws + (size_t)blockIdx.z * a.R * a.C : a.y;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wmi * 16 * MT + mi * 16 + g + 8 * h;
      if (r >= a.R) continue;
      if constexpr (Spmm) {  // 8 adjacent columns of row r: two 16-byte runs
        const int c0 = n0 + wni * 8 * NT + 8 * t;
        float v[8];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int nj = 0; nj < NT; ++nj) v[4 * e + nj] = acc[mi][nj][2 * h + e];
        float* row = out + (size_t)r * a.C;
        if (a.ovec && c0 + 8 <= a.C) {
          *reinterpret_cast<float4*>(row + c0) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(row + c0 + 4) = make_float4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (c0 + q < a.C) row[c0 + q] = v[q];
        }
      } else {
#pragma unroll
        for (int nj = 0; nj < NT; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + wni * 8 * NT + nj * 8 + 2 * t + e;
            if (c < a.C) out[(size_t)c * a.R + r] = acc[mi][nj][2 * h + e];
          }
      }
    }
}

// ------------------------------------------------------------------ host

inline int round_up(int v, int a) { return (v + a - 1) / a * a; }

// The plan's checks, then the layout it implies; false if the plan is not
// one this body runs or the CTA needs more than the wrapper sized.
template <bool Spmm, class Idx>
bool check_plan(Args<Idx>& a) {
  const Plan& p = a.pl;
  const int threads = 32 * p.wm * p.wn;
  if (p.wm < 1 || p.wn < 1 || threads > 256 || p.stages < 3 || p.stages > 4 ||
      p.splits < 1 || p.kper <= 0 || p.kper % kBK ||
      (long long)p.kper * p.splits < a.K || (long long)p.kper * (p.splits - 1) >= a.K ||
      (p.splits > 1 && a.ws == nullptr))
    return false;
  const int BM = 32 * p.wm, BN = 32 * p.wn;
  Layout& ly = a.ly;
  ly.ks = stage_cols(a.m);
  const int E = ly.ks / a.m * a.n;
  ly.vstride = round_up(4 * E, 16);
  ly.istride = round_up(a.idx.row_bytes(E), 16);
  ly.bstride = Spmm ? 4 * (BN + 8) : 4 * (ly.ks + 4);
  ly.ioff = BM * ly.vstride;
  ly.boff = ly.ioff + BM * ly.istride;
  ly.stage = round_up(ly.boff + (Spmm ? ly.ks : BN) * ly.bstride, 128);
  ly.aoff = 2 * BM * (ly.ks + 4) * 4;
  ly.need = ly.aoff + p.stages * ly.stage;
  return ly.need <= p.smem && p.smem <= 232448;
}

}  // namespace tf32
}  // namespace nm
