// The bf16 tensor-core tile body shared by nm_xwt (nm_xwt.cu, int8 and
// bit-packed indices) and the onehot nm_spmv body (nm_spmv.cu):
// out[R, O] = X[R, K] . W_sp[O, K]^T with W as values [O, K/M*N] plus an
// index stream, f32 accumulation, bf16 output.
//
// Bound on the H100: device-memory bytes of the compressed stream (3 bytes
// per slot at int8 indices) at decode and prefill shapes; the dense MACs
// after the decompress fit under the tensor-core rate.  So the design keeps
// the stream flowing:
//
// * A ring of `stages` shared-memory stages (2-4), each `ss` supersteps of
//   64 columns deep, filled with cp.async.cg 16-byte copies (commit/wait
//   groups; cp.async 4-byte copies for packed words whose rows are not
//   16-byte aligned; plain loads where a row is not 16-byte aligned at
//   all).  One stage holds the values, the index bytes or packed words and
//   the X rows of its K range; one __syncthreads per stage.
// * The decompress writes no shared memory.  mma.sync.m16n8k16 takes W as
//   the A operand (16 output columns) and X as the B operand (8 rows of X;
//   "col" layout is X's own [row][k] order).  The K order inside a 16-deep
//   mma is free as long as A and B agree, so in superstep k-step s lane t
//   takes real columns 16t + 4s .. 16t + 4s + 3 for its logical k pairs
//   (2t, 2t+1) and (2t+8, 2t+9).  Over the four k-steps of a superstep a
//   lane then owns 16 contiguous columns of its rows: whole M-blocks (M
//   divides 16), i.e. one 16- or 8-byte read of values and one of indices,
//   decompressed in registers with byte permutes straight into the A
//   fragments, and two 16-byte reads of each X row for the B fragments.
//   No bank conflicts: the wrapper pads the row strides so that the 8
//   lanes of one 16-byte phase hit distinct banks.
// * mma.sync and not wgmma: the tensor cores are far from the limit (at
//   the H100's data-sheet rates the dense MACs of a llama layer at S 128
//   take ~16 us at 989 TFLOP/s, its weight stream ~27 us at 3.35 TB/s),
//   and mma.sync's register operands take the decompressed fragments
//   without a shared round trip.
// * The plan (Python: kernels/nm_spmm.py mma_plan) fixes the tile: `nt`
//   8-row n-tiles per warp (1, 4 or 8), `ws` warps along the rows (one CTA
//   covers every row of a call up to 128, so W is read once), `wo` warps of
//   32 output columns, `wk` warps that share each stage's supersteps (their
//   sums are added in shared memory in warp order), and `splits` CTAs along
//   K of `kper` columns each, whose f32 partial sums go to a workspace the
//   wrapper allocates and a second kernel adds in split order.  No float
//   atomics: the same inputs give the same bits on every run, and the int8
//   and packed instances (same plan, same order) give the same bits.  (The
//   splits of a tile as one thread block cluster, added through distributed
//   shared memory with no workspace, measured slower at S 32 and 128.)
//
// Where it stands (NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6): on
// one llama3.2-1b layer the decode body reaches about a third of the byte
// bound and the S 128 body about a fifth.  A CTA runs its stages' copies,
// decompress and mma largely one after the other, and leaving any one
// part out (tools/nm_mma_ablate.py) saves at most about a quarter: the
// time is a chain of latencies rather than one saturated unit.
#pragma once

#include "nm_tile.cuh"

namespace nm {
namespace mma {

typedef __nv_bfloat16 bf16;

constexpr int kStep = 64;  // K per superstep: four mma k-steps of 16

// bits per packed index at block size m (nm::index_bits as a constant)
__host__ __device__ constexpr int bits_for(int m) {
  return m <= 2 ? 1 : m <= 4 ? 2 : m <= 8 ? 3 : m <= 16 ? 4 : m <= 32 ? 5 : 6;
}

// The launch plan, computed by the Python wrapper.
struct Plan {
  int nt;      // 8-row n-tiles per warp: 1, 4 or 8 (a template parameter)
  int ws;      // warps along the rows: 1, 2 or 4
  int wo;      // warps along O, 32 output columns each: 1, 2 or 4
  int wk;      // warps sharing each stage's supersteps
  int ss;      // supersteps (64 columns) per stage
  int stages;  // ring depth: 2, 3 or 4
  int splits;  // CTAs along K
  int kper;    // K columns per split, a multiple of 64
};

// Byte layout of one ring stage: strides and stage bytes from the wrapper,
// offsets and the CTA's bytes from check_layout.
struct Layout {
  int vstride, istride, xstride;  // row strides: values, indices, X
  int stage;                      // bytes per stage
  int ioff, xoff;                 // offsets of the index and X tiles
  int smem;                       // dynamic shared memory of the CTA
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !live (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most stages - 2 groups are pending: the oldest stage landed
__device__ __forceinline__ void wait_ring(int stages) {
  if (stages >= 4)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (stages == 3)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ------------------------------------------------------------ index streams

// int8 in-block indices [O, nnz].  Staged as E bytes per row.
struct Int8Stream {
  const int8_t* p;
  int nnz;
  bool vec;  // nnz % 16 == 0 and a 16-byte aligned base: 16-byte copies

  static int row_bytes(int E, int) { return E; }  // the least row stride
  __device__ __forceinline__ int first_word(int) const { return 0; }

  // slots [e0, e0 + E) of rows o0 .. o0 + rows - 1; live: row < O, slot <
  // e0 + elive
  __device__ __forceinline__ void stage(unsigned char* dst, int stride, int rows,
                                        int o0, int O, int e0, int E, int elive,
                                        int) const {
    if (vec) {
      const int sh = __ffs(E / 16) - 1;  // chunks per row: a power of two
      for (int i = threadIdx.x; i < rows << sh; i += blockDim.x) {
        const int r = i >> sh, c = i & ((1 << sh) - 1);
        const bool live = o0 + r < O && c * 16 < elive;
        cp16(dst + r * stride + c * 16,
             live ? p + (size_t)(o0 + r) * nnz + e0 + c * 16 : p, live);
      }
    } else {
      for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
        const int r = i / E, c = i % E;
        const bool live = o0 + r < O && c < elive;
        dst[r * stride + c] = live ? p[(size_t)(o0 + r) * nnz + e0 + c] : 0;
      }
    }
  }

  // the P indices at stage-local slot le of a staged row (le % P == 0)
  template <int P, int M>
  __device__ __forceinline__ void read(const unsigned char* row, int le, int, int,
                                       int (&id)[P]) const {
    uint32_t w[P / 4];
    if constexpr (P == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + le);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(row + le);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) id[q] = (w[q / 4] >> (8 * (q % 4))) & 0xffu;
  }
};

// The paper's bit-packed stream: per row `wpr` 32-bit words of bits-wide
// indices, slot s of a word at bits [s*bits, (s+1)*bits).  A stage's slot
// range need not start on a word (M = 8: 10 per word), so a row's staged
// words start at word wa = e0 / per_word, rounded down to a multiple of 4
// for 16-byte copies.
struct PackedStream {
  const uint32_t* p;
  int wpr;
  int per_word;
  bool vec;  // wpr % 4 == 0 and a 16-byte aligned base: 16-byte copies

  // the least row stride: the words of E slots from a 16-byte boundary, and
  // the copies' rounding
  static int row_bytes(int E, int per_word) { return 4 * ((E + per_word - 1) / per_word + 8); }

  __device__ __forceinline__ int first_word(int e0) const {
    const int w = e0 / per_word;
    return vec ? w & ~3 : w;
  }

  __device__ __forceinline__ void stage(unsigned char* dst, int stride, int rows,
                                        int o0, int O, int e0, int, int elive,
                                        int) const {
    if (elive <= 0) return;
    const int wa = first_word(e0);
    const int wb = (e0 + elive - 1) / per_word;  // last word with a live slot
    if (vec) {
      const int cpr = (wb - wa) / 4 + 1;
      for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
        const int r = i / cpr, c = i % cpr;
        const int w = wa + 4 * c;
        const bool live = o0 + r < O && w < wpr;
        cp16(dst + r * stride + c * 16, live ? p + (size_t)(o0 + r) * wpr + w : p, live);
      }
    } else {
      const int cpr = wb - wa + 1;
      for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
        const int r = i / cpr, c = i % cpr;
        const bool live = o0 + r < O && wa + c < wpr;
        cp4(dst + r * stride + c * 4, live ? p + (size_t)(o0 + r) * wpr + wa + c : p, live);
      }
    }
  }

  // the P indices of absolute slots e .. e + P - 1 (e % P == 0); wa: the
  // stage's first staged word.  P <= per_word + 1, so they lie in at most
  // two words, and in one where P divides per_word.
  template <int P, int M>
  __device__ __forceinline__ void read(const unsigned char* row, int, int e, int wa,
                                       int (&id)[P]) const {
    constexpr int BITS = bits_for(M), PW = 32 / BITS;
    static_assert(P <= PW + 1, "a 16-column group spans at most two words");
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
    if constexpr (PW % P == 0) {  // M = 2, 4: e % P == 0, so one word
      const uint32_t word = w[e / PW - wa] >> ((e % PW) * BITS);
#pragma unroll
      for (int q = 0; q < P; ++q) id[q] = (word >> (q * BITS)) & ((1u << BITS) - 1u);
      return;
    }
    const int q0 = e / PW, q1 = (e + P - 1) / PW;
    const uint32_t lo = w[q0 - wa], hi = w[q1 - wa];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int s = e + q;
      const uint32_t src = s / PW == q0 ? lo : hi;
      id[q] = (src >> ((s % PW) * BITS)) & ((1u << BITS) - 1u);
    }
  }
};

// ------------------------------------------------------------- decompress

// 16 dense columns of one row from its P = 16N/M slots (values as bf16
// pairs in vw, indices in id) into 8 bf16-pair words w.  M = 2: one slot
// per word, shifted into place.  M = 4, 8, 16 (N <= 2): for each 4-column
// quarter of a block, one byte selector over {V, 0}: 0x44 (a zero) per
// column, 0x10 / 0x32 (the low / high value of V) at an index's column.
template <int N, int M>
__device__ __forceinline__ void decompress16(const uint32_t (&vw)[8 * N / M],
                                             const int (&id)[16 * N / M],
                                             uint32_t (&w)[8]) {
  static_assert(N <= 2 && 16 % M == 0 && N < M, "instantiated for N <= 2, M | 16");
  if constexpr (M == 2) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const uint32_t v = (b & 1) ? vw[b / 2] >> 16 : vw[b / 2] & 0xffffu;
      w[b] = v << (16 * (id[b] & 1));
    }
  } else {
#pragma unroll
    for (int b = 0; b < 16 / M; ++b) {
#pragma unroll
      for (int h = 0; h < M / 4; ++h) {
        uint32_t sel = 0x44444444u, v;
        if constexpr (N == 2) {
          v = vw[b];  // slots 2b and 2b + 1
          const int i0 = id[2 * b], i1 = id[2 * b + 1];
          if (M == 4 || (i0 >> 2) == h) sel ^= 0x54u << ((i0 & 3) * 8);
          if (M == 4 || (i1 >> 2) == h) sel ^= 0x76u << ((i1 & 3) * 8);
        } else {
          v = vw[b / 2];  // slot b: the low or the high half
          const int i0 = id[b];
          const uint32_t pick = (b & 1) ? 0x44u ^ 0x32u : 0x44u ^ 0x10u;
          if (M == 4 || (i0 >> 2) == h) sel ^= pick << ((i0 & 3) * 8);
        }
        w[b * M / 2 + 2 * h] = __byte_perm(v, 0u, sel);
        w[b * M / 2 + 2 * h + 1] = __byte_perm(v, 0u, sel >> 16);
      }
    }
  }
}

// ------------------------------------------------------------------ body

template <class Idx>
struct TileArgs {
  const bf16* x;     // [R, K]
  const bf16* vals;  // [O, K/M*N]
  Idx idx;
  bf16* y;    // [R, O]
  float* ws;  // [splits, R, O] when splits > 1
  int R, O, K;
  Plan pl;
  Layout ly;
  bool vvec;  // values rows 16-byte copyable (nnz % 8 == 0, aligned base)
  bool xvec;  // X rows 16-byte copyable (K % 8 == 0, aligned base)
};

template <int N, int M, int NT, class Idx>
__device__ __forceinline__ void tile_body(const TileArgs<Idx>& a) {
  constexpr int P = 16 * N / M;  // slots per 16 columns
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& pl = a.pl;
  const Layout& ly = a.ly;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int wo_i = warp % pl.wo, ws_i = (warp / pl.wo) % pl.ws;
  const int wk_i = warp / (pl.wo * pl.ws);
  const int BN = 32 * pl.wo, RT = 8 * NT * pl.ws, KC = kStep * pl.ss;
  const int o0 = blockIdx.x * BN, s0 = blockIdx.y * RT;
  const int kbeg = blockIdx.z * pl.kper;
  const int kend = min(a.K, kbeg + pl.kper);
  const int nst = (kend - kbeg + KC - 1) / KC;
  const int nnz = a.K / M * N;
  const int E = KC / M * N;  // slots per staged row

  auto load = [&](int st) {
    if (st < nst) {
      unsigned char* base = smem + (st % pl.stages) * ly.stage;  // < nst slots
      const int kb = kbeg + st * KC, ke = min(kend, kb + KC);
      const int e0 = kb / M * N, elive = (ke - kb) / M * N;
      if (a.vvec) {  // values: 8-slot chunks, a power of two per row
        const int sh = __ffs(E / 8) - 1;
        for (int i = threadIdx.x; i < BN << sh; i += blockDim.x) {
          const int r = i >> sh, c = i & ((1 << sh) - 1);
          const bool live = o0 + r < a.O && c * 8 < elive;
          cp16(base + r * ly.vstride + c * 16,
               live ? a.vals + (size_t)(o0 + r) * nnz + e0 + c * 8 : a.vals, live);
        }
      } else {
        for (int i = threadIdx.x; i < BN * E; i += blockDim.x) {
          const int r = i / E, c = i % E;
          const bool live = o0 + r < a.O && c < elive;
          reinterpret_cast<bf16*>(base + r * ly.vstride)[c] =
              live ? a.vals[(size_t)(o0 + r) * nnz + e0 + c] : __float2bfloat16(0.f);
        }
      }
      a.idx.stage(base + ly.ioff, ly.istride, BN, o0, a.O, e0, E, elive, 0);
      if (a.xvec) {  // X: 8-column chunks, a power of two per row
        const int sh = __ffs(KC / 8) - 1;
        for (int i = threadIdx.x; i < RT << sh; i += blockDim.x) {
          const int r = i >> sh, c = i & ((1 << sh) - 1);
          const bool live = s0 + r < a.R && kb + c * 8 < ke;
          cp16(base + ly.xoff + r * ly.xstride + c * 16,
               live ? a.x + (size_t)(s0 + r) * a.K + kb + c * 8 : a.x, live);
        }
      } else {
        for (int i = threadIdx.x; i < RT * KC; i += blockDim.x) {
          const int r = i / KC, c = i % KC;
          const bool live = s0 + r < a.R && kb + c < ke;
          reinterpret_cast<bf16*>(base + ly.xoff + r * ly.xstride)[c] =
              live ? a.x[(size_t)(s0 + r) * a.K + kb + c] : __float2bfloat16(0.f);
        }
      }
    }
    commit();  // an empty group past the end keeps the count uniform
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.f;

  for (int st = 0; st < pl.stages - 1; ++st) load(st);
  for (int st = 0; st < nst; ++st) {
    wait_ring(pl.stages);
    __syncthreads();  // stage st visible to all; stage st - 1 consumed by all
    load(st + pl.stages - 1);
    const unsigned char* base = smem + (st % pl.stages) * ly.stage;
    const int kb = kbeg + st * KC, ke = min(kend, kb + KC);
    const int e0 = kb / M * N;
    const int wa = a.idx.first_word(e0);
    for (int j = wk_i; j < pl.ss && kb + j * kStep < ke; j += pl.wk) {
      const int le = (j * kStep + 16 * t) / M * N;  // stage-local slot
      uint32_t af[2][2][8];  // [m-tile][row g / g + 8][column pair]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wo_i * 32 + mi * 16 + h * 8 + g;
          const unsigned char* vrow = base + r * ly.vstride + le * 2;
          uint32_t vw[P / 2];
          if constexpr (P == 8) {
            const uint4 v = *reinterpret_cast<const uint4*>(vrow);
            vw[0] = v.x, vw[1] = v.y, vw[2] = v.z, vw[3] = v.w;
          } else {
            const uint2 v = *reinterpret_cast<const uint2*>(vrow);
            vw[0] = v.x, vw[1] = v.y;
          }
          int id[P];
          a.idx.template read<P, M>(base + ly.ioff + r * ly.istride, le, e0 + le, wa, id);
          decompress16<N, M>(vw, id, af[mi][h]);
        }
      // X: one 16-byte load per n-tile covers two k-steps (conflict-free:
      // xstride = 16 mod 128); all NT loads are issued before the first
      // mma, and within a k-step consecutive mma write different
      // accumulators, so no mma waits on the one before it
      const unsigned char* xcol = base + ly.xoff + (ws_i * NT * 8 + g) * ly.xstride +
                                  (j * kStep + 16 * t) * 2;
#pragma unroll
      for (int sp = 0; sp < 4; sp += 2) {
        uint4 xb[NT];
#pragma unroll
        for (int j8 = 0; j8 < NT; ++j8)
          xb[j8] = *reinterpret_cast<const uint4*>(xcol + j8 * 8 * ly.xstride + 8 * sp);
#pragma unroll
        for (int s = sp; s < sp + 2; ++s)
#pragma unroll
          for (int j8 = 0; j8 < NT; ++j8) {
            const uint32_t b[2] = {s == sp ? xb[j8].x : xb[j8].z,
                                   s == sp ? xb[j8].y : xb[j8].w};
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const uint32_t af4[4] = {af[mi][0][2 * s], af[mi][1][2 * s],
                                       af[mi][0][2 * s + 1], af[mi][1][2 * s + 1]};
              mma_bf16(acc[mi][j8], af4, b);
            }
          }
      }
    }
  }

  // The wk warps that share a tile's stages add into warp wk_i = 0 in warp
  // order, through shared memory.
  if (pl.wk > 1) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the ring is free
    float* red = reinterpret_cast<float*>(smem);
    const int tiles = pl.wo * pl.ws, tile = warp % tiles;
    constexpr int V = 2 * NT * 4;
    auto slot = [&](int w, int v) { return ((w * tiles + tile) * V + v) * 32 + lane; };
    if (wk_i > 0) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        red[slot(wk_i - 1, v)] = acc[v / (NT * 4)][(v / 4) % NT][v % 4];
    }
    __syncthreads();
    if (wk_i > 0) return;
    for (int w = 1; w < pl.wk; ++w)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v / (NT * 4)][(v / 4) % NT][v % 4] += red[slot(w - 1, v)];
  }

  // D fragment: acc[mi][j8][2h + q] is output column o0 + wo_i*32 + mi*16 +
  // g + 8h (a row of W) and row s0 + (ws_i*NT + j8)*8 + 2t + q (a row of X).
  // With splits, each split's f32 sums go to its slice of the workspace.
  float* part = pl.splits > 1 ? a.ws + (size_t)blockIdx.z * a.R * a.O : nullptr;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j8 = 0; j8 < NT; ++j8)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int o = o0 + wo_i * 32 + mi * 16 + g + 8 * h;
          const int s = s0 + (ws_i * NT + j8) * 8 + 2 * t + q;
          if (o >= a.O || s >= a.R) continue;
          const float v = acc[mi][j8][2 * h + q];
          if (part)
            part[(size_t)s * a.O + o] = v;
          else
            a.y[(size_t)s * a.O + o] = __float2bfloat16(v);
        }
}

// y = sum over splits of ws[z] (rounded to T), added in split order
template <typename T>
__device__ __forceinline__ void reduce_splits(const float* ws, T* y, int count,
                                              int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    // loads in batches of 8 (in flight together), added in split order
    float s = 0.f;
    for (int z0 = 0; z0 < splits; z0 += 8) {
      float p[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        p[q] = z0 + q < splits ? ws[(size_t)(z0 + q) * count + i] : 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (z0 + q < splits) s = z0 + q == 0 ? p[q] : s + p[q];
    }
    y[i] = from_f32<T>(s);
  }
}

// ------------------------------------------------------------------ host

// Check the stage layout the wrapper computed (kernels/nm_spmm.py layout:
// the row strides' padding against bank conflicts is chosen there): every
// stride 16-byte aligned and wide enough for its row, the stage wide enough
// for its three tiles, and the CTA's shared memory under the limit.  Fills
// in the tile offsets and the CTA's bytes.
template <int N, int M, int NT, class Idx>
bool check_layout(TileArgs<Idx>& a) {
  const Plan& p = a.pl;
  const int BN = 32 * p.wo, RT = 8 * NT * p.ws, KC = kStep * p.ss;
  const int E = KC / M * N;
  Layout& ly = a.ly;
  if (ly.vstride % 16 || ly.istride % 16 || ly.xstride % 16 || ly.stage % 128 ||
      ly.vstride < 2 * E || ly.istride < Idx::row_bytes(E, 32 / bits_for(M)) ||
      ly.xstride < 2 * KC)
    return false;
  ly.ioff = BN * ly.vstride;
  ly.xoff = ly.ioff + BN * ly.istride;
  if (ly.stage < ly.xoff + RT * ly.xstride) return false;
  const int red = (p.wk - 1) * p.wo * p.ws * (2 * NT * 4) * 32 * 4;
  // a CTA walks at most ceil(kper / KC) stages: no more ring slots than that
  const int slots = min(p.stages, (p.kper + KC - 1) / KC);
  ly.smem = max(slots * ly.stage, red);
  return ly.smem <= 232448;
}

inline bool plan_ok(const Plan& p, int K, bool has_ws) {
  const int threads = 32 * p.wo * p.ws * p.wk;
  return (p.ws == 1 || p.ws == 2 || p.ws == 4) && (p.wo == 1 || p.wo == 2 || p.wo == 4) &&
         p.wk >= 1 && threads <= 256 && (p.ss == 1 || p.ss == 2 || p.ss == 4) &&
         p.stages >= 2 &&
         p.stages <= 4 && p.splits >= 1 && p.kper > 0 && p.kper % kStep == 0 &&
         (long long)p.kper * p.splits >= K && (long long)p.kper * (p.splits - 1) < K &&
         (p.splits == 1 || has_ws);
}

// Launch `kern` (a __global__ wrapper of tile_body<N, M, NT, Idx>) and,
// with splits > 1, `reduce` over the workspace.
template <int N, int M, int NT, class Idx>
int launch(void (*kern)(TileArgs<Idx>), void (*reduce)(const float*, bf16*, int, int),
           TileArgs<Idx> a, cudaStream_t s, int& smem_set) {
  if (!plan_ok(a.pl, a.K, a.ws != nullptr) || !check_layout<N, M, NT>(a))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.ly.smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.ly.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = a.ly.smem;
  }
  const Plan& p = a.pl;
  const dim3 grid((a.O + 32 * p.wo - 1) / (32 * p.wo),
                  (a.R + 8 * NT * p.ws - 1) / (8 * NT * p.ws), p.splits);
  kern<<<grid, 32 * p.wo * p.ws * p.wk, a.ly.smem, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return static_cast<int>(e);
  const int count = a.R * a.O;
  const int blocks = min((count + 255) / 256, 132 * 8);
  reduce<<<blocks, 256, 0, s>>>(a.ws, a.y, count, p.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma
}  // namespace nm
