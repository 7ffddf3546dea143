// nm_spmv: decode-shaped Y[B, O] = X[B, K] . W_sp^T on the compressed N:M
// stream (values [O, K/M*N] + int8 in-block indices).
//
// Replaces src/repro/kernels/nm_spmv.py::nm_spmv_kernel (gather body).
// Bound on the H100: device-memory bytes.  Each weight row is read once
// (values + indices, 3/4 of a dense bf16 row at 2:4); only the N/M nonzero
// MACs are done, far below the FMA rate.  Design (the paper's vindexmac on
// this card): x is resident in shared memory once per CTA, stored
// batch-interleaved, xs[k][b] for a group of BG = 1, 2, 4 or 8 batch rows,
// so that ONE indexed read at column block*M + idx returns that column for
// every batch row of the group (16 bytes, one ld.shared.v4, for bf16 at
// BG 8), which is then multiply-accumulated against one weight value.  A
// warp streams 4 rows together: lane (r, s) takes slots s*8 .. s*8 + 7 of
// each 64 of row r, so a row's step is one 128-byte line of values (the
// weight stream stays as dense as one row per warp), and the 8 lanes of a
// shared-memory phase are 4 rows at 2 adjacent slot runs.  Their reads
// fall in 2 M-blocks; columns whose lane span is odd are XOR-swizzled to
// the other half of the banks, so the phase reads distinct banks, equal
// columns broadcast, and no read waits on a bank conflict at M <= 4
// whatever the indices (a warp per row gathered at random and lost a third
// of its time to conflicts).  CTAs are persistent over row groups: grid
// (ctas, splits, batch groups) of 8 warps; kw warps share a row group,
// each streaming one K part of it, and add their sums in shared memory in
// warp order (kw = 8 gives the small-O linears, wk and wv at O 512, a CTA
// per row group without splitting K).  A lane's 8 slots are one 16-byte
// value load and one 8-byte index load (evict-first), four steps in
// flight in a register ring; the first steps are issued before x is
// staged, so the stage hides behind them.  Accumulation is f32 in
// registers; at a row group's end a row's BG sums are reduced over its 8
// lanes by exchanges that halve the values a lane holds.  K is split
// across CTAs (grid.y) where the rows alone cannot fill the card or x does
// not fit: partial sums go to an f32 workspace [splits, B, O], and the
// last CTA of a row set to arrive (an int counter per set, reset by that
// CTA) adds them in split order, so two launches give the same bits and no
// float atomics are used.  The plan (batch group, kw, CTAs, splits,
// columns per split) is computed by the wrapper (kernels/nm_spmv.py
// gather_plan); the launcher only checks it.  bf16 at N:M in {1:2, 1:4,
// 2:4, 2:8} runs instances with N and M fixed at compile time; other N:M
// (0 < n < m <= 127) and f32 run a general instance.  What bounds it now
// (tools/nm_mma_ablate.py --body gather): the 8 bf16-to-f32 conversions
// and FMAs per nonzero and the latency of a read whose address waits on
// the index.
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

constexpr int kBGroup = 8;            // batch rows per CTA (onehot body)

// ------------------------------------------------------------ gather body

constexpr int kGWarps = 8;                  // warps per CTA
constexpr int kGThreads = kGWarps * 32;
constexpr int kGroupRows = 4;               // rows a warp streams together
constexpr int kLaneSlots = 8;               // slots per lane per step
constexpr int kRowSlots = 32 / kGroupRows * kLaneSlots;  // a row's slots per step
constexpr int kDepth = 4;                   // steps in flight per warp
constexpr int kSmemLimit = 232448;          // dynamic shared memory per CTA

struct GatherArgs {
  const void* x;
  const void* vals;
  const int8_t* idx;
  void* y;
  float* ws;   // [splits, B, O] partial sums (splits > 1)
  int* cnt;    // [ctas * groups] arrivals per row set, zero between launches
  int B, O, K, n, m;
  int kw;      // warps sharing a row group, each a K part of the split
  int splits, kper;
  int sh;      // swizzle shift: columns with bit sh set swap bank halves
  bool xvec, wvec;
};

__host__ __device__ constexpr int ilog2(int v) { return v > 1 ? 1 + ilog2(v / 2) : 0; }

// One lane's slice of a step: 8 values and their 8 int8 indices.
template <typename T>
struct WFrag {
  static constexpr int kVec = kLaneSlots * (int)sizeof(T) / 16;
  uint4 v[kVec];
  uint2 i;
};

// The bytes of one x column (BG batch rows of T) in shared memory.
template <typename T, int BG>
struct XCol {
  static constexpr int kBytes = BG * (int)sizeof(T);
  __device__ __forceinline__ static void load(const unsigned char* xs, int phys,
                                              float (&xv)[BG]) {
    alignas(16) T t[BG];
    const unsigned char* p = xs + phys * kBytes;
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int q = 0; q < kBytes / 16; ++q)
        reinterpret_cast<uint4*>(t)[q] = reinterpret_cast<const uint4*>(p)[q];
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(t) = *reinterpret_cast<const uint2*>(p);
    } else if constexpr (kBytes == 4) {
      *reinterpret_cast<uint32_t*>(t) = *reinterpret_cast<const uint32_t*>(p);
    } else {
      *reinterpret_cast<uint16_t*>(t) = *reinterpret_cast<const uint16_t*>(p);
    }
#pragma unroll
    for (int b = 0; b < BG; ++b) xv[b] = to_f32(t[b]);
  }
  __device__ __forceinline__ static void store(unsigned char* xs, int phys,
                                               const T (&t)[BG]) {
    unsigned char* p = xs + phys * kBytes;
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int q = 0; q < kBytes / 16; ++q)
        reinterpret_cast<uint4*>(p)[q] = reinterpret_cast<const uint4*>(t)[q];
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(t);
    } else if constexpr (kBytes == 4) {
      *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(t);
    } else {
      *reinterpret_cast<uint16_t*>(p) = *reinterpret_cast<const uint16_t*>(t);
    }
  }
};

// Columns of at least 16 bytes are swizzled (the gather reads them with
// 16-byte loads): bit 2 flips where bit sh >= 3 is set, so the columns of
// adjacent lane spans (2^sh columns each) sit on opposite halves of the
// banks; a bijection inside each aligned group of 8 columns.
template <typename T, int BG>
__device__ __forceinline__ int swizzle(int c, int sh) {
  if constexpr (XCol<T, BG>::kBytes >= 16) return c ^ (((c >> sh) & 1) << 2);
  return c;
}

// xs[phys(c)][b] = x[b0 + b][k0 + c] for c < klen, zero for b >= nb.
template <typename T, int BG>
__device__ __forceinline__ void stage_x(unsigned char* xs, const T* x, int K,
                                        int k0, int klen, int b0, int nb,
                                        int sh, bool xvec) {
  constexpr int VK = 16 / (int)sizeof(T);
  const T zero = from_f32<T>(0.f);
  if (xvec) {  // K and k0 are multiples of VK, x 16-byte aligned
    for (int v = threadIdx.x; v < klen / VK; v += kGThreads) {
      alignas(16) T run[BG][VK];
#pragma unroll
      for (int b = 0; b < BG; ++b) {
        uint4 r = make_uint4(0, 0, 0, 0);
        if (b < nb)
          r = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(b0 + b) * K + k0) + v);
        *reinterpret_cast<uint4*>(run[b]) = r;
      }
#pragma unroll
      for (int c = 0; c < VK; ++c) {
        alignas(16) T col[BG];
#pragma unroll
        for (int b = 0; b < BG; ++b) col[b] = run[b][c];
        XCol<T, BG>::store(xs, swizzle<T, BG>(v * VK + c, sh), col);
      }
    }
  } else {
    for (int c = threadIdx.x; c < klen; c += kGThreads) {
      alignas(16) T col[BG];
#pragma unroll
      for (int b = 0; b < BG; ++b)
        col[b] = b < nb ? x[(size_t)(b0 + b) * K + k0 + c] : zero;
      XCol<T, BG>::store(xs, swizzle<T, BG>(c, sh), col);
    }
  }
}

// Load one lane's slots [e, e + 8) of a row (e1: the split's end slot).
template <typename T>
__device__ __forceinline__ void load_frag(WFrag<T>& f, const T* vals,
                                          const int8_t* idx, size_t row, int e,
                                          int e1, bool wvec) {
  if (wvec) {  // the row's slot count and e are multiples of 8: all or none
    if (e < e1) {
      const uint4* vp = reinterpret_cast<const uint4*>(vals + row + e);
#pragma unroll
      for (int q = 0; q < WFrag<T>::kVec; ++q) f.v[q] = __ldcs(vp + q);
      f.i = __ldcs(reinterpret_cast<const uint2*>(idx + row + e));
    }
  } else {
    T* vv = reinterpret_cast<T*>(f.v);
    int8_t* ii = reinterpret_cast<int8_t*>(&f.i);
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j) {
      const bool live = e + j < e1;
      vv[j] = live ? vals[row + e + j] : from_f32<T>(0.f);
      ii[j] = live ? idx[row + e + j] : 0;
    }
  }
}

// acc[b] += w_j * x[b][col_j] over the lane's live slots q0 .. q0 + live - 1
// (slot numbers inside the split; FULL: all 8 live).  N, M > 0: fixed at
// compile time (N divides 8, M a power of two); 0: the runtime n, m.
template <typename T, int BG, int N, int M, bool FULL>
__device__ __forceinline__ void gather_frag(const WFrag<T>& f,
                                            const unsigned char* xs, int q0,
                                            int live, int n, int m, int sh,
                                            float (&acc)[BG]) {
  const T* vv = reinterpret_cast<const T*>(f.v);
  const int8_t* ii = reinterpret_cast<const int8_t*>(&f.i);
  if constexpr (N > 0) {
    constexpr int SH = ilog2(8 * M / N);  // the lane's span of columns
    constexpr bool SWZ = XCol<T, BG>::kBytes >= 16;
    const int base = q0 / N * M;          // a multiple of 2^SH
    const int key = SWZ ? ((base >> SH) & 1) << 2 : 0;
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j) {
      if (FULL || j < live) {
        // base + (off ^ key) == swizzle(base + off): off < 2^SH
        const int off = (j / N) * M + ii[j];
        float xv[BG];
        XCol<T, BG>::load(xs, base + (SWZ ? off ^ key : off), xv);
        const float w = to_f32(vv[j]);
#pragma unroll
        for (int b = 0; b < BG; ++b) acc[b] = fmaf(w, xv[b], acc[b]);
      }
    }
  } else {
    int blk = q0 / n, r = q0 - blk * n;
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j) {
      if (FULL || j < live) {
        float xv[BG];
        XCol<T, BG>::load(xs, swizzle<T, BG>(blk * m + ii[j], sh), xv);
        const float w = to_f32(vv[j]);
#pragma unroll
        for (int b = 0; b < BG; ++b) acc[b] = fmaf(w, xv[b], acc[b]);
      }
      if (++r == n) r = 0, ++blk;
    }
  }
}

// The sums of a row over its 8 lanes (lane bits 2, 3 and 4).  Each
// exchange halves the values a lane holds while it holds more than one; a
// lane is left with kOut sums, for batch rows first * kOut + i, and writes
// them when `writer`.
template <int BG>
struct RowSum {
  static constexpr int kOut = BG >= 8 ? BG / 8 : 1;
  int first;
  bool writer;
  __device__ __forceinline__ RowSum(float (&acc)[BG], int lane) {
    int cnt = BG, bsel = 0;
    bool w = true;
#pragma unroll
    for (int off = 16; off >= kGroupRows; off /= 2) {
      const bool up = lane & off;
      if (cnt > 1) {
#pragma unroll
        for (int i = 0; i < BG / 2; ++i) {
          if (i < cnt / 2) {
            const float send = up ? acc[i] : acc[i + cnt / 2];
            const float keep = up ? acc[i + cnt / 2] : acc[i];
            acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
          }
        }
        cnt /= 2;
        bsel = 2 * bsel + (up ? 1 : 0);
      } else {
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
        w = w && !up;
      }
    }
    first = bsel;
    writer = w;
  }
};

template <typename T, int BG, int N, int M>
__global__ void __launch_bounds__(kGThreads, 2)
nm_spmv_gather_kernel(GatherArgs a) {
  extern __shared__ __align__(16) unsigned char xs[];
  __shared__ float red[2][kGWarps][kGroupRows][BG];  // [pass & 1][warp][row][b]
  __shared__ int last;
  const T* vals = static_cast<const T*>(a.vals);
  T* y = static_cast<T*>(a.y);
  const int n = N > 0 ? N : a.n, m = N > 0 ? M : a.m;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rs = lane % kGroupRows, ss = lane / kGroupRows;  // row, slot run
  const int kw = a.kw, part = warp % kw, sub = warp / kw;
  const int per_pass = kGWarps / kw;       // row groups a CTA takes at once
  const int g = blockIdx.x, G = gridDim.x, split = blockIdx.y;
  const int b0 = blockIdx.z * BG, nb = min(BG, a.B - b0);
  const int k0 = split * a.kper, klen = min(a.kper, a.K - k0);
  const int nnz = a.K / m * n;
  const int e0 = k0 / m * n;              // the split's first slot of a row
  const int es = klen / m * n;            // its slots per row
  // this warp's K part: slots [p0, p1) of the split, whole steps
  const int ep = (es + kw * kRowSlots - 1) / (kw * kRowSlots) * kRowSlots;
  const int p0 = part * ep, p1 = min(es, p0 + ep);
  const int steps = ep / kRowSlots;
  const int groups = (a.O + kGroupRows - 1) / kGroupRows;
  const int gstride = G * per_pass;       // row groups between passes
  const int first = g * per_pass;         // the CTA's first row group
  const int passes = (groups - first + gstride - 1) / gstride;
  const int ntask = passes * steps;       // the same for every warp
  const int rstride = gstride * kGroupRows;

  // the register ring: task t is (pass t / steps, step t % steps); this
  // lane streams row (first + pass * gstride + sub) * 4 + rs, slots p0 +
  // step * 64 + ss * 8 .. + 7
  WFrag<T> ring[kDepth];
  const int row0 = (first + sub) * kGroupRows + rs;
  int lrow = row0, lst = 0, lt = 0;
  auto issue = [&](WFrag<T>& f) {
    if (lt < ntask && lrow < a.O)
      load_frag(f, vals, a.idx, (size_t)lrow * nnz + e0,
                p0 + lst * kRowSlots + ss * kLaneSlots, p1, a.wvec);
    ++lt;
    if (++lst == steps) lst = 0, lrow += rstride;
  };
#pragma unroll
  for (int d = 0; d < kDepth; ++d) issue(ring[d]);
  stage_x<T, BG>(xs, static_cast<const T*>(a.x), a.K, k0, klen, b0, nb, a.sh, a.xvec);
  __syncthreads();

  float acc[BG];
#pragma unroll
  for (int b = 0; b < BG; ++b) acc[b] = 0.f;
  int crow = row0, cst = 0, pass = 0;
  for (int t = 0; t < ntask; t += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (t + d < ntask) {
        const WFrag<T> f = ring[d];
        issue(ring[d]);
        const int q0 = p0 + cst * kRowSlots + ss * kLaneSlots;
        const int live = crow < a.O ? min(kLaneSlots, max(0, p1 - q0)) : 0;
        if (live == kLaneSlots)
          gather_frag<T, BG, N, M, true>(f, xs, q0, live, n, m, a.sh, acc);
        else if (live > 0)
          gather_frag<T, BG, N, M, false>(f, xs, q0, live, n, m, a.sh, acc);
        if (++cst == steps) {
          const RowSum<BG> sum(acc, lane);
          if (kw == 1) {
            if (sum.writer && crow < a.O) {
#pragma unroll
              for (int i = 0; i < RowSum<BG>::kOut; ++i) {
                const int b = sum.first * RowSum<BG>::kOut + i;
                if (b < nb) {
                  if (a.splits == 1)
                    y[(size_t)(b0 + b) * a.O + crow] = from_f32<T>(acc[i]);
                  else
                    a.ws[((size_t)split * a.B + b0 + b) * a.O + crow] = acc[i];
                }
              }
            }
          } else {  // the kw parts of each row group add in part order
            float (*buf)[kGroupRows][BG] = red[pass & 1];
            if (sum.writer) {
#pragma unroll
              for (int i = 0; i < RowSum<BG>::kOut; ++i)
                buf[warp][rs][sum.first * RowSum<BG>::kOut + i] = acc[i];
            }
            __syncthreads();
            for (int u = threadIdx.x; u < per_pass * kGroupRows * nb; u += kGThreads) {
              const int b = u % nb, r = u / nb % kGroupRows, q = u / (nb * kGroupRows);
              const int row = (first + pass * gstride + q) * kGroupRows + r;
              if (row >= a.O) continue;
              float v = buf[q * kw][r][b];
              for (int p = 1; p < kw; ++p) v += buf[q * kw + p][r][b];
              if (a.splits == 1)
                y[(size_t)(b0 + b) * a.O + row] = from_f32<T>(v);
              else
                a.ws[((size_t)split * a.B + b0 + b) * a.O + row] = v;
            }
          }
#pragma unroll
          for (int b = 0; b < BG; ++b) acc[b] = 0.f;
          cst = 0, crow += rstride, ++pass;
        }
      }
    }
  }
  if (a.splits == 1) return;

  // the last CTA of this row set to arrive adds the splits in order
  __threadfence();
  __syncthreads();
  int* cnt = a.cnt + blockIdx.z * G + g;
  if (threadIdx.x == 0) last = atomicAdd(cnt, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int pass_rows = per_pass * kGroupRows;
  for (int t = threadIdx.x; t < passes * nb * pass_rows; t += kGThreads) {
    const int r = t % pass_rows, b = t / pass_rows % nb, i = t / (pass_rows * nb);
    const int row = (first + i * gstride) * kGroupRows + r;
    if (row >= a.O) continue;
    const float* p = a.ws + (size_t)(b0 + b) * a.O + row;
    float v = __ldcg(p);
    for (int z = 1; z < a.splits; ++z) v += __ldcg(p + (size_t)z * a.B * a.O);
    y[(size_t)(b0 + b) * a.O + row] = from_f32<T>(v);
  }
  if (threadIdx.x == 0) *cnt = 0;
}

template <typename T, int BG, int N, int M>
int run_gather(const GatherArgs& a, dim3 grid, int smem, cudaStream_t s) {
  // per instance, in this library: the dynamic memory a launch may ask
  // without opting in is 48 KB less the kernel's static reduction scratch
  // (a 48 KB x slice, B 8 bf16 at K 3072, failed to launch otherwise)
  static int smem_set = -1;
  auto* kern = nm_spmv_gather_kernel<T, BG, N, M>;
  if (smem_set < 0) {
    cudaFuncAttributes at;
    const cudaError_t e = cudaFuncGetAttributes(&at, kern);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = 48 * 1024 - static_cast<int>(at.sharedSizeBytes);
  }
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  kern<<<grid, kGThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BG>
int gather_nm(const GatherArgs& a, dim3 grid, int smem, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (a.n == 1 && a.m == 2) return run_gather<T, BG, 1, 2>(a, grid, smem, s);
    if (a.n == 1 && a.m == 4) return run_gather<T, BG, 1, 4>(a, grid, smem, s);
    if (a.n == 2 && a.m == 4) return run_gather<T, BG, 2, 4>(a, grid, smem, s);
    if (a.n == 2 && a.m == 8) return run_gather<T, BG, 2, 8>(a, grid, smem, s);
  }
  return run_gather<T, BG, 0, 0>(a, grid, smem, s);
}

// Check the wrapper's plan (batch group bg, warps per row group kw, CTAs
// per split and batch group, splits, columns per split) and launch.
template <typename T>
int launch_gather(GatherArgs a, int bg, int ctas, cudaStream_t s) {
  const int n = a.n, m = a.m, K = a.K;
  if (a.kper <= 0 || a.kper % m || a.kper % 8 || a.kper / m * n % 8 ||
      a.splits < 1 || (long long)a.splits * a.kper < K ||
      (long long)(a.splits - 1) * a.kper >= K || ctas < 1 ||
      (a.kw != 1 && a.kw != 2 && a.kw != 4 && a.kw != 8) ||
      (long long)(ctas - 1) * (kGWarps / a.kw) * kGroupRows >= a.O ||
      (a.splits > 1 && (a.ws == nullptr || a.cnt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = a.kper * bg * (int)sizeof(T);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int VK = 16 / (int)sizeof(T);
  a.xvec = K % VK == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  a.wvec = (K / m * n) % kLaneSlots == 0 &&
           reinterpret_cast<uintptr_t>(a.vals) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(a.idx) % 8 == 0;
  a.sh = ilog2(8 * m / n);   // >= 3: 8m/n > 8
  const dim3 grid(ctas, a.splits, (a.B + bg - 1) / bg);
  switch (bg) {
    case 1: return gather_nm<T, 1>(a, grid, smem, s);
    case 2: return gather_nm<T, 2>(a, grid, smem, s);
    case 4: return gather_nm<T, 4>(a, grid, smem, s);
    case 8: return gather_nm<T, 8>(a, grid, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// bg, kw, ctas, splits, kper: the gather plan (kernels/nm_spmv.py
// gather_plan);
// ws: the f32 split workspace [splits, B, O] and cnt: the int32 arrival
// counters [ctas * ceil(B / bg)], zero on entry and left zero, both unused
// (may be null) at one split.
extern "C" int nm_spmv_launch(const void* x, const void* vals, const void* idx,
                              void* y, int B, int O, int K, int n, int m,
                              int dtype, int bg, int kw, int ctas, int splits,
                              int kper, void* ws, void* cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || m <= n || m > 127 || K % m) return static_cast<int>(cudaErrorInvalidValue);
  GatherArgs a{};
  a.x = x, a.vals = vals, a.idx = static_cast<const int8_t*>(idx), a.y = y;
  a.ws = static_cast<float*>(ws), a.cnt = static_cast<int*>(cnt);
  a.B = B, a.O = O, a.K = K, a.n = n, a.m = m, a.kw = kw;
  a.splits = splits, a.kper = kper;
  if (dtype == REPRO_DTYPE_F32) return launch_gather<float>(a, bg, ctas, s);
  if (dtype == REPRO_DTYPE_BF16) return launch_gather<__nv_bfloat16>(a, bg, ctas, s);
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
