// paged_gqa_verify: flash-decoding over the paged KV pool for a span of S
// consecutive query tokens per slot, query heads grouped by kv head.  The
// one-token decode is the span S = 1: ``paged_gqa_decode`` and
// ``paged_gqa_verify`` (kernels/flash_attention.py) both launch this kernel,
// each with its own launch counter.
//
//   q      [B, S, KVH, G, D]         (T = float or bf16)
//   k_pool [n_blocks, BS, KVH, D]    v_pool [n_blocks, BS, KVH, DV]
//   table  int32 [B, Tw]             kv_len int32 [B] (for span offset 0)
//   out    float32 [B, S, KVH, G, DV]
//
// Replaces src/repro/kernels/flash_attention.py::paged_gqa_decode
// (_paged_gqa_body) and ::paged_gqa_verify, which launches paged_gqa_decode
// once per span offset i with kv_len + i.  Row (i, g) sees kv_len + i
// positions: its own kv_len mask, the optional sliding window
// (kpos > kv_len + i - 1 - window) and the optional softcap
// cap * tanh(s / cap), as the reference body applies them; positions past
// the table are not read (the reference's trailing trash tiles are fully
// masked); output acc / max(l, 1e-30), so a row that sees nothing gives 0.
//
// Bound on the H100: device-memory bytes — every K/V position a slot owns
// is read once, against 2 * (D + DV) FLOPs per query row and position (the
// bound of PERF.md section 6 is under a microsecond at the serving shape).
// At 8 slots the launch is latency-bound: what costs is a chain of
// dependent steps per CTA and CTAs left idle.
//
// The launch plan (CTAs, warps, chunk, shared memory, workspace) comes from
// kernels/flash_attention.py gqa_plan; the launcher only checks it.
//
// Tensor-core body (bf16, D and DV multiples of 16 up to 256, G <= 16,
// block size dividing the chunk): the KV axis is cut into chunks of 64
// positions fixed in absolute position (chunk c holds blocks
// [c * 64 / BS, (c + 1) * 64 / BS) of the table), one CTA per (chunk,
// slot x kv head, group of up to 4 span rows), 4 warps, one per span row.
// The CTA copies the chunk's K and V tiles with 16-byte cp.async straight
// into shared memory, all at once and with all 4 warps also at S = 1 (the
// blocks no row of the CTA sees are zero-filled), and each warp scores its
// span row's G query rows as one 16-row m tile (rows past G are zero; row
// g sits in the same place at every S) against the 64 positions:
// S = Q K^T and O = P V on mma.sync
// m16n8k16 with f32 accumulation, the scale, softcap and masks on the
// scores in registers, the softmax across the 4 lanes of a row, and P
// split into hi + lo bf16 for two P V products (P rounded once to bf16
// would miss 2e-4).  A row that sees one chunk writes its output; a row
// spanning several writes its chunk's partial (m, l, acc) to the workspace
// and the last of its chunks to arrive (an int counter per row, reset to 0
// by that CTA; no float atomics) folds them in chunk order, the loads of
// several chunks in flight at once.  A chunk that holds no position a row
// sees is not visited for that row,
// and the k-steps of 16 positions past a row's view are skipped: a fully
// masked step would leave m, l and acc as they are.  So a row's arithmetic
// depends only on its own length, window and query: span offset i equals
// an S = 1 launch at kv_len + i bit for bit.
//
// First body (f32, and other shapes): one CTA per (slot, kv head) holds
// all S * G query rows of that kv head in shared memory (rows split into
// several CTAs only when S * G * DV exceeds the 1024 accumulators of 128
// threads) and walks the slot's block table itself, up to
// ceil((kv_len + S - 1) / BS); each step stages physical block
// table[b, j] of K and V as f32 in shared memory and scores the rows
// against it with CUDA-core FMAs, each row updating its f32 online-softmax
// state and stopping at its own ceil((kv_len + i) / BS) steps.  A row's
// operations never depend on the other rows.  S = 1 runs the decode
// instance (Span = false): the per-row lengths and checks compile away.
#include <math.h>

#include "attn_mma.cuh"

namespace {

namespace first {


constexpr int kThreads = 128;
constexpr int kMaxPairs = 8;  // (row, c) accumulators per thread: R*DV <= 1024
constexpr float kNeg = -1e30f;

// Span = false is the S = 1 (decode) instance: every row sees kv_len
// positions, so the per-row lengths and step checks compile away.
template <typename T, bool Span>
__global__ void __launch_bounds__(kThreads)
paged_gqa_verify_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp,
                        const int* __restrict__ table,
                        const int* __restrict__ kv_len, float* __restrict__ out,
                        int S, int KVH, int G, int D, int DV, int BS, int Tw,
                        int rows_per_cta, float scale, int window, float cap) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.y * rows_per_cta;            // first span row (i*G+g)
  const int R = min(rows_per_cta, S * G - r0);         // rows of this CTA
  float* qs = smem;            // [R, D]
  float* ks = qs + R * D;      // [BS, D]
  float* vs = ks + BS * D;     // [BS, DV]
  float* ps = vs + BS * DV;    // [R, BS] scores, then probabilities
  float* ms = ps + R * BS;     // [R] running max
  float* ls = ms + R;          // [R] running denominator
  float* cs = ls + R;          // [R] this step's rescale factor
  int* rlen = reinterpret_cast<int*>(cs + R);  // [R] positions row r sees
  int* rsteps = rlen + R;      // [R] block steps row r updates in

  const int tid = threadIdx.x;
  const int b = blockIdx.x / KVH;
  const int h = blockIdx.x % KVH;
  const int L0 = kv_len[b];
  // the last row of the CTA sees the most positions
  const int steps = min((L0 + (r0 + R - 1) / G + BS - 1) / BS, Tw);

  if (Span) {
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = r0 + i / D, d = i % D;
      const int si = r / G, g = r % G;
      qs[i] = to_f32(q[((((size_t)b * S + si) * KVH + h) * G + g) * D + d]);
    }
  } else {  // S = 1: the CTA's rows are one contiguous run of q
    const T* qrow = q + ((size_t)blockIdx.x * G + r0) * D;
    for (int i = tid; i < R * D; i += kThreads) qs[i] = to_f32(qrow[i]);
  }
  for (int r = tid; r < R; r += kThreads) {
    ms[r] = kNeg;
    ls[r] = 0.f;
    if (Span) {
      rlen[r] = L0 + (r0 + r) / G;
      rsteps[r] = min((rlen[r] + BS - 1) / BS, Tw);
    }
  }
  float acc[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) acc[i] = 0.f;

  for (int j = 0; j < steps; ++j) {
    __syncthreads();  // previous step done with ks/vs/ps
    const size_t pid = (size_t)table[(size_t)b * Tw + j];
    for (int i = tid; i < BS * D; i += kThreads) {
      const int t = i / D, d = i % D;
      ks[i] = to_f32(kp[((pid * BS + t) * KVH + h) * D + d]);
    }
    for (int i = tid; i < BS * DV; i += kThreads) {
      const int t = i / DV, d = i % DV;
      vs[i] = to_f32(vp[((pid * BS + t) * KVH + h) * DV + d]);
    }
    __syncthreads();
    for (int i = tid; i < R * BS; i += kThreads) {
      const int r = i / BS, t = i % BS;
      const int L = Span ? rlen[r] : L0;
      float s = 0.f;
      // rotate the start column by t so the lanes of a warp (consecutive
      // t) read different shared-memory banks
      for (int dd = 0; dd < D; ++dd) {
        const int d = (dd + t) % D;
        s = fmaf(qs[r * D + d], ks[t * D + d], s);
      }
      s *= scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      const int kpos = j * BS + t;
      bool ok = kpos < L;
      if (window >= 0) ok = ok && kpos > L - 1 - window;
      ps[i] = ok ? s : kNeg;
    }
    __syncthreads();
    for (int r = tid; r < R; r += kThreads) {
      if (Span && j >= rsteps[r]) continue;  // past this row's walk
      const int L = Span ? rlen[r] : L0;
      const float m_prev = ms[r];
      float m_new = m_prev;
      for (int t = 0; t < BS; ++t) m_new = fmaxf(m_new, ps[r * BS + t]);
      float sum = 0.f;
      for (int t = 0; t < BS; ++t) {
        const int kpos = j * BS + t;
        bool ok = kpos < L;
        if (window >= 0) ok = ok && kpos > L - 1 - window;
        const float p = ok ? expf(ps[r * BS + t] - m_new) : 0.f;
        ps[r * BS + t] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      ls[r] = ls[r] * corr + sum;
      ms[r] = m_new;
      cs[r] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int pair = tid + i * kThreads;
      if (pair >= R * DV) break;
      const int r = pair / DV, c = pair % DV;
      if (Span && j >= rsteps[r]) continue;
      float a = acc[i] * cs[r];
      for (int t = 0; t < BS; ++t) a = fmaf(ps[r * BS + t], vs[t * DV + c], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  // S = 1: the CTA's output rows are one contiguous run
  float* orow = out + ((size_t)blockIdx.x * G + r0) * DV;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int pair = tid + i * kThreads;
    if (pair >= R * DV) break;
    const int r = pair / DV, c = pair % DV;
    const float v = acc[i] / fmaxf(ls[r], 1e-30f);
    if (Span) {
      const int si = (r0 + r) / G, g = (r0 + r) % G;
      out[((((size_t)b * S + si) * KVH + h) * G + g) * DV + c] = v;
    } else {
      orow[pair] = v;
    }
  }
}


int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* kv_len, void* out, int B, int S,
           int KVH, int G, int D, int DV, int BS, int Tw, float scale,
           int window, float cap, int dtype, int rows, int threads, int smem,
           int gx, int gy, int gz, cudaStream_t st) {
  const int need = (rows * D + BS * D + BS * DV + rows * BS + 5 * rows) *
                   (int)sizeof(float);
  if (DV > kThreads * kMaxPairs || rows != min(S * G, kThreads * kMaxPairs / DV) ||
      threads != kThreads || smem < need || gx != B * KVH ||
      gy != (S * G + rows - 1) / rows || gz != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(gx, gy);
  auto run = [&](auto kern, auto tq) {
    using T = decltype(tq);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), static_cast<const int*>(table),
        static_cast<const int*>(kv_len), static_cast<float*>(out), S, KVH, G,
        D, DV, BS, Tw, rows, scale, window, cap);
    return static_cast<int>(cudaGetLastError());
  };
  if (dtype == REPRO_DTYPE_F32)
    return S == 1 ? run(paged_gqa_verify_kernel<float, false>, 0.f)
                  : run(paged_gqa_verify_kernel<float, true>, 0.f);
  if (dtype == REPRO_DTYPE_BF16)
    return S == 1 ? run(paged_gqa_verify_kernel<__nv_bfloat16, false>, __nv_bfloat16())
                  : run(paged_gqa_verify_kernel<__nv_bfloat16, true>, __nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace first

// ------------------------------------------- bf16, tensor-core body

namespace tc {

using namespace attn;

constexpr int kChunk = 64;       // positions per chunk, fixed in absolute position
constexpr int kNS = kChunk / 8;  // score n-tiles of a chunk
constexpr int kMaxRows = 4;      // span rows per CTA, one warp each
constexpr float kNeg = -1e30f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* table;
  const int* kv_len;
  float* out;
  float* ws;  // [B * KVH * S][chunks][G * (DV + 2)] partials (chunks > 1)
  int* cnt;   // [B * KVH * S] arrival counters, 0 between launches
  int S, KVH, G, D, DV, BS, Tw, rows, chunks;
  float scale;
  int window;
  float cap;
};

// What a row of L visible positions attends to: positions [lo, top), held
// by chunks [c0, c1).  A row that sees nothing gets chunk 0, all of it
// masked: its output is 0.
struct RowSpan {
  int lo, top, c0, c1;
  __device__ RowSpan(int L, int window, int BS, int Tw) {
    top = min(L, Tw * BS);
    lo = window >= 0 ? max(0, L - window) : 0;
    c0 = lo / kChunk;
    c1 = (top + kChunk - 1) / kChunk;
    if (lo >= top) c0 = 0, c1 = 1;
  }
  __device__ bool sees(int pos) const { return pos >= lo && pos < top; }
  __device__ bool holds(int c) const { return c >= c0 && c < c1; }
};

template <int DVMAX>
__global__ void __launch_bounds__(32 * kMaxRows)
paged_gqa_verify_tc_kernel(Args a) {
  constexpr int NO = DVMAX / 8;  // output n-tiles (DV / 8 of them live)
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, DV = a.DV, DS = D + 8, VS = DV + 8;
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [kChunk][DS]
  bf16* vs = ks + kChunk * DS;               // [kChunk][VS]
  bf16* qs = vs + kChunk * VS;               // [rows][16][DS]
  const int c = blockIdx.x, b = blockIdx.y / a.KVH, h = blockIdx.y % a.KVH;
  const int i0 = blockIdx.z * a.rows, nrows = min(a.rows, a.S - i0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int L0 = a.kv_len[b];

  // the CTA runs if chunk c holds a position of one of its rows; the rows
  // see nested ranges: the first the lowest lo, the last the highest top
  bool need = false;
  for (int r = 0; r < nrows; ++r)
    need = need || RowSpan(L0 + i0 + r, a.window, a.BS, a.Tw).holds(c);
  if (!need) return;
  const int lo = RowSpan(L0 + i0, a.window, a.BS, a.Tw).lo;
  const int top = RowSpan(L0 + i0 + nrows - 1, a.window, a.BS, a.Tw).top;

  // K / V tiles of chunk c; blocks past the table or outside every row's
  // view are zero-filled (their p is 0)
  const int CB = kChunk / a.BS, pd = D / 8, pv = DV / 8;
  for (int idx = threadIdx.x; idx < kChunk * (pd + pv); idx += blockDim.x) {
    const bool isk = idx < kChunk * pd;
    const int e = isk ? idx : idx - kChunk * pd, per = isk ? pd : pv;
    const int p = e / per, col = e % per;
    const int j = c * CB + p / a.BS, pos0 = j * a.BS;
    const bool live = j < a.Tw && pos0 < top && pos0 + a.BS > lo;
    const int pid = live ? __ldg(a.table + (size_t)b * a.Tw + j) : 0;
    const size_t row = ((size_t)pid * a.BS + p % a.BS) * a.KVH + h;
    if (isk)
      cp16(ks + p * DS + col * 8, a.k + row * D + col * 8, live);
    else
      cp16(vs + p * VS + col * 8, a.v + row * DV + col * 8, live);
  }
  // each span row's G query rows as a 16-row tile, rows past G zero
  for (int idx = threadIdx.x; idx < nrows * 16 * pd; idx += blockDim.x) {
    const int r = idx / (16 * pd), gg = idx / pd % 16, col = idx % pd;
    const bool live = gg < a.G;
    const size_t qrow = (((size_t)b * a.S + i0 + r) * a.KVH + h) * a.G + (live ? gg : 0);
    cp16(qs + (r * 16 + gg) * DS + col * 8, a.q + qrow * D + col * 8, live);
  }
  commit();
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (warp >= nrows) return;
  const int i = i0 + warp;
  const RowSpan sp(L0 + i, a.window, a.BS, a.Tw);
  if (!sp.holds(c)) return;
  const int g = lane / 4, t = lane % 4;
  const bf16* qw = qs + warp * 16 * DS;

  // S = Q K^T: 16 query rows x 64 positions
  float s[kNS][4];
#pragma unroll
  for (int nt = 0; nt < kNS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t aq[4];
    ldsm_x4(aq, qw + (lane & 15) * DS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kNS / 2; ++np) {
      uint32_t bk[4];
      ldsm_x4(bk, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * DS + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      const uint32_t b0[2] = {bk[0], bk[1]}, b1[2] = {bk[2], bk[3]};
      mma_bf16(s[2 * np], aq, b0);
      mma_bf16(s[2 * np + 1], aq, b1);
    }
  }

  // scale, softcap, masks; the softmax of the chunk across a row's 4 lanes
  const int base = c * kChunk;
  uint32_t live = 0;
  float m[2] = {kNeg, kNeg};
#pragma unroll
  for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[nt][e] * a.scale;
      if (a.cap > 0.f) v = a.cap * tanhf(v / a.cap);
      s[nt][e] = v;
      if (g + 8 * (e >> 1) < a.G && sp.sees(base + nt * 8 + 2 * t + (e & 1))) {
        live |= 1u << (nt * 4 + e);
        m[e >> 1] = fmaxf(m[e >> 1], v);
      }
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
  uint32_t ph[kNS / 2][4], pl[kNS / 2][4];
#pragma unroll
  for (int nt = 0; nt < kNS; ++nt) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = (live >> (nt * 4 + e)) & 1 ? exp2f((s[nt][e] - m[e >> 1]) * kLog2e) : 0.f;
      l[e >> 1] += p[e];
    }
    split_bf16(p[0], p[1], ph[nt / 2][(nt & 1) * 2], pl[nt / 2][(nt & 1) * 2]);
    split_bf16(p[2], p[3], ph[nt / 2][(nt & 1) * 2 + 1], pl[nt / 2][(nt & 1) * 2 + 1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // O = P V over the k-steps of 16 positions that hold a position the row
  // sees (the others add p = 0 and are skipped), P as hi + lo bf16
  float o[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
  for (int kp = 0; kp < kChunk / 16; ++kp) {
    const int p0 = base + kp * 16;
    if (p0 >= sp.top || p0 + 16 <= sp.lo) continue;
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      if (np * 16 < DV) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vs + (kp * 16 + (lane & 15)) * VS + np * 16 + (lane >> 4) * 8);
        const uint32_t b0[2] = {bv[0], bv[1]}, b1[2] = {bv[2], bv[3]};
        mma_bf16(o[2 * np], ph[kp], b0);
        mma_bf16(o[2 * np + 1], ph[kp], b1);
        mma_bf16(o[2 * np], pl[kp], b0);
        mma_bf16(o[2 * np + 1], pl[kp], b1);
      }
    }
  }

  // more than one chunk: park this chunk's partial, and the last chunk of
  // the row to arrive folds them all
  const int pr = (b * a.KVH + h) * a.S + i;
  if (sp.c1 - sp.c0 > 1) {
    const int stride = a.G * (DV + 2);
    float* ws = a.ws + (size_t)pr * a.chunks * stride;
    float* part = ws + (size_t)c * stride;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= a.G) continue;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
        if (nt * 8 < DV)
          *reinterpret_cast<float2*>(part + row * DV + nt * 8 + 2 * t) =
              make_float2(o[nt][2 * r], o[nt][2 * r + 1]);
      if (t == 0) {
        part[a.G * DV + row] = m[r];
        part[a.G * DV + a.G + row] = l[r];
      }
    }
    __threadfence();
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      last = atomicAdd(a.cnt + pr, 1) == sp.c1 - sp.c0 - 1;
      if (last) a.cnt[pr] = 0;
    }
    if (!__shfl_sync(0xffffffffu, last, 0)) return;
    __threadfence();
    // the fold, in chunk order from the empty state; unrolled so that the
    // loads of several chunks are in flight before their merges
    m[0] = m[1] = kNeg;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll 4
    for (int cc = sp.c0; cc < sp.c1; ++cc) {
      const float* p = ws + (size_t)cc * stride;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r;
        if (row >= a.G) continue;
        float sa, sb;
        merge_weights(m[r], __ldcg(p + a.G * DV + row), &sa, &sb);
        l[r] = l[r] * sa + __ldcg(p + a.G * DV + a.G + row) * sb;
#pragma unroll
        for (int nt = 0; nt < NO; ++nt)
          if (nt * 8 < DV) {
            const float2 x = __ldcg(reinterpret_cast<const float2*>(p + row * DV + nt * 8 + 2 * t));
            o[nt][2 * r] = o[nt][2 * r] * sa + x.x * sb;
            o[nt][2 * r + 1] = o[nt][2 * r + 1] * sa + x.y * sb;
          }
      }
    }
  }
  const size_t orow = (((size_t)b * a.S + i) * a.KVH + h) * a.G;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= a.G) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* dst = a.out + (orow + row) * DV;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
      if (nt * 8 < DV)
        *reinterpret_cast<float2*>(dst + nt * 8 + 2 * t) =
            make_float2(o[nt][2 * r] / den, o[nt][2 * r + 1] / den);
  }
}

int smem_bytes(int D, int DV, int rows) {
  return 2 * (kChunk * (D + 8) + kChunk * (DV + 8) + rows * 16 * (D + 8));
}

template <int DVMAX>
int run(const Args& a, int smem, dim3 grid, int threads, cudaStream_t st) {
  static int smem_set = 48 * 1024;  // per instance, in this library
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_gqa_verify_tc_kernel<DVMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  paged_gqa_verify_tc_kernel<DVMAX><<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Args& a, int B, int chunk, int threads, int smem, int gx,
           int gy, int gz, cudaStream_t st) {
  auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int chunks = max(1, (a.Tw * a.BS + kChunk - 1) / kChunk);
  if (chunk != kChunk || kChunk % a.BS || a.D % 16 || a.DV % 16 || a.D > 256 ||
      a.DV > 256 || a.G > 16 || a.rows < 1 || a.rows > kMaxRows ||
      threads != 32 * kMaxRows || gx != chunks ||
      gy != B * a.KVH || gz != (a.S + a.rows - 1) / a.rows ||
      smem < smem_bytes(a.D, a.DV, a.rows) || !al(a.q) || !al(a.k) || !al(a.v) ||
      (chunks > 1 && (a.ws == nullptr || a.cnt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(gx, gy, gz);
  if (a.DV <= 64) return run<64>(a, smem, grid, threads, st);
  if (a.DV <= 128) return run<128>(a, smem, grid, threads, st);
  return run<256>(a, smem, grid, threads, st);
}

}  // namespace tc

}  // namespace

// body 1: the tensor-core body (bf16), 0: the first body.  The plan's ints
// come from kernels/flash_attention.py gqa_plan; a plan this library does
// not take returns cudaErrorInvalidValue.  window < 0: no window; cap <= 0:
// no softcap.
extern "C" int paged_gqa_verify_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* kv_len, void* out, int B, int S, int KVH, int G, int D, int DV,
    int BS, int Tw, float scale, int window, float cap, int dtype, int body,
    int chunk, int rows, int threads, int smem, int gx, int gy, int gz,
    void* ws, void* cnt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 0 && chunk == 0)
    return first::launch(q, k_pool, v_pool, table, kv_len, out, B, S, KVH, G,
                         D, DV, BS, Tw, scale, window, cap, dtype, rows,
                         threads, smem, gx, gy, gz, st);
  if (body != 1 || dtype != REPRO_DTYPE_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::Args a{static_cast<const __nv_bfloat16*>(q),
                   static_cast<const __nv_bfloat16*>(k_pool),
                   static_cast<const __nv_bfloat16*>(v_pool),
                   static_cast<const int*>(table),
                   static_cast<const int*>(kv_len),
                   static_cast<float*>(out),
                   static_cast<float*>(ws),
                   static_cast<int*>(cnt),
                   S, KVH, G, D, DV, BS, Tw, rows, gx, scale, window, cap};
  return tc::launch(a, B, chunk, threads, smem, gx, gy, gz, st);
}
