// paged_mla_verify: absorbed MLA flash-decoding over the paged latent pool
// for a span of S consecutive query tokens per slot.  The one-token decode
// is the span S = 1: ``paged_mla_decode`` and ``paged_mla_verify``
// (kernels/flash_attention.py) both launch this kernel, each with its own
// launch counter.
//
//   q_lat  float32 [B, S, H, R]   q_pe float32 [B, S, H, RD]
//   ckv    [n_blocks, BS, R]      kpe  [n_blocks, BS, RD]   (T = float or bf16)
//   table  int32 [B, Tw]          kv_len int32 [B] (for span offset 0)
//   out    float32 [B, S, H, R]   latent context; the caller up-projects it
//
// Replaces src/repro/kernels/flash_attention.py::paged_mla_decode
// (_paged_mla_body) and ::paged_mla_verify, which launches paged_mla_decode
// once per span offset i with kv_len + i.  Scores are
// (q_lat . ckv + q_pe . kpe) * scale and the value operand is the latent
// cache itself; span row i sees kv_len + i positions, positions past the
// table are not read, output acc / max(l, 1e-30).
//
// Bound on the H100: device-memory bytes — every latent position a slot
// owns is read once, (R + RD) values, against 2 * (R + RD) + 2 * R FLOPs
// per query row and position (PERF.md section 6: about a microsecond at
// the serving shape).  At 8 slots the launch is latency-bound, and all H
// heads of a slot read the same latent block.
//
// The launch plan (CTAs, chunk, shared memory, workspace) comes from
// kernels/flash_attention.py mla_plan; the launcher only checks it.
//
// Tensor-core body (bf16 pools, R and RD multiples of 16, R <= 512,
// R + RD <= 640, H <= 16, block size dividing the chunk): the KV axis is
// cut into chunks
// of 64 positions fixed in absolute position, one CTA of 8 warps per
// (chunk, span row, slot) holding all H heads of the row as one 16-row m
// tile, so each latent block is read once per span row instead of once per
// head.  The CTA copies the chunk's [ckv | kpe] rows with 16-byte cp.async
// straight into shared memory, all at once, behind the f32 queries' loads
// (all in flight, issued before the row's length is read), which it splits
// into hi + lo bf16 (two mma on hi and lo carry about 16 bits of the
// query).  S = Q K^T on mma.sync m16n8k16: warp w scores positions
// 8w .. 8w + 7 over the whole depth R + RD in four accumulation chains
// (hi / lo, even / odd k-steps) added in a fixed order.  The softmax runs
// row-parallel (two head rows per warp, lanes across positions), and P,
// split into hi + lo bf16, multiplies the latent on the tensor cores, each
// warp owning 16-column slices of the R output columns (32 accumulators a
// thread at R = 512).  k-steps of 16 positions past the row's view are
// skipped.  A row whose view fits one chunk writes its output; otherwise
// each chunk parks its partial (m, l, acc) in the workspace and the last of
// the row's chunks to arrive (an int counter per row, reset to 0 by that
// CTA; no float atomics) folds chunks 0 .. ceil(L / 64) - 1 in order, the
// loop unrolled so that the loads of two chunks are in flight before their
// merges (a fold that waited on each chunk's loads in turn cost several
// microseconds a chunk).  A row's arithmetic depends only on its own
// length and query, so span offset i equals an S = 1 launch at
// kv_len + i bit for bit.
//
// First body (f32 pools, and other shapes): one CTA of 128 threads per
// (slot, head) holding up to 4 span rows; it walks the slot's block table
// up to ceil((kv_len + S - 1) / BS), staging each block as f32 rows
// [ckv | kpe] in shared memory with 16-byte loads (several in flight per
// thread); one warp per (row, position) score dot with a shuffle sum, the
// softmax over a block by one thread per row, and R / 128 accumulator
// columns per row and thread.  A row stops at its own
// ceil((kv_len + i) / BS) steps and never depends on the other rows.
#include <math.h>

#include "attn_mma.cuh"

namespace {

namespace first {


constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairs = 8;  // accumulator columns per thread: R <= 1024
constexpr int kMaxRows = 4;   // span rows per CTA (acc is kMaxRows x kMaxPairs)
constexpr float kNeg = -1e30f;
constexpr int kInFlight = 4;  // 16-byte loads per thread issued before use

// Stage `rows` x `cols` elements of `src` (row-major) as f32 into `dst` with
// leading dimension `ld`.  16-byte vector loads when every row starts
// 16-byte aligned, element loads otherwise.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const T* __restrict__ src,
                                           int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int n = rows * cols;
  if (cols % V == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n / V;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int base = 0; base < nv; base += kThreads * kInFlight) {
      uint4 buf[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int v = base + u * kThreads + threadIdx.x;
        if (v < nv) buf[u] = __ldg(s4 + v);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int v = base + u * kThreads + threadIdx.x;
        if (v < nv) {
          const T* e = reinterpret_cast<const T*>(&buf[u]);
          const int t = (v * V) / cols, c = (v * V) % cols;
#pragma unroll
          for (int k = 0; k < V; ++k) dst[t * ld + c + k] = to_f32(e[k]);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      dst[(i / cols) * ld + i % cols] = to_f32(src[i]);
  }
}

template <typename T, int MaxRows>
__global__ void __launch_bounds__(kThreads)
paged_mla_verify_kernel(const float* __restrict__ q_lat,
                        const float* __restrict__ q_pe,
                        const T* __restrict__ ckv, const T* __restrict__ kpe,
                        const int* __restrict__ table,
                        const int* __restrict__ kv_len,
                        float* __restrict__ out, int S, int H, int R, int RD,
                        int BS, int Tw, float scale) {
  extern __shared__ float smem[];
  const int D = R + RD;
  const int i0 = blockIdx.y * MaxRows;          // first span row of this CTA
  const int NR = min(MaxRows, S - i0);           // rows of this CTA
  float* qs = smem;            // [NR, D]  row i's query: q_lat | q_pe
  float* ks = qs + NR * D;     // [BS, D]  row t: ckv(t) | kpe(t)
  float* ps = ks + BS * D;     // [NR, BS] scores, then probabilities
  __shared__ float m_s[MaxRows], l_s[MaxRows], c_s[MaxRows];
  __shared__ int st_s[MaxRows];  // block steps row r updates in

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int L0 = kv_len[b] + i0;                 // positions row 0 sees
  const int steps = min((L0 + NR - 1 + BS - 1) / BS, Tw);

  for (int r = 0; r < NR; ++r) {
    const size_t row = ((size_t)b * S + i0 + r) * H + h;
    for (int i = tid; i < R; i += kThreads) qs[r * D + i] = q_lat[row * R + i];
    for (int i = tid; i < RD; i += kThreads)
      qs[r * D + R + i] = q_pe[row * RD + i];
  }
  if (tid < NR) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
    st_s[tid] = min((L0 + tid + BS - 1) / BS, Tw);
  }
  float acc[MaxRows][kMaxPairs];
#pragma unroll
  for (int r = 0; r < MaxRows; ++r)
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) acc[r][i] = 0.f;

  for (int j = 0; j < steps; ++j) {
    __syncthreads();  // previous step done with ks / ps
    const size_t pid = (size_t)table[(size_t)b * Tw + j];
    stage_rows(ks, D, ckv + pid * BS * R, BS, R);
    stage_rows(ks + R, D, kpe + pid * BS * RD, BS, RD);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MaxRows; ++r) {
      if (r >= NR) break;
      for (int t = warp; t < BS; t += kWarps) {
        float s = 0.f;
        for (int d = lane; d < D; d += 32)
          s = fmaf(qs[r * D + d], ks[t * D + d], s);
        s = warp_sum(s);
        if (lane == 0)
          ps[r * BS + t] = (j * BS + t < L0 + r) ? s * scale : kNeg;
      }
    }
    __syncthreads();
    if (tid < NR && j < st_s[tid]) {
      const int r = tid, L = L0 + r;
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int t = 0; t < BS; ++t) m_new = fmaxf(m_new, ps[r * BS + t]);
      float sum = 0.f;
      for (int t = 0; t < BS; ++t) {
        const float p = (j * BS + t < L) ? expf(ps[r * BS + t] - m_new) : 0.f;
        ps[r * BS + t] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      l_s[r] = l_s[r] * corr + sum;
      m_s[r] = m_new;
      c_s[r] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MaxRows; ++r) {
      if (r >= NR || j >= st_s[r]) continue;
      const float corr = c_s[r];
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        const int c = tid + i * kThreads;
        if (c >= R) break;
        float a = acc[r][i] * corr;
        for (int t = 0; t < BS; ++t) a = fmaf(ps[r * BS + t], ks[t * D + c], a);
        acc[r][i] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MaxRows; ++r) {
    if (r >= NR) break;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    float* orow = out + (((size_t)b * S + i0 + r) * H + h) * R;
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int c = tid + i * kThreads;
      if (c >= R) break;
      orow[c] = acc[r][i] * inv;
    }
  }
}


int launch(const void* q_lat, const void* q_pe, const void* ckv,
           const void* kpe, const void* table, const void* kv_len, void* out,
           int B, int S, int H, int R, int RD, int BS, int Tw, float scale,
           int dtype, int rows, int threads, int smem, int gx, int gy, int gz,
           cudaStream_t st) {
  const int max_rows = S == 1 ? 1 : kMaxRows;
  const int need = ((R + RD) * (rows + BS) + rows * BS) * (int)sizeof(float);
  if (R > kThreads * kMaxPairs || rows != min(S, max_rows) ||
      threads != kThreads || smem < need || gx != B * H ||
      gy != (S + max_rows - 1) / max_rows || gz != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(gx, gy);
  auto run = [&](auto kern, auto tq) {
    using T = decltype(tq);
    // the opt-in is needed past 48 KB less the kernel's static row state
    cudaFuncAttributes at;
    cudaError_t e = cudaFuncGetAttributes(&at, kern);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (smem + static_cast<int>(at.sharedSizeBytes) > 48 * 1024) {
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q_lat), static_cast<const float*>(q_pe),
        static_cast<const T*>(ckv), static_cast<const T*>(kpe),
        static_cast<const int*>(table), static_cast<const int*>(kv_len),
        static_cast<float*>(out), S, H, R, RD, BS, Tw, scale);
    return static_cast<int>(cudaGetLastError());
  };
  // S = 1 runs the one-row instance (R / 128 accumulators per thread)
  if (dtype == REPRO_DTYPE_F32)
    return S == 1 ? run(paged_mla_verify_kernel<float, 1>, 0.f)
                  : run(paged_mla_verify_kernel<float, kMaxRows>, 0.f);
  if (dtype == REPRO_DTYPE_BF16)
    return S == 1 ? run(paged_mla_verify_kernel<__nv_bfloat16, 1>, __nv_bfloat16())
                  : run(paged_mla_verify_kernel<__nv_bfloat16, kMaxRows>, __nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace first

// ------------------------------------------- bf16, tensor-core body

namespace tc {

using namespace attn;

constexpr int kChunk = 64;     // positions per chunk, fixed in absolute position
constexpr int kWarps = 8;      // warp w scores positions 8w .. 8w + 7
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;      // head rows of the m tile (H <= 16)
constexpr int kMaxPairs = 4;   // 16-column output slices per warp: R <= 512
constexpr int kPS = kChunk + 8;  // row stride of P in shared memory
constexpr int kMaxDepth = 640;   // R + RD: kTile * kMaxDepth / 4 float4
constexpr int kQ = kTile * kMaxDepth / 4 / kThreads;  // query loads per thread
constexpr float kNeg = -1e30f;
static_assert(kChunk == 8 * kWarps, "one score n-tile per warp");

struct Args {
  const float* q_lat;
  const float* q_pe;
  const bf16* ckv;
  const bf16* kpe;
  const int* table;
  const int* kv_len;
  float* out;
  float* ws;  // [B * S][chunks][H * (R + 2)] partials (chunks > 1)
  int* cnt;   // [B * S] arrival counters, 0 between launches
  int S, H, R, RD, BS, Tw, chunks;
  float scale;
};

__global__ void __launch_bounds__(kThreads)
paged_mla_verify_tc_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = a.R, D = R + a.RD, DS = D + 8;
  bf16* qh = reinterpret_cast<bf16*>(smem);  // [kTile][DS] query, hi
  bf16* ql = qh + kTile * DS;                 // [kTile][DS] query, lo
  bf16* kv = ql + kTile * DS;                 // [kChunk][DS]: ckv | kpe
  bf16* ph = kv + kChunk * DS;                // [kTile][kPS] P, hi
  bf16* pl = ph + kTile * kPS;                // [kTile][kPS] P, lo
  float* sc = reinterpret_cast<float*>(pl + kTile * kPS);  // [kTile][kChunk]
  float* ms = sc + kTile * kChunk;            // [kTile] row max
  float* ls = ms + kTile;                     // [kTile] row sum
  __shared__ int last_s;
  const int c = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  // the row's H queries [q_lat | q_pe], all loads in flight before the
  // row's length is known; rows past H are zero
  const int qw = D / 4;
  float4 qx[kQ];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int idx = threadIdx.x + u * kThreads, hh = idx / qw, col = idx % qw * 4;
    qx[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (hh < a.H) {
      const size_t q = ((size_t)b * a.S + i) * a.H + hh;
      qx[u] = col < R ? __ldg(reinterpret_cast<const float4*>(a.q_lat + q * R + col))
                      : __ldg(reinterpret_cast<const float4*>(a.q_pe + q * a.RD + col - R));
    }
  }
  const int L = a.kv_len[b] + i, top = min(L, a.Tw * a.BS);
  // chunks 0 .. nc - 1 hold the row's view; a row that sees nothing gets
  // chunk 0, all of it masked
  const int nc = max(1, (top + kChunk - 1) / kChunk);
  if (c >= nc) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // the chunk's latent rows; blocks past the table or the view zero-filled
  const int CB = kChunk / a.BS, pr = R / 8, per = pr + a.RD / 8;
  for (int idx = threadIdx.x; idx < kChunk * per; idx += kThreads) {
    const int p = idx / per, col = idx % per;
    const int j = c * CB + p / a.BS;
    const bool live = j < a.Tw && j * a.BS < top;
    const size_t row = (size_t)(live ? __ldg(a.table + (size_t)b * a.Tw + j) : 0) * a.BS + p % a.BS;
    const bf16* src = col < pr ? a.ckv + row * R + col * 8 : a.kpe + row * a.RD + (col - pr) * 8;
    cp16(kv + p * DS + col * 8, src, live);
  }
  commit();
  // the queries as hi + lo bf16
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int idx = threadIdx.x + u * kThreads, hh = idx / qw, col = idx % qw * 4;
    if (hh >= kTile) break;
    uint2 hi, lo;
    split_bf16(qx[u].x, qx[u].y, hi.x, lo.x);
    split_bf16(qx[u].z, qx[u].w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(qh + hh * DS + col) = hi;
    *reinterpret_cast<uint2*>(ql + hh * DS + col) = lo;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // S = Q K^T for positions 8w .. 8w + 7: chains (hi, even k-step), (hi,
  // odd), (lo, even), (lo, odd), added in that fixed order
  {
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
    auto step = [&](float (&dh)[4], float (&dl)[4], int kk) {
      uint32_t ah[4], al[4], bk[2];
      ldsm_x4(ah, qh + (lane & 15) * DS + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(al, ql + (lane & 15) * DS + kk * 16 + (lane >> 4) * 8);
      ldsm_x2(bk, kv + (warp * 8 + (lane & 7)) * DS + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(dh, ah, bk);
      mma_bf16(dl, al, bk);
    };
    const int ksteps = D / 16;
    for (int kk = 0; kk < ksteps; kk += 2) {
      step(acc[0], acc[2], kk);
      if (kk + 1 < ksteps) step(acc[1], acc[3], kk + 1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[(g + 8 * (e >> 1)) * kChunk + warp * 8 + 2 * t + (e & 1)] =
          (acc[0][e] + acc[1][e]) + (acc[2][e] + acc[3][e]);
  }
  __syncthreads();

  // the softmax of the chunk, two head rows per warp, lanes across positions
  const int base = c * kChunk;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = 2 * warp + rr;
    float v[kChunk / 32], mx = kNeg;
#pragma unroll
    for (int u = 0; u < kChunk / 32; ++u) {
      v[u] = sc[row * kChunk + lane + 32 * u] * a.scale;
      if (base + lane + 32 * u < top) mx = fmaxf(mx, v[u]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < kChunk / 32; ++u) {
      const int pos = lane + 32 * u;
      const float p = base + pos < top ? exp2f((v[u] - mx) * kLog2e) : 0.f;
      const bf16 hi = __float2bfloat16(p);
      ph[row * kPS + pos] = hi;
      pl[row * kPS + pos] = __float2bfloat16(p - __bfloat162float(hi));
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) ms[row] = mx, ls[row] = sum;
  }
  __syncthreads();

  // O = P V: warp w owns the 16-column slices w, w + 8, ... of the R
  // columns; k-steps of 16 positions past the row's view are skipped
  float o[kMaxPairs][2][4];
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) o[j][hf][0] = o[j][hf][1] = o[j][hf][2] = o[j][hf][3] = 0.f;
#pragma unroll
  for (int kp = 0; kp < kChunk / 16; ++kp) {
    if (base + kp * 16 >= top) break;
    uint32_t aph[4], apl[4];
    ldsm_x4(aph, ph + (lane & 15) * kPS + kp * 16 + (lane >> 4) * 8);
    ldsm_x4(apl, pl + (lane & 15) * kPS + kp * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      const int np = warp + kWarps * j;
      if (np * 16 < R) {
        uint32_t bv[4];
        ldsm_x4_t(bv, kv + (kp * 16 + (lane & 15)) * DS + np * 16 + (lane >> 4) * 8);
        const uint32_t b0[2] = {bv[0], bv[1]}, b1[2] = {bv[2], bv[3]};
        mma_bf16(o[j][0], aph, b0);
        mma_bf16(o[j][1], aph, b1);
        mma_bf16(o[j][0], apl, b0);
        mma_bf16(o[j][1], apl, b1);
      }
    }
  }

  // more than one chunk: park this chunk's partial, and the last chunk of
  // the row to arrive folds chunks 0 .. nc - 1
  const size_t prow = (size_t)b * a.S + i;
  float m[2] = {ms[g], ms[g + 8]}, l[2] = {ls[g], ls[g + 8]};
  const size_t stride = (size_t)a.H * (R + 2);
  if (nc > 1) {
    float* ws = a.ws + prow * a.chunks * stride;
    float* part = ws + c * stride;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= a.H) continue;
#pragma unroll
      for (int j = 0; j < kMaxPairs; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int col = (warp + kWarps * j) * 16 + hf * 8 + 2 * t;
          if (col < R)
            *reinterpret_cast<float2*>(part + row * R + col) =
                make_float2(o[j][hf][2 * r], o[j][hf][2 * r + 1]);
        }
    }
    if (threadIdx.x < a.H) {
      part[a.H * R + threadIdx.x] = ms[threadIdx.x];
      part[a.H * R + a.H + threadIdx.x] = ls[threadIdx.x];
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last_s = atomicAdd(a.cnt + prow, 1) == nc - 1;
      if (last_s) a.cnt[prow] = 0;
    }
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    // the fold, in chunk order from the empty state; unrolled so that the
    // loads of two chunks are in flight before their merges
    m[0] = m[1] = kNeg;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) o[j][hf][0] = o[j][hf][1] = o[j][hf][2] = o[j][hf][3] = 0.f;
#pragma unroll 2
    for (int cc = 0; cc < nc; ++cc) {
      const float* p = ws + cc * stride;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r;
        if (row >= a.H) continue;
        float sa, sb;
        merge_weights(m[r], __ldcg(p + a.H * R + row), &sa, &sb);
        l[r] = l[r] * sa + __ldcg(p + a.H * R + a.H + row) * sb;
#pragma unroll
        for (int j = 0; j < kMaxPairs; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int col = (warp + kWarps * j) * 16 + hf * 8 + 2 * t;
            if (col >= R) continue;
            const float2 x = __ldcg(reinterpret_cast<const float2*>(p + row * R + col));
            float* d = &o[j][hf][2 * r];
            d[0] = d[0] * sa + x.x * sb;
            d[1] = d[1] * sa + x.y * sb;
          }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= a.H) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* dst = a.out + (prow * a.H + row) * R;
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = (warp + kWarps * j) * 16 + hf * 8 + 2 * t;
        if (col < R)
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(o[j][hf][2 * r] / den, o[j][hf][2 * r + 1] / den);
      }
  }
}

int smem_bytes(int D) {
  return 2 * ((2 * kTile + kChunk) * (D + 8) + 2 * kTile * kPS) +
         4 * (kTile * kChunk + 2 * kTile);
}

int launch(const Args& a, int B, int chunk, int rows, int threads, int smem,
           int gx, int gy, int gz, cudaStream_t st) {
  static int smem_set = 48 * 1024;  // in this library
  auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int chunks = max(1, (a.Tw * a.BS + kChunk - 1) / kChunk);
  if (chunk != kChunk || kChunk % a.BS || a.R % 16 || a.RD % 16 ||
      a.R > 16 * kWarps * kMaxPairs || a.R + a.RD > kMaxDepth || a.H > kTile || rows != 1 ||
      threads != kThreads || gx != chunks ||
      gy != a.S || gz != B || smem < smem_bytes(a.R + a.RD) || !al(a.q_lat) ||
      !al(a.q_pe) || !al(a.ckv) || !al(a.kpe) ||
      (chunks > 1 && (a.ws == nullptr || a.cnt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_mla_verify_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  paged_mla_verify_tc_kernel<<<dim3(gx, gy, gz), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// body 1: the tensor-core body (bf16 pools), 0: the first body.  The
// plan's ints come from kernels/flash_attention.py mla_plan; a plan this
// library does not take returns cudaErrorInvalidValue.
extern "C" int paged_mla_verify_launch(
    const void* q_lat, const void* q_pe, const void* ckv_pool,
    const void* kpe_pool, const void* table, const void* kv_len, void* out,
    int B, int S, int H, int R, int RD, int BS, int Tw, float scale,
    int dtype, int body, int chunk, int rows, int threads, int smem, int gx,
    int gy, int gz, void* ws, void* cnt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 0 && chunk == 0)
    return first::launch(q_lat, q_pe, ckv_pool, kpe_pool, table, kv_len, out,
                         B, S, H, R, RD, BS, Tw, scale, dtype, rows, threads,
                         smem, gx, gy, gz, st);
  if (body != 1 || dtype != REPRO_DTYPE_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::Args a{static_cast<const float*>(q_lat),
                   static_cast<const float*>(q_pe),
                   static_cast<const __nv_bfloat16*>(ckv_pool),
                   static_cast<const __nv_bfloat16*>(kpe_pool),
                   static_cast<const int*>(table),
                   static_cast<const int*>(kv_len),
                   static_cast<float*>(out),
                   static_cast<float*>(ws),
                   static_cast<int*>(cnt),
                   S, H, R, RD, BS, Tw, gx, scale};
  return tc::launch(a, B, chunk, rows, threads, smem, gx, gy, gz, st);
}
