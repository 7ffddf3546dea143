// flash_attention: fused attention over [BH, S, D], the prefill-shaped
// sibling of the paged decode kernels: O[bh] = softmax(mask(cap(Q K^T *
// scale))) V with q [BH, Sq, d], k [BH, Sk, d], v [BH, Sk, dv].
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_kernel
// (_fa_body).  Its semantics are kept: scale, then the softcap
// cap*tanh(s/cap), then the mask (causal qpos >= kpos, window qpos - kpos <
// window, qpos = q_off + i); masked scores have p forced to 0, the
// online-softmax m / l / acc state is f32, and the output is acc / max(l,
// 1e-30), so a row masked everywhere gives 0.  Ragged Sq and Sk are masked
// in the kernel.
//
// Bound on the H100: at the serving prefill widths the operations (2*(d +
// dv) FLOPs per live query-key pair, bf16 tensor-core rate).
//
// bf16 with d and dv multiples of 16 (up to 256): the tensor-core body.
// One CTA of 4 warps per (bh, 64-row q tile), each warp owning 16 query
// rows; K / V tiles of 64 keys (32 when dv > 128, for the registers) land
// in shared memory through a two-stage cp.async ring, the next tile's
// copies in flight while the current one is computed.  S = Q K^T and O +=
// P V are mma.sync m16n8k16 (bf16 in, f32 accumulate) with ldmatrix
// fragments (V through its transposing form); the scores stay in
// registers, where scale, softcap and mask are applied and the online
// softmax runs across the four lanes that share a row; P becomes the A
// operand of P V in registers, rounded to bf16 once.  Key tiles outside
// the q tile's causal / window band are skipped: they are masked for every
// row, and a fully masked tile leaves m, l and acc as they are.
//
// f32, and other bf16 shapes, keep the first body: one CTA of 8 warps per
// (bh, 32-row q tile); the q tile and each 32-key K / V tile are staged in
// f32 shared memory (d, dv <= 256; above 48 KB the launcher opts in to the
// larger dynamic shared memory).  Each warp owns 4 query rows; lane j
// scores key j of the tile for its 4 rows (one K read feeds 4 FMAs), the
// row max and sum are warp shuffles, and each lane accumulates dv/32
// output columns of its 4 rows, the probabilities broadcast by shuffle.
// No block is skipped there (the reference runs fully masked blocks too).
#include "attn_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kBKv = 32;                    // keys per tile (one per lane)
constexpr int kMaxD = 256;
constexpr int kNV = kMaxD / 32;             // output columns per lane
constexpr float kNeg = -1e30f;

size_t smem_bytes(int d, int dv) {
  return sizeof(float) * ((size_t)kBQ * d + (size_t)kBKv * (d + 1) + (size_t)kBKv * dv);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int d,
             int dv, float scale, int causal, int window, float cap,
             int q_off) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [kBQ][d]
  float* ks = qs + kBQ * d;         // [kBKv][d + 1]: lane j reads row j
  float* vs = ks + kBKv * (d + 1);  // [kBKv][dv]
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;  // this warp's rows in the tile
  const T* qb = q + (size_t)bh * Sq * d;
  const T* kb = k + (size_t)bh * Sk * d;
  const T* vb = v + (size_t)bh * Sk * dv;

  for (int i = threadIdx.x; i < kBQ * d; i += blockDim.x) {
    const int r = i / d;
    qs[i] = q0 + r < Sq ? to_f32(qb[(size_t)q0 * d + i]) : 0.f;
  }
  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp][kNV];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = kNeg;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kNV; ++c) acc[r][c] = 0.f;
  }

  for (int j0 = 0; j0 < Sk; j0 += kBKv) {
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    for (int i = threadIdx.x; i < kBKv * d; i += blockDim.x) {
      const int j = i / d, c = i % d;
      ks[j * (d + 1) + c] = j0 + j < Sk ? to_f32(kb[(size_t)j0 * d + i]) : 0.f;
    }
    for (int i = threadIdx.x; i < kBKv * dv; i += blockDim.x) {
      const int j = i / dv;
      vs[i] = j0 + j < Sk ? to_f32(vb[(size_t)j0 * dv + i]) : 0.f;
    }
    __syncthreads();

    // scores of key j0 + lane against this warp's rows
    float s[kRowsPerWarp] = {};
    const float* kr = ks + lane * (d + 1);
    const float* qr = qs + r0 * d;
    for (int c = 0; c < d; ++c) {
      const float kv = kr[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(qr[r * d + c], kv, s[r]);
    }
    const int kpos = j0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float sr = s[r] * scale;
      if (cap > 0.f) sr = cap * tanhf(sr / cap);
      const int qpos = q_off + q0 + r0 + r;
      bool live = kpos < Sk;
      if (causal) live = live && qpos >= kpos;
      if (window >= 0) live = live && qpos - kpos < window;
      sr = live ? sr : kNeg;
      const float m_new = fmaxf(m_i[r], warp_max(sr));
      p[r] = live ? expf(sr - m_new) : 0.f;
      const float corr = expf(m_i[r] - m_new);
      l_i[r] = l_i[r] * corr + warp_sum(p[r]);
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < kNV; ++c) acc[r][c] *= corr;
    }
    // acc[r][:] += sum_j p[r][j] * v[j][:], lane owning columns lane + 32c
    for (int j = 0; j < kBKv; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = __shfl_sync(0xffffffffu, p[r], j);
      const float* vr = vs + j * dv;
#pragma unroll
      for (int c = 0; c < kNV; ++c) {
        const int col = lane + 32 * c;
        if (col < dv) {
          const float vv = vr[col];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(pj[r], vv, acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + r0 + r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l_i[r], 1e-30f);
    T* orow = o + ((size_t)bh * Sq + row) * dv;
#pragma unroll
    for (int c = 0; c < kNV; ++c) {
      const int col = lane + 32 * c;
      if (col < dv) orow[col] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Sk, int d, int dv, float scale, int causal, int window,
           float cap, int q_off, cudaStream_t s) {
  if (d <= 0 || dv <= 0 || d > kMaxD || dv > kMaxD || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(d, dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_kernel<T><<<grid, kWarps * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, d, dv, scale,
      causal, window, cap, q_off);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- bf16, tensor-core body

namespace tc {

using bf16 = __nv_bfloat16;
using attn::kLog2e;
using attn::ldsm_x4;
using attn::ldsm_x4_t;
using attn::pack_bf16;
using nm::mma::mma_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;  // query rows per CTA

// keys per tile: 64, or 32 when the output tile is wide (registers)
template <int DVMAX>
__host__ __device__ constexpr int kv_tile() { return DVMAX <= 128 ? 64 : 32; }

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int Sq, Sk, d, dv;
  float scale;
  int causal, window;
  float cap;
  int q_off;
};

template <int DVMAX>
int smem_bytes(int d, int dv) {
  constexpr int BKV = kv_tile<DVMAX>();
  return 2 * (kBQ * (d + 8) + 2 * BKV * (d + 8) + 2 * BKV * (dv + 8));
}

// rows [rows) of width w from src (row-major, zero past `valid` rows) into
// dst with row stride ds, 16-byte copies
__device__ __forceinline__ void stage(bf16* dst, int ds, const bf16* src,
                                      int w, int rows, int valid) {
  const int per = w / 8;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, c = i % per;
    const bool live = r < valid;
    nm::mma::cp16(dst + r * ds + c * 8, live ? src + (size_t)r * w + c * 8 : src, live);
  }
}

template <int DVMAX>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(Args a) {
  constexpr int BKV = kv_tile<DVMAX>();
  constexpr int NS = BKV / 8;     // score n-tiles
  constexpr int NO = DVMAX / 8;   // output n-tiles (dv / 8 of them live)
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, dv = a.dv, DS = d + 8, VS = dv + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kBQ][DS]
  bf16* ks = qs + kBQ * DS;                  // [2][BKV][DS]
  bf16* vs = ks + 2 * BKV * DS;              // [2][BKV][VS]
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* kb = a.k + (size_t)bh * a.Sk * d;
  const bf16* vb = a.v + (size_t)bh * a.Sk * dv;

  // the key tiles that hold a live pair for some row of this q tile
  const int qfirst = a.q_off + q0;
  const int qlast = a.q_off + min(q0 + kBQ, a.Sq) - 1;
  int lo = 0, hi = a.Sk;
  if (a.causal) hi = min(hi, qlast + 1);
  if (a.window >= 0) lo = max(lo, qfirst - a.window + 1);
  const int t0 = lo / BKV, t1 = hi > lo ? (hi + BKV - 1) / BKV : t0;

  auto load_kv = [&](int tile, int buf) {
    const int j0 = tile * BKV;
    stage(ks + buf * BKV * DS, DS, kb + (size_t)j0 * d, d, BKV, a.Sk - j0);
    stage(vs + buf * BKV * VS, VS, vb + (size_t)j0 * dv, dv, BKV, a.Sk - j0);
  };
  stage(qs, DS, a.q + ((size_t)bh * a.Sq + q0) * d, d, kBQ, a.Sq - q0);
  if (t0 < t1) load_kv(t0, 0);
  nm::mma::commit();

  float o[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  const int qpos[2] = {qfirst + warp * 16 + g, qfirst + warp * 16 + g + 8};

  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    if (tile + 1 < t1) load_kv(tile + 1, buf ^ 1);
    nm::mma::commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's BKV keys
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const bf16* kt = ks + buf * BKV * DS;
    for (int kk = 0; kk < d / 16; ++kk) {
      uint32_t aq[4];
      ldsm_x4(aq, qs + (warp * 16 + (lane & 15)) * DS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * DS + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        const uint32_t b0[2] = {bk[0], bk[1]}, b1[2] = {bk[2], bk[3]};
        mma_bf16(s[2 * np], aq, b0);
        mma_bf16(s[2 * np + 1], aq, b1);
      }
    }

    // scale, softcap, mask; the online softmax over the 4 lanes of a row
    const int j0 = tile * BKV;
    uint32_t live = 0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, kpos = j0 + nt * 8 + 2 * t + (e & 1);
        float v = s[nt][e] * a.scale;
        if (a.cap > 0.f) v = a.cap * tanhf(v / a.cap);
        bool ok = kpos < a.Sk;
        if (a.causal) ok = ok && qpos[r] >= kpos;
        if (a.window >= 0) ok = ok && qpos[r] - kpos < a.window;
        s[nt][e] = v;
        if (ok) {
          live |= 1u << (nt * 4 + e);
          mx[r] = fmaxf(mx[r], v);
        }
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
    }
    uint32_t ap[NS / 2][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = (live >> (nt * 4 + e)) & 1 ? exp2f((s[nt][e] - m[e / 2]) * kLog2e) : 0.f;
        sum[e / 2] += p[e];
      }
      ap[nt / 2][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
      ap[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      o[nt][0] *= corr[0], o[nt][1] *= corr[0];
      o[nt][2] *= corr[1], o[nt][3] *= corr[1];
    }

    // O += P V
    const bf16* vt = vs + buf * BKV * VS;
#pragma unroll
    for (int kp = 0; kp < NS / 2; ++kp) {
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        if (np * 16 < dv) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vt + (kp * 16 + (lane & 15)) * VS + np * 16 + (lane >> 4) * 8);
          const uint32_t b0[2] = {bv[0], bv[1]}, b1[2] = {bv[2], bv[3]};
          mma_bf16(o[2 * np], ap[kp], b0);
          mma_bf16(o[2 * np + 1], ap[kp], b1);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = a.o + ((size_t)bh * a.Sq + rows[r]) * dv;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
      if (nt * 8 < dv)
        *reinterpret_cast<uint32_t*>(orow + nt * 8 + 2 * t) =
            pack_bf16(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
  }
}

template <int DVMAX>
int run(const Args& a, int BH, cudaStream_t s) {
  static int smem_set = 48 * 1024;  // per instance, in this library
  const int smem = smem_bytes<DVMAX>(a.d, a.dv);
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<DVMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, BH);
  flash_tc_kernel<DVMAX><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool takes(const void* q, const void* k, const void* v, const void* o, int d, int dv) {
  auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return d % 16 == 0 && dv % 16 == 0 && d <= kMaxD && dv <= kMaxD && al(q) && al(k) &&
         al(v) && al(o);
}

int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
           int Sk, int d, int dv, float scale, int causal, int window, float cap,
           int q_off, cudaStream_t s) {
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, d, dv,
               scale, causal, window, cap, q_off};
  if (dv <= 64) return run<64>(a, BH, s);
  if (dv <= 128) return run<128>(a, BH, s);
  return run<256>(a, BH, s);
}

}  // namespace tc

}  // namespace

// window < 0: no window; cap <= 0: no softcap
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int Sq,
                                      int Sk, int d, int dv, float scale,
                                      int causal, int window, float cap,
                                      int q_off, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(q, k, v, o, BH, Sq, Sk, d, dv, scale, causal, window,
                         cap, q_off, s);
  if (dtype == REPRO_DTYPE_BF16) {
    if (BH <= 65535 && tc::takes(q, k, v, o, d, dv))
      return tc::launch(q, k, v, o, BH, Sq, Sk, d, dv, scale, causal, window,
                        cap, q_off, s);
    return launch<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, d, dv, scale, causal,
                                 window, cap, q_off, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
