// Prefill (flash) attention for Hopper: causal or not, grouped-query heads,
// optional sliding window and tanh softcap, f32 online softmax. Keys and
// values may be of their own length S_kv (cross-attention, non-causal
// only); query row i and key j sit at positions i and j.
//
// Replaces the Pallas kernel flash_attention
// (src/repro/kernels/flash_attention.py, body _flash_kernel). One block per
// (query tile, head, batch row) walks the KV tiles it can see, so the [S, S]
// score matrix never reaches device memory. Under the causal mask the walk
// stops at the tile holding the block's last query row, and a window starts
// it at the first tile the window reaches: those tiles are fully masked for
// every row, and each row sees at least its own key, so skipping them
// changes no result (the TPU kernel computes them anyway). Ragged S and
// S_kv are masked in the kernel: no divisibility requirement.
//
// What bounds it on the H100: a causal prefill of S tokens does about
// 2 S^2 Dh operations per head against 4 S Dh values moved; at S = 512,
// Dh = 64 in bf16 that is about 64 operations a byte, below the ~295 at
// which the tensor cores, not the bytes, would be the limit. Neither bound
// is near: the time goes to each KV tile's softmax on the CUDA cores between
// two small products, the barriers around them and the tile loads (PERF.md
// has the measurements). Two instances, chosen by the Python wrapper from
// dtype, shapes, strides and alignment (flash_instance):
//
// - tensor_core (bf16 IO, Dh 64, 112, 128, 160 or 192, every stride but the
//   head dimension's a multiple of 8 elements, every base 16-byte aligned):
//   one warpgroup of 128 threads owns a 64-row query tile. S = Q K^T
//   runs as wgmma.mma_async m64n64k16 with Q and K read from shared memory
//   (K-major), f32 accumulators in registers. The mask and the online
//   softmax stay in registers (row max and sum by quad shuffles over the
//   accumulator fragment), in base 2, and tiles that every row sees whole
//   skip the per-element mask. P V runs as a second wgmma whose A operand
//   is the first product's accumulator fragment converted pairwise to
//   bf16x2 in registers; V is the B operand in its own Dh-contiguous
//   (MN-major) layout, read through the instruction's transpose bit. K/V
//   tiles arrive by 16-byte cp.async in a two-stage ring, kept in bf16
//   under the 128-byte swizzle that the wgmma descriptors name, so the copy
//   of a tile overlaps the products of the one before. A head dimension
//   that is not a multiple of 64 pads each tile's rows to whole column
//   blocks (DP: 112 -> 128, 160 -> 192): Q K^T runs over the Dh / 16
//   k-steps that hold data, P V over N = DP against V's pad zeroed once,
//   and only the columns below Dh are stored. At DP 192 a two-stage ring
//   would leave shared memory for one block an SM; Dh 112, 160 and 192
//   hold one K/V stage, which fits three (registers: two), and copy K and V
//   apart so that a block's copies still overlap its products (Plan;
//   flash_plan in the wrapper).
//   Precision: P is rounded to bf16 before the second product, as SDPA
//   does; the Pallas kernel multiplies P by V in f32. The row sums l keep
//   the f32 P. Q K^T in bf16 with f32 accumulation is exact per product.
// - cuda_core (f32 IO, any other Dh, or unaligned strides or bases): the
//   products on the f32 CUDA cores from K/V tiles staged in shared memory
//   as f32. TF32 tensor cores keep about 10 bits of mantissa and would miss
//   the f32 tolerance of 2e-4.
#include <type_traits>

#include "wgmma.cuh"

namespace cuda_core {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;

template <typename T, bool VEC>
__global__ void flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out,
                             int H, int KV, int S, int Skv, int Dh,
                             long long q_sb, long long q_sh, long long q_ss,
                             long long k_sb, long long k_sh, long long k_ss,
                             long long v_sb, long long v_sh, long long v_ss,
                             float scale, int causal, int window, float softcap) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = THREADS / 32;
  float* qs = smem;                     // [BQ][Dh]
  float* ks = qs + BQ * Dh;             // [BK][Dh + 1] (padded: no bank conflicts)
  float* vs = ks + BK * (Dh + 1);       // [BK][Dh]
  float* ps = vs + BK * Dh;             // [BQ][BK] logits, then probabilities
  float* acc = ps + BQ * BK;            // [BQ][Dh]
  float* m = acc + BQ * Dh;             // [BQ]
  float* l = m + BQ;                    // [BQ]
  float* corr = l + BQ;                 // [BQ]

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  for (int i = tid; i < BQ * Dh; i += THREADS) {
    const int r = i / Dh, d = i % Dh, qi = q0 + r;
    qs[i] = qi < S ? to_f32(qb[qi * q_ss + d]) : 0.f;
    acc[i] = 0.f;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    m[i] = MASKED;
    l[i] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed; init visible
    load_kv_tile<T, VEC, THREADS>(ks, vs, kb, vb, k_ss, v_ss, k0, BK, Skv, Dh);
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += THREADS) {
      const int r = i / BK, j = i % BK, qi = q0 + r, kj = k0 + j;
      float s = -INFINITY;
      if (kj < Skv) {
        const float dot = dot_f32(qs + r * Dh, ks + j * (Dh + 1), Dh, 1);
        bool ok = !causal || kj <= qi;
        if (window > 0) ok = ok && (qi - kj < window);
        s = attn_logit(dot, scale, softcap, ok);
      }
      ps[i] = s;
    }
    __syncthreads();
    for (int r = warp; r < BQ; r += nwarps) {
      float* row = ps + r * BK;
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        l[r] = l[r] * c + sum;
        m[r] = m_new;
        corr[r] = c;
      }
    }
    __syncthreads();
    for (int i = tid; i < BQ * Dh; i += THREADS) {
      const int r = i / Dh, d = i % Dh;
      const float* pr = ps + r * BK;
      acc[i] = acc[i] * corr[r] + dot_f32(pr, vs + d, BK, Dh);
    }
  }
  __syncthreads();
  T* ob = out + ((long long)b * H + h) * S * Dh;
  for (int i = tid; i < BQ * Dh; i += THREADS) {
    const int r = i / Dh, d = i % Dh, qi = q0 + r;
    if (qi < S) ob[(long long)qi * Dh + d] = from_f32<T>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

template <typename T, bool VEC>
static int launch_as(const void* q, const void* k, const void* v, void* out, int B, int H,
                     int KV, int S, int Skv, int Dh, const long long* st, float scale,
                     int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)BQ * Dh + BK * (Dh + 1) + BK * Dh + BQ * BK + BQ * Dh + 3 * BQ);
  cudaError_t err = allow_smem(flash_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, VEC><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, KV, S, Skv, Dh, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                  int KV, int S, int Skv, int Dh, const long long* st, float scale,
                  int causal, int window, float softcap, cudaStream_t stream) {
  // K/V strides only (st[3..8]): q is read scalar
  if (vec_ok<T>(Dh, k, v, st + 3, 6))
    return launch_as<T, true>(q, k, v, out, B, H, KV, S, Skv, Dh, st, scale, causal,
                              window, softcap, stream);
  return launch_as<T, false>(q, k, v, out, B, H, KV, S, Skv, Dh, st, scale, causal,
                             window, softcap, stream);
}

}  // namespace cuda_core

namespace tensor_core {

constexpr int BQ = 64;        // query rows per block: one warpgroup's m64 tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 128;  // one warpgroup
constexpr int SMEM_PER_SM = 233472;  // shared memory an H100 SM holds (228 KB)
constexpr int SMEM_RESERVED = 1024;  // the runtime's share of each resident block

using namespace wg;

// The shared memory of a launch at head dimension DH: a tile's rows padded
// to DP, whole 64-element column blocks of the swizzle (112 -> 128,
// 160 -> 192); 1024 bytes for the base's alignment, the Q tile, then STAGES
// (K, V) pairs: two at DH 64 and 128, one at 112, 160 and 192 (measured
// faster there, PERF.md). flash_plan (kernels/flash_attention.py) computes
// the same.
template <int DH>
struct Plan {
  static_assert(DH % 16 == 0 && DH <= 192, "no such plan");
  static constexpr int STAGES = DH == 64 || DH == 128 ? 2 : 1;
  static constexpr int DP = (DH + 63) / 64 * 64;
  static constexpr int TILE = DP / 64 * COL_BLOCK;   // bytes of one [64, DP] tile
  static constexpr int SMEM = 1024 + TILE * (1 + 2 * STAGES);
  static constexpr int BLOCKS = SMEM_PER_SM / (SMEM + SMEM_RESERVED);   // an SM
};

constexpr float LOG2E = 1.4426950408889634f;

// The softmax runs in base 2 (exp2 is one instruction): logits times
// log2(e). Masked logits stay exactly MASKED, the running max's start, so a
// row that sees no key still weighs every key alike.
__device__ __forceinline__ float logit2(float dot, int qi, int kj, int Skv, float scale,
                                        int causal, int window, float softcap) {
  if (kj >= Skv) return -INFINITY;
  bool ok = !causal || kj <= qi;
  if (window > 0) ok = ok && (qi - kj < window);
  return ok ? attn_logit(dot, scale, softcap, true) * LOG2E : MASKED;
}

// The accumulator fragment's layout (wgmma.cuh) makes P's rows for keys
// 16j .. 16j + 15 the A fragment of P V's k-step j. Past DH the O
// accumulator's columns (DP > DH) read only V's pad, zeroed once, and are
// never stored. Plan<DH>::STAGES 2 copies tile t + 1 into the other stage
// during the products of tile t. STAGES 1 holds one K and one V tile and
// copies them apart: K of tile t + 1 once Q K^T of tile t is done (during
// its softmax and P V), V of tile t + 1 once P V is done (during the next
// Q K^T); it leaves shared memory for more resident blocks.
template <int DH>
__global__ void __launch_bounds__(THREADS)
    flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int H, int KV,
                       int S, int Skv, long long q_sb, long long q_sh, long long q_ss,
                       long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                       long long v_sh, long long v_ss, float scale, int causal, int window,
                       float softcap) {
  constexpr int STAGES = Plan<DH>::STAGES, DP = Plan<DH>::DP, TILE = Plan<DH>::TILE;
  constexpr int NO = DP / 2;          // O accumulator floats per thread
  extern __shared__ unsigned char tc_smem[];
  const uint32_t base = (smem_u32(tc_smem) + 1023u) & ~1023u;
  const uint32_t qs = base;           // Q tile, then per stage K and V tiles
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  load_tile<DH>(qs, qb, q_ss, q0, S);
  load_tile<DH>(base + TILE, kb, k_ss, k_begin, Skv);
  if constexpr (STAGES == 1) cp_async_commit();   // Q and K, then V apart
  load_tile<DH>(base + 2 * TILE, vb, v_ss, k_begin, Skv);
  cp_async_commit();
  if constexpr (DP > DH) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) zero_pad<DH, DP>(base + TILE * (2 + 2 * st));
  }

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  const float scale2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    const uint32_t ks = base + TILE * (1 + 2 * (STAGES == 2 ? t & 1 : 0)), vs = ks + TILE;
    if constexpr (STAGES == 2) {
      if (t + 1 < n_tiles) {   // the next tile into the other stage
        const uint32_t kn = base + TILE * (1 + 2 * ((t + 1) & 1));
        load_tile<DH>(kn, kb, k_ss, k0 + BK, Skv);
        load_tile<DH>(kn + TILE, vb, v_ss, k0 + BK, Skv);
      }
      cp_async_commit();
    }
    // all but the newest group landed: STAGES 2 tile t (t + 1 in flight);
    // STAGES 1 K of tile t (its V in flight)
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk >> 2) * COL_BLOCK + (kk & 3) * 32;
      wgmma_ss_n64(s, desc(qs + off, 16, 1024), desc(ks + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    if constexpr (STAGES == 1) {
      __syncthreads();       // every warp is done with K of tile t
      if (t + 1 < n_tiles) load_tile<DH>(ks, kb, k_ss, k0 + BK, Skv);
      cp_async_commit();     // K of tile t + 1 (an empty group after the last)
    }

    // a tile that every row of the block sees whole needs no per-element mask
    const bool whole = k0 + BK <= Skv && (!causal || k0 + BK - 1 <= q0) &&
                       (window <= 0 || q0 + BQ - 1 - k0 < window) && softcap <= 0.f;
    if (whole) {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] *= scale2;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + cq + e;
          s[4 * j + e] = logit2(s[4 * j + e], r0, kj, Skv, scale, causal, window, softcap);
          s[4 * j + 2 + e] =
              logit2(s[4 * j + 2 + e], r1, kj, Skv, scale, causal, window, softcap);
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {   // the 4 threads of a quad share a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(s[4 * j + e] - mn0);
        s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - mn1);
        sum0 += s[4 * j + e];
        sum1 += s[4 * j + 2 + e];
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o_);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o_);
    }
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] *= c0;
      o[4 * j + 1] *= c0;
      o[4 * j + 2] *= c1;
      o[4 * j + 3] *= c1;
    }

    uint32_t pa[16];   // P in bf16, the A fragments of the four k-steps
#pragma unroll
    for (int j = 0; j < 16; ++j) pa[j] = pack_bf16x2(s[2 * j], s[2 * j + 1]);
    if constexpr (STAGES == 1) {
      cp_async_wait<1>();    // V of tile t; K of tile t + 1 may be in flight
      fence_proxy_async();
      __syncthreads();
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)   // keys 16j .. 16j + 15: 16 rows of V
      wgmma_rs(o, pa + 4 * j, desc(vs + j * 16 * 128, COL_BLOCK, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    __syncthreads();   // this stage is free for the copy of tile t + STAGES
    if constexpr (STAGES == 1) {
      if (t + 1 < n_tiles) load_tile<DH>(vs, vb, v_ss, k0 + BK, Skv);
      cp_async_commit();     // V of tile t + 1 (an empty group after the last)
    }
  }

  bf16* ob = out + ((long long)b * H + h) * S * DH;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {   // columns below DH only
    const int c = 8 * j + cq;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * DH + c) =
          __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * DH + c) =
          __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

template <int DH>
static int launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                  int KV, int S, int Skv, const long long* st, float scale, int causal,
                  int window, float softcap, cudaStream_t stream) {
  constexpr int smem = Plan<DH>::SMEM;
  cudaError_t err = allow_smem(flash_wgmma_kernel<DH>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_wgmma_kernel<DH><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, H, KV, S, Skv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal, window,
      softcap);
  return (int)cudaGetLastError();
}

// out[0 .. 7]: DP, tile bytes, stages, shared bytes, blocks an SM by shared
// memory (Plan), blocks an SM by the runtime's occupancy query (registers
// too), registers a thread, local (spilled) bytes a thread.
template <int DH>
static int plan(int* out) {
  using P = Plan<DH>;
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err = allow_smem(flash_wgmma_kernel<DH>, P::SMEM);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, flash_wgmma_kernel<DH>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_wgmma_kernel<DH>, THREADS, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int vals[8] = {P::DP, P::TILE, P::STAGES, P::SMEM, P::BLOCKS, blocks, a.numRegs,
                       (int)a.localSizeBytes};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

template <int N> using I = std::integral_constant<int, N>;

// f(I<DH>) at each head dimension the instance is built for;
// cudaErrorInvalidValue at any other.
template <typename F>
static int dispatch(int Dh, F f) {
  switch (Dh) {
    case 64: return f(I<64>());
    case 112: return f(I<112>());
    case 128: return f(I<128>());
    case 160: return f(I<160>());
    case 192: return f(I<192>());
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tensor_core

// The CUDA-core instance. strides (in elements): q_sb, q_sh, q_ss, k_sb,
// k_sh, k_ss, v_sb, v_sh, v_ss; the head dimension is contiguous in q, k
// and v; out is contiguous [B, H, S, Dh]. K and V hold S_kv rows, which
// must be S when causal.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int B, int H, int KV, int S, int Skv,
                                     int Dh, const long long* strides, float scale,
                                     int causal, int window, float softcap, int dtype,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (KV <= 0 || H % KV != 0 || (causal && Skv != S)) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return cuda_core::launch<float>(q, k, v, out, B, H, KV, S, Skv, Dh, strides, scale,
                                    causal, window, softcap, s);
  if (dtype == DT_BF16)
    return cuda_core::launch<__nv_bfloat16>(q, k, v, out, B, H, KV, S, Skv, Dh, strides,
                                            scale, causal, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core instance: bf16 only, Dh 64, 112, 128, 160 or 192, every
// stride a multiple of 8 elements and every base 16-byte aligned (the wrapper's flash_instance
// checks the same before it calls this entry).
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                           void* out, int B, int H, int KV, int S, int Skv,
                                           int Dh, const long long* strides, float scale,
                                           int causal, int window, float softcap,
                                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (KV <= 0 || H % KV != 0 || (causal && Skv != S)) return (int)cudaErrorInvalidValue;
  if ((size_t)q % 16 || !vec_ok<__nv_bfloat16>(Dh, k, v, strides, 9))
    return (int)cudaErrorInvalidValue;
  return tensor_core::dispatch(Dh, [&](auto dh) {
    return tensor_core::launch<decltype(dh)::value>(
        q, k, v, out, B, H, KV, S, Skv, strides, scale, causal, window, softcap, s);
  });
}

// The plan of the tensor-core instance at Dh, as tensor_core::plan lays it
// out in out[0 .. 7].
extern "C" int repro_flash_wgmma_plan(int Dh, int* out) {
  return tensor_core::dispatch(Dh, [&](auto dh) {
    return tensor_core::plan<decltype(dh)::value>(out);
  });
}
