// Mamba2 SSD chunked scan for Hopper.
//
// Replaces the Pallas kernel `ssd` (src/repro/kernels/ssd_scan.py, body
// _ssd_kernel). Per chunk of Q tokens:
//
//   cum     = prefix sum of dt * (-exp(a_log))                  (one warp scan)
//   y[i]    = exp(cum_i) (C_i . state)                           (y_inter)
//           + sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j  (y_intra)
//   state  <- state exp(cum_Q) + sum_j x_j (B_j exp(cum_Q - cum_j) dt_j)^T
//
// The Q x Q decay matrix (256 KB in f32 at Q 256) does not fit in shared
// memory, so both instances take query rows in tiles of 64 against key
// tiles of 64 at or below the diagonal (causal: tiles above it are
// skipped). B and C are read for group g = h / (H / G), with no copy per
// head. y is written in x's type; the state and all sums are f32.
//
// What bounds it on the H100: at the mamba2-2.7b prefill shapes (B 4, L 512,
// H 80, P 64, N 128, Q 256) the call moves about 65 MB (x, y, B, C, the f32
// initial and final states) and does about 14 GFLOP of products: 19 us of
// bytes against 14 us of bf16 tensor-core work, so bytes bound it once the
// products run on the tensor cores. Two instances, chosen by the Python
// wrapper (kernels/ssd_scan.py, ssd_instance):
//
// - tensor_core (bf16, P 64, N 64 or 128, Q a multiple of 64): every
//   product on wgmma with f32 accumulators, and the work split so that the
//   card fills. The chunks depend on each other only through the [P, N]
//   state, so ssd_states_kernel walks the chunks of one (batch row, head)
//   with the state in its accumulators (320 blocks of one warpgroup at the
//   prefill shapes, four resident per SM) and hands the state entering each
//   chunk to ssd_out_kernel, which computes every (query tile, chunk, batch
//   row x head) in parallel (2,560 blocks). C B^T is flash attention's
//   Q K^T at depth N, the decay mask takes the softmax's place, and W X is
//   P V at width P. Precision: bf16 operands, f32 sums. C B^T is rounded
//   to bf16 as the plain version's C.B is; the three f32 operands (W, the
//   scaled X of the state update, the state that C meets) each go in as a
//   bf16 high part plus a bf16 residual, two products, which keeps about
//   16 bits of them, where one bf16 rounding of W differs from the plain
//   version's rounding of C.B by up to a bf16 step of a product near 5 and
//   puts outputs near zero past the 3e-2 tolerance at the prefill shapes.
//   The carried and returned states stay f32.
// - cuda_core (f32, and shapes the tiles do not cover: P not 64, N not 64
//   or 128, Q not a multiple of 64): one block per (batch row, head) walks
//   the chunks in order, the TPU grid's sequential chunk axis as the loop,
//   with the running f32 state in shared memory and the products on the f32
//   CUDA cores from shared memory (4x4 register tiles per thread), 320
//   blocks of 134 KB of shared memory at the prefill shapes, one per SM:
//   bound by those products.
#include "wgmma.cuh"

namespace {

// cum[i] = sum over k <= i of dt_k * neg_a in a chunk of Q tokens, by one
// warp (threads 0..31): each lane sums a run, then a warp scan. Every
// instance calls this one function, so its kernels agree on cum bit for bit.
__device__ __forceinline__ void chunk_cum(const float* dts, float* cum, int Q, float neg_a) {
  const int lane = threadIdx.x & 31;
  const int per = (Q + 31) / 32, lo = lane * per, hi = min(lo + per, Q);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += __fmul_rn(dts[i], neg_a);        // da = dt * a rounded, then summed
    cum[i] = run;
  }
  float incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const float before = incl - run;
  for (int i = lo; i < hi; ++i) cum[i] += before;
}


namespace cuda_core {

constexpr int THREADS = 256;
constexpr int TQ = 64;     // query rows per tile (== key rows per tile)
constexpr int PMAX = 64;   // head dim the register tiles cover
constexpr int NMAX = 128;  // state dim the state-update tiles cover

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ b,
           const T* __restrict__ c, const float* __restrict__ s0, T* __restrict__ y,
           float* __restrict__ sf, int L, int H, int P, int G, int N, int Q) {
  extern __shared__ float smem[];
  const int NP = N + 1;                      // padded rows: conflict-free columns
  float* st = smem;                          // [P][NP]   running state
  float* cs = st + P * NP;                   // [TQ][NP]  C tile
  float* bs = cs + TQ * NP;                  // [TQ][NP]  B tile
  float* xs = bs + TQ * NP;                  // [TQ][PMAX] x tile
  float* ss = xs + TQ * PMAX;                // [TQ][TQ+1] weighted scores
  float* cum = ss + TQ * (TQ + 1);           // [Q]
  float* dts = cum + Q;                      // [Q]

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const float neg_a = -expf(a_log[h]);
  const size_t st_base = (size_t)blockIdx.x * P * N;
  // row r of a chunk starting at token l0 in x/y, dt, and b/c
  auto x_row = [&](int l) { return ((size_t)(bi * L + l) * H + h) * P; };
  auto bc_row = [&](int l) { return ((size_t)(bi * L + l) * G + g) * N; };

  for (int i = tid; i < P * N; i += THREADS)
    st[(i / N) * NP + i % N] = s0 != nullptr ? s0[st_base + i] : 0.f;

  // tile loaders: rows past the chunk read as zero
  auto load_bc = [&](float* dst, const T* src, int l0, int r0) {
    for (int i = tid; i < TQ * N; i += THREADS) {
      const int r = i / N, n = i % N;
      dst[r * NP + n] = (r0 + r < Q) ? to_f32(src[bc_row(l0 + r0 + r) + n]) : 0.f;
    }
  };
  auto load_x = [&](int l0, int r0) {
    for (int i = tid; i < TQ * PMAX; i += THREADS) {
      const int r = i / PMAX, p = i % PMAX;
      xs[i] = (r0 + r < Q && p < P) ? to_f32(x[x_row(l0 + r0 + r) + p]) : 0.f;
    }
  };

  const int ti = tid / 16, tj = tid % 16;    // 16 x 16 threads, 4 x 4 tiles each
  for (int l0 = 0; l0 < L; l0 += Q) {
    __syncthreads();                         // last chunk's state is written
    for (int i = tid; i < Q; i += THREADS) dts[i] = dt[(size_t)(bi * L + l0 + i) * H + h];
    __syncthreads();
    if (tid < 32) chunk_cum(dts, cum, Q, neg_a);
    __syncthreads();
    const float cum_last = cum[Q - 1];

    for (int q0 = 0; q0 < Q; q0 += TQ) {
      load_bc(cs, c, l0, q0);
      __syncthreads();
      float acc[4][4];
      // y_inter: exp(cum_i) * (C_i . state_p)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(ti + 16 * a) * NP + n];
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[e] = (tj + 16 * e < P) ? st[(tj + 16 * e) * NP + n] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(cv[a], sv[e], acc[a][e]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int qi = q0 + ti + 16 * a;
        const float d = qi < Q ? expf(cum[qi]) : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] *= d;
      }
      // y_intra over the key tiles at or below the diagonal
      for (int k0 = 0; k0 <= q0; k0 += TQ) {
        __syncthreads();                     // bs/xs/ss are free
        load_bc(bs, b, l0, k0);
        load_x(l0, k0);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[a][e] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = cs[(ti + 16 * a) * NP + n];
#pragma unroll
          for (int e = 0; e < 4; ++e) bv[e] = bs[(tj + 16 * e) * NP + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[a][e] = fmaf(cv[a], bv[e], sc[a][e]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int qi = q0 + ti + 16 * a;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + tj + 16 * e;
            const bool ok = kj <= qi && qi < Q;   // kj <= qi < Q: kj is in the chunk
            ss[(ti + 16 * a) * (TQ + 1) + tj + 16 * e] =
                ok ? sc[a][e] * expf(cum[qi] - cum[kj]) * dts[kj] : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < TQ; ++j) {
          float wv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) wv[a] = ss[(ti + 16 * a) * (TQ + 1) + j];
#pragma unroll
          for (int e = 0; e < 4; ++e) xv[e] = xs[j * PMAX + tj + 16 * e];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(wv[a], xv[e], acc[a][e]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int qi = q0 + ti + 16 * a;
        if (qi >= Q) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = tj + 16 * e;
          if (p < P) y[x_row(l0 + qi) + p] = from_f32<T>(acc[a][e]);
        }
      }
      __syncthreads();                       // cs is reloaded by the next tile
    }

    // state <- state * exp(cum_last) + sum_j (x_j w_j) B_j^T, w_j = exp(cum_last - cum_j) dt_j;
    // thread (ti, tj) owns p = ti + 16a (a < 4), n = tj + 16e (e < 8)
    float sacc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) sacc[a][e] = 0.f;
    for (int k0 = 0; k0 < Q; k0 += TQ) {
      __syncthreads();
      load_bc(bs, b, l0, k0);
      load_x(l0, k0);
      __syncthreads();
      const int rows = min(TQ, Q - k0);
      for (int j = 0; j < rows; ++j) {
        const float w = expf(cum_last - cum[k0 + j]) * dts[k0 + j];
        float xv[4], bv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = xs[j * PMAX + ti + 16 * a] * w;
#pragma unroll
        for (int e = 0; e < 8; ++e) bv[e] = (tj + 16 * e < N) ? bs[j * NP + tj + 16 * e] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 8; ++e) sacc[a][e] = fmaf(xv[a], bv[e], sacc[a][e]);
      }
    }
    const float dec = expf(cum_last);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int p = ti + 16 * a;
      if (p >= P) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int n = tj + 16 * e;
        if (n < N) st[p * NP + n] = st[p * NP + n] * dec + sacc[a][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS) sf[st_base + i] = st[(i / N) * NP + i % N];
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log, const void* b, const void* c,
           const void* s0, void* y, void* sf, int B, int L, int H, int P, int G, int N,
           int Q, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(P + 2 * TQ) * (N + 1) + TQ * PMAX +
                                       TQ * (TQ + 1) + 2 * (size_t)Q);
  auto kernel = ssd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, THREADS, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a_log, (const T*)b, (const T*)c,
      (const float*)s0, (T*)y, (float*)sf, L, H, P, G, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace cuda_core

// The tensor-core instance: bf16, P 64, N 64 or 128, Q a multiple of 64.
// Two kernels. ssd_states_kernel: one warpgroup per (batch row, head)
// walks the chunks with the [P, N] state in its wgmma accumulators (f32),
// adding each chunk's (X w)^T B on the tensor cores; it writes the final
// state, and the state entering each chunk as a bf16 high part and
// residual, ready to be copied as wgmma tiles. ssd_out_kernel: one
// warpgroup per (64-row query tile, chunk, batch row x head), every tile
// in parallel, computes y_inter from the entering state and y_intra from
// the key tiles at or below the diagonal.
namespace tensor_core {

using namespace wg;

constexpr int P = 64;                   // head dim: one 64-column block
constexpr int THREADS = WG_THREADS;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// dt of one chunk for head h (rows row0 .. row0 + Q - 1 of [B L, H]) into
// dts, and its prefix sum into cum; ends with the block in step.
__device__ __forceinline__ void load_chunk(const float* dt, float* dts, float* cum,
                                           size_t row0, int H, int h, int Q, float neg_a) {
  for (int i = threadIdx.x; i < Q; i += THREADS) dts[i] = dt[(row0 + i) * H + h];
  __syncthreads();
  if (threadIdx.x < 32) chunk_cum(dts, cum, Q, neg_a);
  __syncthreads();
}

// A [64, NC] f32 accumulator fragment (wgmma.cuh) from or to a row-major
// f32 array of row stride ld.
template <int NC>
__device__ __forceinline__ void frag_load(float (&d)[NC / 2], const float* src, int ld) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 a = src != nullptr ? *reinterpret_cast<const float2*>(src + r0 * ld + col)
                                    : make_float2(0.f, 0.f);
    const float2 b = src != nullptr
                         ? *reinterpret_cast<const float2*>(src + (r0 + 8) * ld + col)
                         : make_float2(0.f, 0.f);
    d[4 * j] = a.x; d[4 * j + 1] = a.y; d[4 * j + 2] = b.x; d[4 * j + 3] = b.y;
  }
}
template <int NC>
__device__ __forceinline__ void frag_store(const float (&d)[NC / 2], float* dst, int ld) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<float2*>(dst + r0 * ld + col) = make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(dst + (r0 + 8) * ld + col) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

// The [64, NC] f32 fragment as two row-major [64, NC] bf16 arrays, its
// high part at dst and the residual f32 - high at dst + 64 NC, staged
// through `stage` (shared, 2 x 64 x NC bf16, each row's 16-byte words
// XOR-swizzled by the row against bank conflicts) so that the block writes
// whole 16-byte words. Ends with the block in step.
template <int NC>
__device__ __forceinline__ void frag_store_split(const float (&d)[NC / 2], bf16* stage,
                                                 bf16* __restrict__ dst) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a = d[4 * j + 2 * h], b = d[4 * j + 2 * h + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(hi);
      const int r = r0 + 8 * h, off = r * NC + ((j ^ (r & 7)) * 8 | (col & 7));
      *reinterpret_cast<__nv_bfloat162*>(stage + off) = hi;
      *reinterpret_cast<__nv_bfloat162*>(stage + TILE_ROWS * NC + off) =
          __floats2bfloat162_rn(a - hf.x, b - hf.y);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * TILE_ROWS * NC / 8; i += THREADS) {
    const int r = i / (NC / 8), j = i % (NC / 8);   // r < 128: hi rows, then lo
    *reinterpret_cast<uint4*>(dst + (size_t)r * NC + j * 8) =
        *reinterpret_cast<const uint4*>(stage + r * NC + (j ^ (r & 7)) * 8);
  }
  __syncthreads();
}

// state <- state exp(cum_Q) + (X o w)^T B per chunk, w_j = exp(cum_Q - cum_j) dt_j.
// X's rows are scaled by w in shared memory, in f32, and split into a bf16
// high part and a bf16 residual (two products); the state never leaves f32.
// The state entering each chunk (the first too, when there is an initial
// state) goes to `states` split the same way, [B H, nc, 2, P, N] bf16,
// where ssd_out_kernel copies it as two tiles.
template <int N>
__global__ void __launch_bounds__(THREADS)
ssd_states_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a_log, const bf16* __restrict__ b,
                  const float* __restrict__ s0, bf16* __restrict__ states,
                  float* __restrict__ sf, int L, int H, int G, int Q) {
  constexpr int XT = TILE_ROWS * P * 2, STAGE = 2 * XT + TILE_ROWS * N * 2;
  static_assert(2 * TILE_ROWS * N * 2 <= STAGE, "a stage holds the split state");
  extern __shared__ unsigned char ssd_smem[];
  const uint32_t base = (smem_u32(ssd_smem) + 1023u) & ~1023u;
  unsigned char* gbase = ssd_smem + (base - smem_u32(ssd_smem));
  float* dts = reinterpret_cast<float*>(gbase + 2 * STAGE);   // stage: X hi, X lo, B
  float* cum = dts + Q;
  const int bh = blockIdx.x, bi = bh / H, h = bh % H, g = h / (H / G);
  const float neg_a = -expf(a_log[h]);
  const int nc = L / Q, n_kt = Q / TILE_ROWS;
  const long long x_ss = (long long)H * P, b_ss = (long long)G * N;

  float d[N / 2];
  frag_load<N>(d, s0 != nullptr ? s0 + (size_t)bh * P * N : nullptr, N);
  for (int c = 0; c < nc; ++c) {
    const size_t row0 = (size_t)bi * L + (size_t)c * Q;
    const bf16* xb = x + (row0 * H + h) * P;
    const bf16* bb = b + (row0 * G + g) * N;
    load_tile<P>(base, xb, x_ss, 0, Q);
    load_tile<N>(base + 2 * XT, bb, b_ss, 0, Q);
    cp_async_commit();
    load_chunk(dt, dts, cum, row0, H, h, Q, neg_a);
    if (c > 0 || s0 != nullptr)        // staged in stage 1, free until tile 1
      frag_store_split<N>(d, reinterpret_cast<bf16*>(gbase + STAGE),
                          states + ((size_t)bh * nc + c) * 2 * P * N);
    const float cum_last = cum[Q - 1], dec = expf(cum_last);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] *= dec;
    for (int t = 0; t < n_kt; ++t) {
      const uint32_t xs = base + STAGE * (t & 1), xl = xs + XT, bs = xl + XT;
      if (t + 1 < n_kt) {                // the next tile into the other stage
        const uint32_t nx = base + STAGE * ((t + 1) & 1);
        load_tile<P>(nx, xb, x_ss, (t + 1) * TILE_ROWS, Q);
        load_tile<N>(nx + 2 * XT, bb, b_ss, (t + 1) * TILE_ROWS, Q);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      for (int i = threadIdx.x; i < TILE_ROWS * (P / 8); i += THREADS) {
        const int r = i / (P / 8), j = t * TILE_ROWS + r;
        const float w = expf(cum_last - cum[j]) * dts[j];
        const uint32_t off = swizzled(r, i % (P / 8));
        uint4* qh = reinterpret_cast<uint4*>(gbase + (xs - base) + off);
        uint4* ql = reinterpret_cast<uint4*>(gbase + (xl - base) + off);
        uint4 u = *qh, lo;
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
        __nv_bfloat162* el = reinterpret_cast<__nv_bfloat162*>(&lo);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(e[k]);
          const float a = f.x * w, b2 = f.y * w;
          e[k] = __floats2bfloat162_rn(a, b2);
          const float2 hf = __bfloat1622float2(e[k]);
          el[k] = __floats2bfloat162_rn(a - hf.x, b2 - hf.y);
        }
        *qh = u;
        *ql = lo;
      }
      fence_proxy_async();
      __syncthreads();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE_ROWS / 16; ++kk) {
        const uint64_t db = desc(bs + kk * 16 * 128, COL_BLOCK, 1024);
        wgmma_ss_tt(d, desc(xs + kk * 16 * 128, COL_BLOCK, 1024), db);
        wgmma_ss_tt(d, desc(xl + kk * 16 * 128, COL_BLOCK, 1024), db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(d);
      __syncthreads();                   // this stage is free for tile t + 2
    }
  }
  frag_store<N>(d, sf + (size_t)bh * P * N, N);
}

// y for one 64-row query tile of one chunk: exp(cum_i) C_i . state (the
// state split into a bf16 high part and a bf16 residual, two products),
// then, per key tile at or below the diagonal, S = C B^T on wgmma, rounded
// to bf16 as the plain version's C.B is, W = S exp(cum_i - cum_j) dt_j in
// f32 masked to j <= i in registers, and W X as two products whose A
// operands are W's bf16 high part and residual (X read MN-major through
// the transpose bit).
template <int N>
__global__ void __launch_bounds__(THREADS, 3)   // three blocks an SM
ssd_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const bf16* __restrict__ b,
               const bf16* __restrict__ c, const float* __restrict__ s0,
               const bf16* __restrict__ states, bf16* __restrict__ y, int L, int H, int G,
               int Q) {
  constexpr int CT = TILE_ROWS * N * 2, XT = TILE_ROWS * P * 2, STAGE = CT + XT;
  static_assert(2 * CT >= STAGE, "the second key stage fits where the state was");
  extern __shared__ unsigned char ssd_smem[];
  const uint32_t base = (smem_u32(ssd_smem) + 1023u) & ~1023u;
  unsigned char* gbase = ssd_smem + (base - smem_u32(ssd_smem));
  // C | state hi | state lo | key stage 0; key stage 1 reuses the state's
  // room once C . state is done, so that three blocks fit on an SM
  const uint32_t cs = base, hs = base + CT, ls = hs + CT, stage0 = ls + CT;
  float* dts = reinterpret_cast<float*>(gbase + 3 * CT + STAGE);
  float* cum = dts + Q;
  const int tq = blockIdx.x, ci = blockIdx.y, bh = blockIdx.z;
  const int bi = bh / H, h = bh % H, g = h / (H / G);
  const int q0 = tq * TILE_ROWS, nc = L / Q;
  const float neg_a = -expf(a_log[h]);
  const long long x_ss = (long long)H * P, b_ss = (long long)G * N;
  const size_t row0 = (size_t)bi * L + (size_t)ci * Q;
  const bf16* xb = x + (row0 * H + h) * P;
  const bf16* bb = b + (row0 * G + g) * N;
  const bf16* cb = c + (row0 * G + g) * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;   // chunk rows
  const int cq = 2 * (lane & 3);
  const bool has_state = ci > 0 || s0 != nullptr;

  load_tile<N>(cs, cb, b_ss, q0, Q);
  if (has_state) {
    const bf16* st = states + ((size_t)bh * nc + ci) * 2 * P * N;
    load_tile<N>(hs, st, N, 0, P);
    load_tile<N>(ls, st + P * N, N, 0, P);
  }
  load_tile<N>(stage0, bb, b_ss, 0, Q);
  load_tile<P>(stage0 + CT, xb, x_ss, 0, Q);
  cp_async_commit();
  load_chunk(dt, dts, cum, row0, H, h, Q, neg_a);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  if (has_state) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk >> 2) * COL_BLOCK + (kk & 3) * 32;
      wgmma_ss_n64(o, desc(cs + off, 16, 1024), desc(hs + off, 16, 1024));
    }
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk >> 2) * COL_BLOCK + (kk & 3) * 32;
      wgmma_ss_n64(o, desc(cs + off, 16, 1024), desc(ls + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    const float e0 = expf(cum[r0]), e1 = expf(cum[r1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= e0; o[4 * j + 1] *= e0;
      o[4 * j + 2] *= e1; o[4 * j + 3] *= e1;
    }
    __syncthreads();                     // the state's room takes key stage 1
  }

  const float c0 = cum[r0], c1 = cum[r1];
  for (int kt = 0; kt <= tq; ++kt) {
    const uint32_t bs = (kt & 1) ? hs : stage0, xs = bs + CT;
    if (kt < tq) {                       // the next key tile into the other stage
      const uint32_t nb = (kt & 1) ? stage0 : hs;
      load_tile<N>(nb, bb, b_ss, (kt + 1) * TILE_ROWS, Q);
      load_tile<P>(nb + CT, xb, x_ss, (kt + 1) * TILE_ROWS, Q);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk >> 2) * COL_BLOCK + (kk & 3) * 32;
      wgmma_ss_n64(s, desc(cs + off, 16, 1024), desc(bs + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const bool diag = kt == tq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = kt * TILE_ROWS + 8 * j + cq + e;
        const float wd = dts[kj], ck = cum[kj];
        s[4 * j + e] = (!diag || kj <= r0) ? round_bf16(s[4 * j + e]) * expf(c0 - ck) * wd : 0.f;
        s[4 * j + 2 + e] =
            (!diag || kj <= r1) ? round_bf16(s[4 * j + 2 + e]) * expf(c1 - ck) * wd : 0.f;
      }
    }
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float h0 = round_bf16(s[2 * j]), h1 = round_bf16(s[2 * j + 1]);
      ph[j] = pack_bf16x2(h0, h1);     // exact: h0, h1 are bf16 values
      pl[j] = pack_bf16x2(s[2 * j] - h0, s[2 * j + 1] - h1);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < TILE_ROWS / 16; ++j) {
      const uint64_t dx = desc(xs + j * 16 * 128, COL_BLOCK, 1024);
      wgmma_rs(o, ph + 4 * j, dx);
      wgmma_rs(o, pl + 4 * j, dx);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    __syncthreads();                     // this stage is free for tile kt + 2
  }

  bf16* yb = y + (row0 * H + h) * P;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + cq;
    *reinterpret_cast<__nv_bfloat162*>(yb + r0 * x_ss + col) =
        __floats2bfloat162_rn(o[4 * j], o[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(yb + r1 * x_ss + col) =
        __floats2bfloat162_rn(o[4 * j + 2], o[4 * j + 3]);
  }
}

template <int N>
int launch(const void* x, const void* dt, const void* a_log, const void* b, const void* c,
           const void* s0, void* y, void* sf, void* states, int B, int L, int H, int G, int Q,
           cudaStream_t stream) {
  const size_t tiles = (size_t)TILE_ROWS * (P + N) * 2;
  const size_t smem_states = 1024 + (size_t)2 * TILE_ROWS * (2 * P + N) * 2 +
                             2 * sizeof(float) * Q;
  const size_t smem_out = 1024 + (size_t)3 * TILE_ROWS * N * 2 + tiles + 2 * sizeof(float) * Q;
  cudaError_t err = allow_smem(ssd_states_kernel<N>, smem_states);
  if (err == cudaSuccess) err = allow_smem(ssd_out_kernel<N>, smem_out);
  if (err != cudaSuccess) return (int)err;
  ssd_states_kernel<N><<<B * H, THREADS, smem_states, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)a_log, (const bf16*)b,
      (const float*)s0, (bf16*)states, (float*)sf, L, H, G, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Q / TILE_ROWS, L / Q, B * H);
  ssd_out_kernel<N><<<grid, THREADS, smem_out, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)a_log, (const bf16*)b, (const bf16*)c,
      (const float*)s0, (const bf16*)states, (bf16*)y, L, H, G, Q);
  return (int)cudaGetLastError();
}

}  // namespace tensor_core
}  // namespace

// x, b, c, y in `dtype` (f32 or bf16); dt, a_log, init_state (nullable) and
// final_state in f32. Needs L % Q == 0, H % G == 0, P <= 64, N <= 128.
extern "C" int repro_ssd(const void* x, const void* dt, const void* a_log, const void* b,
                         const void* c, const void* init_state, void* y, void* final_state,
                         int B, int L, int H, int P, int G, int N, int Q, int dtype,
                         void* stream) {
  if (Q <= 0 || L % Q || G <= 0 || H % G || P > cuda_core::PMAX || N > cuda_core::NMAX || P <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return cuda_core::launch<float>(x, dt, a_log, b, c, init_state, y, final_state, B, L, H, P, G, N, Q, s);
  if (dtype == DT_BF16)
    return cuda_core::launch<__nv_bfloat16>(x, dt, a_log, b, c, init_state, y, final_state, B, L, H, P,
                                 G, N, Q, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core instance: bf16 x, b, c, y; P 64, N 64 or 128, Q a
// multiple of 64; x, b, c and y contiguous with 16-byte aligned bases.
// states: bf16 scratch [B, H, L / Q, 2, P, N] for the state entering each
// chunk, split into a high part and a residual (nullable when L == Q and
// there is no initial state). One call launches
// ssd_states_kernel, then ssd_out_kernel, on the stream.
extern "C" int repro_ssd_wgmma(const void* x, const void* dt, const void* a_log,
                               const void* b, const void* c, const void* init_state, void* y,
                               void* final_state, void* states, int B, int L, int H, int P,
                               int G, int N, int Q, void* stream) {
  if (Q <= 0 || Q % 64 || L % Q || G <= 0 || H % G || P != tensor_core::P ||
      ((L > Q || init_state != nullptr) && states == nullptr) || B * H > 65535 ||
      L / Q > 65535)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {x, b, c, y};
  for (const void* p : ptrs)
    if ((size_t)p % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N == 64)
    return tensor_core::launch<64>(x, dt, a_log, b, c, init_state, y, final_state, states, B,
                                   L, H, G, Q, s);
  if (N == 128)
    return tensor_core::launch<128>(x, dt, a_log, b, c, init_state, y, final_state, states,
                                    B, L, H, G, Q, s);
  return (int)cudaErrorInvalidValue;
}
