// Mamba2 SSD chunked scan for Hopper.
//
// Replaces the Pallas kernel `ssd` (src/repro/kernels/ssd_scan.py, body
// _ssd_kernel). One block per (batch row, head) walks the chunks in order:
// the TPU grid's sequential chunk axis becomes the loop, and the running
// [P, N] f32 state stays in shared memory across it. Per chunk of Q tokens:
//
//   cum     = prefix sum of dt * (-exp(a_log))                  (one warp scan)
//   y[i]    = exp(cum_i) (C_i . state)                           (y_inter)
//           + sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j  (y_intra)
//   state  <- state exp(cum_Q) + sum_j x_j (B_j exp(cum_Q - cum_j) dt_j)^T
//
// The Q x Q decay matrix (256 KB in f32 at Q 256) does not fit in shared
// memory, so query rows go in tiles of 64 against key tiles of 64 at or below
// the diagonal (causal: tiles above it are skipped). B and C are read for
// group g = h / (H / G), with no copy per head. y is written in x's type; the
// state and all sums are f32.
//
// What bounds it on the H100: at the mamba2-2.7b prefill shapes (B 4, L 512,
// H 80, P 64, N 128, Q 256) the call moves about 50 MB (x, y, the f32 final
// state) and does about 14 GFLOP of products, so it would be bound by bytes
// (about 16 us) if the products ran on the tensor cores. This first version
// runs them on f32 CUDA cores from shared memory, 4x4 register tiles per
// thread, and B x H = 320 blocks of 134 KB of shared memory each (one per SM),
// so it is bound by those products; wgmma tiles are the next step.
#include "common.cuh"

namespace {

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
    if (tid < 32) {                          // cum: each lane a run, then a warp scan
      const int per = (Q + 31) / 32, lo = tid * per, hi = min(lo + per, Q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += __fmul_rn(dts[i], neg_a);    // da = dt * a rounded, then summed
        cum[i] = run;
      }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float before = incl - run;
      for (int i = lo; i < hi; ++i) cum[i] += before;
    }
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

}  // namespace

// x, b, c, y in `dtype` (f32 or bf16); dt, a_log, init_state (nullable) and
// final_state in f32. Needs L % Q == 0, H % G == 0, P <= 64, N <= 128.
extern "C" int repro_ssd(const void* x, const void* dt, const void* a_log, const void* b,
                         const void* c, const void* init_state, void* y, void* final_state,
                         int B, int L, int H, int P, int G, int N, int Q, int dtype,
                         void* stream) {
  if (Q <= 0 || L % Q || G <= 0 || H % G || P > PMAX || N > NMAX || P <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch<float>(x, dt, a_log, b, c, init_state, y, final_state, B, L, H, P, G, N, Q, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, dt, a_log, b, c, init_state, y, final_state, B, L, H, P,
                                 G, N, Q, s);
  return (int)cudaErrorInvalidValue;
}
