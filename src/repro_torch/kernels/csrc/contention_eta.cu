// Fused contention + ETA pass over one rate-group of lanes, for Hopper.
//
// Replaces kernels/contention_eta.py of the JAX package: the f64 instance
// stands for the jitted `_kernel_f64` behind `rates`/`fused` (the function
// the epoch engine calls above KERNEL_MIN lanes), the f32 instance for the
// Pallas kernel `fused_pallas`. Per lane i of m:
//
//   total = sum u;          u_i *= n_units / total       if total > n_units
//   s_i   = min(1, min(u_i, ns_i) / ns_i * gain),        gain = (1 - b/m) / (1 - b)
//   used  = sum s*ns;       s_i *= budget / used         if used > budget
//   phi   = (sum mf*s) * thrash
//   s_i  /= (1 - mf_i) + mf_i * phi                      if phi > 1
//   rate_i = max(s_i, 1e-6);  eta_i = now + rem_i / rate_i
//
// with budget = n_units * (1 + b * (1 - 1/m)), thrash = 1 + l2p * max(m-1, 0):
// the op order of ContentionModel.rates_arrays, one IEEE-754 operation at a
// time. Every product, sum and quotient goes through a round-to-nearest
// intrinsic, which nvcc never contracts into an FMA (nor turns a divide into
// a reciprocal multiply), so the f64 instance returns the bits of rates_seq.
// There is no product of matrices here, so no tensor cores.
//
// The three sums are left to right over the m lanes: rates_seq sums with
// Python's builtin sum(), which since CPython 3.12 is Neumaier's compensated
// sum, and `compensated` selects that algorithm; with compensated == 0 (and
// in every f32 call) the sums are plain left-to-right adds, as the JAX
// kernels take them.
//
// What bounds it on the H100: the serial chain. The bytes (4 inputs and 3
// outputs per lane, a few hundred KB at fleet-scale m) take well under a
// microsecond at 3.35 TB/s; each sum is m dependent adds, and an add cannot
// start before the previous one's result is back, so the least time is
// 3 m times the latency of one add (measured on the card by
// repro_chain_probe below). The design keeps the chain waiting on nothing
// else:
//
// * Lanes resident in shared memory. One block per rate-group, 512
//   threads. The u, ns and mf columns arrive by one TMA bulk copy each
//   (cp.async.bulk completing on an mbarrier); the speeds, the products to
//   be summed and the compensated sum's checkpoints stay in shared memory,
//   and only speed, rate and eta are written back (rem is read once, in the
//   last pass). Five columns of m (rounded up to 32) and 128 bytes fit in
//   the 232,448 bytes a block may take up to 5,792 lanes in f64 and 11,616
//   in f32 (kernels/contention_eta.py: resident_max). Above that the same
//   code runs on the columns in a device-memory workspace the wrapper
//   allocates (the `tiled` instance): right, not fast.
// * The chain reads its operands into two register rings of 64 bytes in
//   16-byte shared loads, each ring loaded while the other one's adds run,
//   and its body has no data-dependent branch, so that it takes one add's
//   latency a lane (the probe's `chain` mode measures it against `add`).
// * Compensated sums run as a pipeline of three warps, a chunk of 256
//   lanes at a time. Warp 0 runs the f chain, t_i = f_{i-1} + x_i, storing
//   f once a ring of 8 (16 in f32). Warp 2 gives each lane one ring, walks
//   it again from its checkpoint (the same adds, so the same t_i) and forms
//   e_i = |f_{i-1}| >= |x_i| ? (f_{i-1} - t_i) + x_i : (x_i - t_i) + f_{i-1}
//   with selects. Warp 1 adds the e_i into c left to right. Both chains
//   take one add a lane, in CPython's order; f + c closes the sum where c
//   is finite and non-zero. The warps hand chunks over on named barriers
//   (bar.arrive / bar.sync), 3 in flight. The same step in one warp (the
//   probe's `neumaier_select` mode) waits on the compare and selects as
//   well as the adds. What the pipeline costs above the plain chain: warp
//   1's last chunk after warp 0 ends, and each hand-over.
// * The elementwise passes run across all 512 threads between the sums;
//   the only block-wide barriers are the ones the data needs (the sums are
//   sequential: total, then used, then phi).
#include "common.cuh"

namespace {

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

constexpr int THREADS = 512;
constexpr int COLUMNS = 5;   // u (then the products), ns, mf, speed, checkpoints
constexpr int PAD = 32;      // a column holds m rounded up to PAD lanes
constexpr int HEAD = 128;    // bytes of shared memory ahead of the columns
constexpr int CHUNK = 256;   // lanes a compensated sum's warps hand over at a time
// chunks in flight between two warps of the compensated sum, each hand-over
// on a pair of named barriers (full, free); barrier 0 is __syncthreads'
constexpr int NBAR = 3;
constexpr int BAR_F_FULL = 1, BAR_F_FREE = 1 + NBAR, BAR_E_FULL = 1 + 2 * NBAR,
              BAR_E_FREE = 1 + 3 * NBAR;
constexpr int PROBE_N = 4096;

__host__ __device__ constexpr long long col_stride(long long m) {
  return (m + PAD - 1) / PAD * PAD;
}

// ------------------------------------------------------------ barriers, TMA
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// ------------------------------------------------------------------ chains
// 64 bytes of operands a step: 8 doubles or 16 floats, in 16-byte loads
template <typename T> struct Ring;
template <> struct Ring<double> {
  static constexpr int N = 8;
  __device__ static void load(double (&r)[N], const double* p) {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const double2 v = reinterpret_cast<const double2*>(p)[k];
      r[2 * k] = v.x;
      r[2 * k + 1] = v.y;
    }
  }
};
template <> struct Ring<float> {
  static constexpr int N = 16;
  __device__ static void load(float (&r)[N], const float* p) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(p)[k];
      r[4 * k] = v.x;
      r[4 * k + 1] = v.y;
      r[4 * k + 2] = v.z;
      r[4 * k + 3] = v.w;
    }
  }
};

// step(a[j], j, end) for j = 0..n-1 in order, end true where a[j] closes a
// ring (j + 1 a multiple of Ring<T>::N; known at compile time outside the
// tail). The operands come in 16-byte loads into two register rings, each
// loaded while the other one's steps run, so that a step waits on the
// previous step and not on a load. The loads are unconditional and read up
// to Ring<T>::N elements past a[n): the callers' columns are followed by
// another column (or padding). a is 16-byte aligned.
template <typename T, typename Step>
__device__ __forceinline__ void walk(const T* a, int n, Step step) {
  constexpr int N = Ring<T>::N;
  const int full = n / (2 * N) * (2 * N);
  T A[N], B[N];
  Ring<T>::load(A, a);
  for (int j = 0; j < full; j += 2 * N) {
    Ring<T>::load(B, a + j + N);
#pragma unroll
    for (int q = 0; q < N; ++q) step(A[q], j + q, q == N - 1);
    Ring<T>::load(A, a + j + 2 * N);
#pragma unroll
    for (int q = 0; q < N; ++q) step(B[q], j + N + q, q == N - 1);
  }
  for (int j = full; j < n; ++j) step(a[j], j, (j + 1) % N == 0);
}

// f + a[0] + ... + a[n-1] left to right.
template <typename T>
__device__ __forceinline__ T chain(T f, const T* a, int n) {
  walk(a, n, [&](T x, int, bool) { f = add_rn(f, x); });
  return f;
}

// *p = v in lane 0 alone. In shared memory (SMEM) a store predicated on the
// lane: the compiler's branch around `if (lane0)` splits the warp on every
// ring.
template <bool SMEM>
__device__ __forceinline__ void store_lane0(double* p, double v, bool lane0) {
  if constexpr (SMEM)
    asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %0, 0;\n @q st.shared.f64 [%1], %2;\n}\n"
                 :: "r"((int)lane0), "r"(smem_u32(p)), "d"(v));
  else if (lane0)
    *p = v;
}
template <bool SMEM>
__device__ __forceinline__ void store_lane0(float* p, float v, bool lane0) {
  if constexpr (SMEM)
    asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %0, 0;\n @q st.shared.f32 [%1], %2;\n}\n"
                 :: "r"((int)lane0), "r"(smem_u32(p)), "f"(v));
  else if (lane0)
    *p = v;
}

// Neumaier's error term of t = f + x, CPython 3.12's order, without a branch
template <typename T>
__device__ __forceinline__ T neumaier_e(T f, T x, T t) {
  const bool big = fabs(f) >= fabs(x);
  const T a = big ? f : x, b = big ? x : f;
  return add_rn(sub_rn(a, t), b);
}

// sum(x[0..m)) left to right, plain or Neumaier-compensated exactly as
// CPython 3.12's builtin sum() over floats (bltinmodule.c, builtin_sum_impl:
// t = f + x; c += e; f = t; at the end f + c where c is finite and
// non-zero), returned to every thread. Compensated, three warps in a
// pipeline, a chunk at a time: warp 0 runs the f chain, checkpointing f in
// ck once a ring; warp 2 gives each lane one ring, which it walks again
// from its checkpoint (the same adds, so the same t_i), forming the e_i
// into e (which may alias x); warp 1 runs the c chain over them. (Walks
// over the whole column with the hand-overs inside them measured slower
// than a walk a chunk.) Called by every thread of the block; x and e
// 16-byte aligned and followed by another column; ck holds
// m / Ring<T>::N + 1 elements (in shared memory where SMEM), bcast two.
template <bool SMEM, typename T>
__device__ T block_sum(T* x, int m, bool compensated, T* ck, T* e, T* bcast) {
  constexpr int N = Ring<T>::N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (m + CHUNK - 1) / CHUNK;
  if (!compensated) {
    if (warp == 0) {
      const T f = chain(T(0), x, m);
      if (lane == 0) *bcast = f;
    }
  } else if (warp == 0) {                    // the f chain
    T f = T(0);
    for (int k = 0, base = 0; k < chunks; ++k, base += CHUNK) {
      walk(x + base, min(CHUNK, m - base), [&](T v, int j, bool end) {
        f = add_rn(f, v);
        if (end) store_lane0<SMEM>(ck + (base + j) / N, f, lane == 0);
      });
      if (k == chunks - 1 && lane == 0) bcast[1] = f;
      if (k >= NBAR) named_sync(BAR_F_FREE + k % NBAR);
      __threadfence_block();
      named_arrive(BAR_F_FULL + k % NBAR);
    }
  } else if (warp == 2) {                    // the error terms, a ring a lane
    for (int k = 0, base = 0; k < chunks; ++k, base += CHUNK) {
      const int end = min(base + CHUNK, m), i0 = base + lane * N;
      named_sync(BAR_F_FULL + k % NBAR);
      if (k + NBAR < chunks) named_arrive(BAR_F_FREE + k % NBAR);
      if (k >= NBAR) named_sync(BAR_E_FREE + k % NBAR);
      if (lane < CHUNK / N && i0 < end) {
        T f = i0 ? ck[i0 / N - 1] : T(0);
#pragma unroll
        for (int q = 0; q < N; ++q) {
          const int i = i0 + q;
          if (i < end) {
            const T xi = x[i], t = add_rn(f, xi);
            e[i] = neumaier_e(f, xi, t);
            f = t;
          }
        }
      }
      __syncwarp();
      __threadfence_block();
      named_arrive(BAR_E_FULL + k % NBAR);
    }
  } else if (warp == 1) {                    // the c chain
    T c = T(0);
    for (int k = 0, base = 0; k < chunks; ++k, base += CHUNK) {
      named_sync(BAR_E_FULL + k % NBAR);
      if (k + NBAR < chunks) named_arrive(BAR_E_FREE + k % NBAR);
      c = chain(c, e + base, min(CHUNK, m - base));
    }
    if (lane == 0) {
      const T f = bcast[1];
      *bcast = (c != T(0) && isfinite(c)) ? add_rn(f, c) : f;
    }
  }
  __syncthreads();
  return *bcast;
}

// in: rows u, ns, mf, rem of m lanes, ld_in apart. out: rows speed
// (pre-clamp), rate, eta, ld_out apart. RESIDENT: the columns in shared
// memory (bulk: TMA copies; the host checked alignment); otherwise in ws,
// COLUMNS * col_stride(m) elements of device memory.
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(THREADS)
contention_eta_kernel(const T* __restrict__ in, long long ld_in, T* __restrict__ out,
                      long long ld_out, T* __restrict__ ws, int m, T now, T n_units, T bubble,
                      T l2p, int compensated, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* bcast = reinterpret_cast<T*>(smem + 16);
  const long long mp = col_stride(m);
  T* cols = RESIDENT ? reinterpret_cast<T*>(smem + HEAD) : ws;
  T* P = cols;              // u, then the products summed
  T* NS = cols + mp;
  T* MF = cols + 2 * mp;
  T* S = cols + 3 * mp;     // the total's error terms, then the speeds
  T* CK = cols + 4 * mp;    // the f chain's checkpoints
  const T* rem = in + 3 * ld_in;
  const int tid = threadIdx.x;

  if (RESIDENT && bulk) {
    if (tid == 0) mbar_init(bar, 1);
    __syncthreads();
    if (tid == 0) {
      const uint32_t bytes = (uint32_t)((m * sizeof(T) + 15) / 16 * 16);
      mbar_expect_tx(bar, 3 * bytes);
      for (int r = 0; r < 3; ++r) bulk_copy(cols + r * mp, in + r * ld_in, bytes, bar);
    }
    mbar_wait(bar, 0);
  } else {
    for (int i = tid; i < m; i += THREADS) {
      P[i] = in[i];
      NS[i] = in[ld_in + i];
      MF[i] = in[2 * ld_in + i];
    }
    __syncthreads();
  }

  const T one = T(1), mm = T(m);
  const bool comp = compensated != 0;
  const T total = block_sum<RESIDENT>(P, m, comp, CK, S, bcast);
  const bool capped = total > n_units;
  const T scale = div_rn(n_units, total);
  const T gain = div_rn(sub_rn(one, div_rn(bubble, mm)), sub_rn(one, bubble));
  for (int i = tid; i < m; i += THREADS) {
    T ui = P[i];
    if (capped) ui = mul_rn(ui, scale);
    const T n = NS[i];
    const T s = fmin(one, mul_rn(div_rn(fmin(ui, n), n), gain));
    S[i] = s;
    P[i] = mul_rn(s, n);
  }
  __syncthreads();

  const T used = block_sum<RESIDENT>(P, m, comp, CK, P, bcast);
  const T budget = mul_rn(n_units, add_rn(one, mul_rn(bubble, sub_rn(one, div_rn(one, mm)))));
  const bool shrink = used > budget;
  const T shrink_by = div_rn(budget, used);
  for (int i = tid; i < m; i += THREADS) {
    T s = S[i];
    if (shrink) s = mul_rn(s, shrink_by);
    S[i] = s;
    P[i] = mul_rn(MF[i], s);
  }
  __syncthreads();

  const T thrash = add_rn(one, mul_rn(l2p, fmax(sub_rn(mm, one), T(0))));
  const T phi = mul_rn(block_sum<RESIDENT>(P, m, comp, CK, P, bcast), thrash);
  for (int i = tid; i < m; i += THREADS) {
    T s = S[i];
    const T f = MF[i];
    if (phi > one) s = div_rn(s, add_rn(sub_rn(one, f), mul_rn(f, phi)));
    const T rate = s > T(1e-6) ? s : T(1e-6);
    out[i] = s;
    out[ld_out + i] = rate;
    out[2 * ld_out + i] = add_rn(now, div_rn(rem[i], rate));
  }
}

template <typename T>
static int launch(const void* in, long long ld_in, void* out, long long ld_out, void* ws,
                  long long m, double now, double n_units, double bubble, double l2p,
                  int compensated, int tiled, cudaStream_t stream) {
  if (ld_in < m || ld_out < m) return (int)cudaErrorInvalidValue;
  const T* x = (const T*)in;
  if (tiled) {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    contention_eta_kernel<T, false><<<1, THREADS, HEAD, stream>>>(
        x, ld_in, (T*)out, ld_out, (T*)ws, (int)m, (T)now, (T)n_units, (T)bubble, (T)l2p,
        compensated, 0);
    return (int)cudaGetLastError();
  }
  const size_t smem = HEAD + (size_t)COLUMNS * col_stride(m) * sizeof(T);
  static size_t granted = 0;   // the attribute set so far (one card)
  if (smem > granted) {
    const cudaError_t err = allow_smem(contention_eta_kernel<T, true>, smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  const int bulk = (size_t)in % 16 == 0 && (ld_in * (long long)sizeof(T)) % 16 == 0;
  contention_eta_kernel<T, true><<<1, THREADS, smem, stream>>>(
      x, ld_in, (T*)out, ld_out, nullptr, (int)m, (T)now, (T)n_units, (T)bubble, (T)l2p,
      compensated, bulk);
  return (int)cudaGetLastError();
}

// The latency probe, one warp: clock64 cycles of n steps of
//   mode 0: f = f + d, a chain of dependent adds on registers;
//   mode 1: the kernel's plain chain over n operands in shared memory;
//   mode 2: a branch-free Neumaier step a lane (t = f + x; c += e(f, x, t)),
//           the compensated chain in one warp, over the same operands.
// Written to cycles[0]; the result to sink[0], so nothing is dead code.
template <typename T>
__global__ void chain_probe_kernel(const T* __restrict__ x, long long* cycles, T* sink, int n,
                                   int mode) {
  __shared__ __align__(16) T buf[PROBE_N + 16];   // walk reads past n
  for (int i = threadIdx.x; i < PROBE_N + 16; i += blockDim.x) buf[i] = i < n ? x[i] : T(0);
  __syncthreads();
  T f = x[0];
  const T d = x[1];
  long long t0 = clock64();
  if (mode == 0) {
    for (int i = 0; i < n; i += 32) {
#pragma unroll
      for (int q = 0; q < 32; ++q) f = add_rn(f, d);
    }
  } else if (mode == 1) {
    f = chain(f, buf, n);
  } else {
    T c = T(0);
    walk(buf, n, [&](T v, int, bool) {
      const T t = add_rn(f, v);
      c = add_rn(c, neumaier_e(f, v, t));
      f = t;
    });
    f = add_rn(f, c);
  }
  long long t1 = clock64();
  if (threadIdx.x == 0) {
    cycles[0] = t1 - t0;
    sink[0] = f;
  }
}

}  // namespace

// dtype: DT_F64 (the engine's bit-exact instance) or DT_F32 (fused_pallas).
// tiled: the columns in ws (COLUMNS * col_stride(m) elements) instead of
// shared memory; the wrapper picks it above resident_max lanes.
extern "C" int repro_contention_eta(const void* in, long long ld_in, void* out,
                                    long long ld_out, void* ws, long long m, double now,
                                    double n_units, double bubble, double l2p, int compensated,
                                    int tiled, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= 0 || m > (1LL << 30)) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F64)
    return launch<double>(in, ld_in, out, ld_out, ws, m, now, n_units, bubble, l2p,
                          compensated, tiled, s);
  if (dtype == DT_F32)
    return launch<float>(in, ld_in, out, ld_out, ws, m, now, n_units, bubble, l2p,
                         compensated, tiled, s);
  return (int)cudaErrorInvalidValue;
}

// The wrapper's whole round trip on one stream: h_in (pinned host, [4, ld])
// to d_in, the kernel on d_in -> d_out ([3, ld]), rows row0..row1 of d_out
// back to the same rows of h_out (pinned host), then a synchronize of the
// stream: one call from Python, two copies, one launch, one wait.
extern "C" int repro_contention_eta_round_trip(const void* h_in, void* d_in, void* d_out,
                                               void* h_out, void* ws, long long m,
                                               long long ld, int row0, int row1, double now,
                                               double n_units, double bubble, double l2p,
                                               int compensated, int tiled, int dtype,
                                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t elt = dtype == DT_F64 ? 8 : 4;
  if (row0 < 0 || row1 > 3 || row0 >= row1 || ld < m) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyAsync(d_in, h_in, 4 * ld * elt, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const int launched = repro_contention_eta(d_in, ld, d_out, ld, ws, m, now, n_units, bubble,
                                            l2p, compensated, tiled, dtype, stream);
  if (launched) return launched;
  const size_t off = row0 * ld * elt;
  err = cudaMemcpyAsync((char*)h_out + off, (const char*)d_out + off, (row1 - row0) * ld * elt,
                        cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return (int)err;
}

// Shared memory a block of the current device may opt into, in bytes
// (negative: the CUDA error).
extern "C" int repro_smem_optin() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? bytes : -(int)err;
}

// x: n >= 2 operands (n a multiple of 32, at most PROBE_N), cycles: one
// int64, sink: one element; one warp on the caller's stream.
extern "C" int repro_chain_probe(const void* x, void* cycles, void* sink, int n, int mode,
                                 int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 32 || n % 32 || n > PROBE_N || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_F64)
    chain_probe_kernel<double><<<1, 32, 0, s>>>((const double*)x, (long long*)cycles,
                                                (double*)sink, n, mode);
  else if (dtype == DT_F32)
    chain_probe_kernel<float><<<1, 32, 0, s>>>((const float*)x, (long long*)cycles,
                                               (float*)sink, n, mode);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
