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
//
// The three sums are taken by ONE thread, left to right over the m lanes:
// rates_seq sums with Python's builtin sum(), which since CPython 3.12 is
// Neumaier's compensated sum, and `compensated` selects that algorithm step
// for step; with compensated == 0 the sums are plain left-to-right adds, as
// the JAX kernels take them.
//
// What bounds it on the H100: the serial chain. The bytes (4 inputs and 3
// outputs per lane, a few hundred KB at fleet-scale m) take well under a
// microsecond at 3.35 TB/s; the three sums are 3m dependent adds, each
// waiting for the last. The design gives that chain one thread, which reads
// its operands from shared memory (the block stages them 2048 at a time, so
// each add waits on the last add and not on a load), runs the elementwise
// steps across all 256 threads between the sums, and launches one block per
// rate-group on the caller's stream.
#include "common.cuh"

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

constexpr int THREADS = 256;
constexpr int TILE = 2048;   // elements staged in shared memory per pass

// Left-to-right sum of a[0..m), plain or Neumaier-compensated exactly as
// CPython 3.12's builtin sum() over floats (bltinmodule.c, builtin_sum_impl),
// returned to every thread. The block stages the operands tile by tile in
// shared memory (other threads of the block wrote them in this launch), and
// thread 0 takes the whole chain, carrying the sum and its compensation from
// tile to tile.
template <typename T>
__device__ T block_serial_sum(const T* a, long long m, int compensated, T* tile,
                              T* bcast) {
  T f = T(0), c = T(0);
  for (long long t0 = 0; t0 < m; t0 += TILE) {
    const int n = (int)min((long long)TILE, m - t0);
    __syncthreads();                         // the last tile is consumed
    for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = a[t0 + i];
    __syncthreads();
    if (threadIdx.x != 0) continue;
    if (!compensated) {
#pragma unroll 8
      for (int i = 0; i < n; ++i) f = add_rn(f, tile[i]);
      continue;
    }
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const T x = tile[i];
      const T t = add_rn(f, x);
      if (fabs(f) >= fabs(x))
        c = add_rn(c, add_rn(sub_rn(f, t), x));
      else
        c = add_rn(c, add_rn(sub_rn(x, t), f));
      f = t;
    }
  }
  if (threadIdx.x == 0) *bcast = (c != T(0) && isfinite(c)) ? add_rn(f, c) : f;
  __syncthreads();
  return *bcast;
}

// in: [4, m] rows u, ns, mf, rem. out: [3, m] rows speed (pre-clamp), rate,
// eta; rows 1 and 2 double as the block's scratch for the summed products.
template <typename T>
__global__ void contention_eta_kernel(const T* __restrict__ in, T* __restrict__ out,
                                      long long m, T now, T n_units, T bubble, T l2p,
                                      int compensated) {
  const T* u = in;
  const T* ns = in + m;
  const T* mf = in + 2 * m;
  const T* rem = in + 3 * m;
  T* speed = out;
  T* scratch = out + m;
  __shared__ T tile[TILE];
  __shared__ T bcast;
  const T one = T(1), mm = T(m);

  const T total = block_serial_sum(u, m, compensated, tile, &bcast);
  const bool capped = total > n_units;
  const T scale = div_rn(n_units, total);
  const T gain = div_rn(sub_rn(one, div_rn(bubble, mm)), sub_rn(one, bubble));
  for (long long i = threadIdx.x; i < m; i += blockDim.x) {
    T ui = u[i];
    if (capped) ui = mul_rn(ui, scale);
    const T n = ns[i];
    T s = mul_rn(div_rn(fmin(ui, n), n), gain);
    s = fmin(one, s);
    speed[i] = s;
    scratch[i] = mul_rn(s, n);
  }

  const T used = block_serial_sum(scratch, m, compensated, tile, &bcast);
  const T budget = mul_rn(n_units, add_rn(one, mul_rn(bubble, sub_rn(one, div_rn(one, mm)))));
  const bool shrink = used > budget;
  const T shrink_by = div_rn(budget, used);
  for (long long i = threadIdx.x; i < m; i += blockDim.x) {
    T s = speed[i];
    if (shrink) s = mul_rn(s, shrink_by);
    speed[i] = s;
    scratch[i] = mul_rn(mf[i], s);
  }

  const T thrash = add_rn(one, mul_rn(l2p, fmax(sub_rn(mm, one), T(0))));
  const T phi = mul_rn(block_serial_sum(scratch, m, compensated, tile, &bcast),
                       thrash);
  for (long long i = threadIdx.x; i < m; i += blockDim.x) {
    T s = speed[i];
    const T f = mf[i];
    if (phi > one) s = div_rn(s, add_rn(sub_rn(one, f), mul_rn(f, phi)));
    const T rate = s > T(1e-6) ? s : T(1e-6);
    speed[i] = s;
    out[m + i] = rate;
    out[2 * m + i] = add_rn(now, div_rn(rem[i], rate));
  }
}

template <typename T>
static int launch(const void* in, void* out, long long m, double now, double n_units,
                  double bubble, double l2p, int compensated, cudaStream_t stream) {
  contention_eta_kernel<T><<<1, THREADS, 0, stream>>>(
      (const T*)in, (T*)out, m, (T)now, (T)n_units, (T)bubble, (T)l2p, compensated);
  return (int)cudaGetLastError();
}

// dtype: DT_F64 (the engine's bit-exact instance) or DT_F32 (fused_pallas).
extern "C" int repro_contention_eta(const void* in, void* out, long long m, double now,
                                    double n_units, double bubble, double l2p,
                                    int compensated, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F64)
    return launch<double>(in, out, m, now, n_units, bubble, l2p, compensated, s);
  if (dtype == DT_F32)
    return launch<float>(in, out, m, now, n_units, bubble, l2p, compensated, s);
  return (int)cudaErrorInvalidValue;
}
