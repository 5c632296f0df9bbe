// RMSNorm and fused residual-add + RMSNorm for Hopper.
//
// Replaces the Pallas kernels rmsnorm / rmsnorm_residual
// (src/repro/kernels/rmsnorm.py, bodies _rmsnorm_kernel and
// _rmsnorm_res_kernel). The residual variant norms the UNROUNDED f32 sum
// s = x + r and writes s rounded to the IO type, which is the Pallas
// kernel's order (kernels/ref.py rounds s first).
//
// What bounds it on the H100: bytes, each row read once (x and r) and
// written once, a few f32 operations an element. At decode batch (4 rows of
// 576-5120) that is 5-41 KB, far below what the launch and one round trip
// to device memory cost, so the time is latency: how many dependent loads
// a thread waits on and how many SMs share the row. At prefill (2048 rows)
// it is the 3.35 TB/s of device memory. The design:
//
// - Each thread loads VPT vectors of N elements (16 bytes: 8 bf16 or 4
//   f32; N = 1 in the scalar instance for widths or bases the vectors
//   cannot take), all of them before any add, and keeps the row's values
//   in registers: x (and r) are read from device memory once, and the
//   output is written from the registers.
// - A row takes one CTA of up to 256 threads (`tpr` threads), or, where
//   rows are many and short (prefill at 576), one warp, 4 rows a CTA. One
//   round of 16-byte loads covers a 5120-wide bf16 row. A decode row split
//   over a thread-block cluster (partial sums exchanged through
//   distributed shared memory) was measured slower at every width of the
//   paths, its barriers costing more than the SMs it added (PERF.md), and
//   is not built.
// - Few rows load the weights with x (the call is one round of latency);
//   many rows load them after the sum (EARLY_W false), since holding them
//   would cut the CTAs in flight of a bandwidth-bound call.
//
// The plan (vector width, threads per row, rows per CTA, vectors per
// thread) comes from the Python wrapper's planner (kernels/rmsnorm.py,
// rmsnorm_plan); this entry checks it and refuses a plan it cannot run.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;   // threads a CTA (rmsnorm.py: MAX_THREADS)

// N consecutive elements at p (16-byte aligned when N * sizeof(V) >= 16)
// as f32, in loads of 16 bytes (8 where N * sizeof(V) is 8).
template <typename V, int N>
__device__ __forceinline__ void load_n(const V* p, float* out) {
  constexpr int BYTES = N * (int)sizeof(V);
  if constexpr (BYTES >= 16) {
    constexpr int E = 16 / sizeof(V);
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      const V* e = reinterpret_cast<const V*>(&u);
#pragma unroll
      for (int i = 0; i < E; ++i) out[c * E + i] = to_f32(e[i]);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const V* e = reinterpret_cast<const V*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float* v) {
  if constexpr (N * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f32<T>(v[i]);
  }
}

// Thread t of a row's group of tpr threads holds the vectors t % tpr + k *
// tpr, k < VPT: neighbouring threads read neighbouring 16-byte words.
template <typename T, typename W, int VPT, int N, bool EARLY_W>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r, const W* __restrict__ w,
               T* __restrict__ out, T* __restrict__ res, long long M, int D, float eps,
               int plus_one, int tpr, int rows_per_cta) {
  __shared__ float red[33];
  const int tid = threadIdx.x;
  const long long row = (long long)blockIdx.x * rows_per_cta + tid / tpr;
  const bool live = row < M;
  const int nvec = D / N;
  const int first = tid % tpr;
  const size_t base = (size_t)(live ? row : 0) * D;

  float v[VPT][N], wv[VPT][N];
  bool ok[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {   // every load issued before any add
    const int i = first + k * tpr;
    ok[k] = live && i < nvec;
    if (ok[k]) load_n<T, N>(x + base + (size_t)i * N, v[k]);
  }
  if constexpr (EARLY_W) {           // the weights too: no load after the sum
#pragma unroll
    for (int k = 0; k < VPT; ++k)
      if (ok[k]) load_n<W, N>(w + (size_t)(first + k * tpr) * N, wv[k]);
  }
  if (r != nullptr) {
    float rv[VPT][N];
#pragma unroll
    for (int k = 0; k < VPT; ++k)
      if (ok[k]) load_n<T, N>(r + base + (size_t)(first + k * tpr) * N, rv[k]);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (!ok[k]) continue;
#pragma unroll
      for (int e = 0; e < N; ++e) v[k][e] += rv[k][e];
      store_n<T, N>(res + base + (size_t)(first + k * tpr) * N, v[k]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k)
    if (ok[k])
#pragma unroll
      for (int e = 0; e < N; ++e) ss = fmaf(v[k][e], v[k][e], ss);

  ss = warp_sum(ss);                 // tpr == 32: the row's sum
  if (tpr > 32) {                    // one row a CTA: across its warps
    const int lane = tid & 31, warp = tid >> 5;
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    if (warp == 0) {
      float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
      t = warp_sum(t);
      if (lane == 0) red[32] = t;
    }
    __syncthreads();
    ss = red[32];
  }
  const float inv = rsqrtf(ss / (float)D + eps);

#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (!ok[k]) continue;
    const int i = first + k * tpr;
    if constexpr (!EARLY_W) load_n<W, N>(w + (size_t)i * N, wv[k]);
#pragma unroll
    for (int e = 0; e < N; ++e)
      v[k][e] = v[k][e] * inv * (plus_one ? wv[k][e] + 1.f : wv[k][e]);
    store_n<T, N>(out + base + (size_t)i * N, v[k]);
  }
}

template <typename T, typename W, int VPT, int N, bool EARLY_W>
static int launch_as(const void* x, const void* r, const void* w, void* out, void* res,
                     long long M, int D, float eps, int plus_one, int tpr, int rpc,
                     cudaStream_t stream) {
  const long long groups = (M + rpc - 1) / rpc;
  rmsnorm_kernel<T, W, VPT, N, EARLY_W><<<(unsigned)groups, tpr * rpc, 0, stream>>>(
      (const T*)x, (const T*)r, (const W*)w, (T*)out, (T*)res, M, D, eps, plus_one, tpr, rpc);
  return (int)cudaGetLastError();
}

// vectors a thread: 1-8 (rmsnorm.py: VPT_CHOICES); the scalar instance
// (N 1) also 16 and 32 (SCALAR_VPT_CHOICES), so that one CTA covers its row
template <typename T, typename W, int N, bool EARLY_W>
static int launch_vpt(const void* x, const void* r, const void* w, void* out, void* res,
                      long long M, int D, float eps, int plus_one, int tpr, int rpc, int vpt,
                      cudaStream_t s) {
  switch (vpt) {
    case 1: return launch_as<T, W, 1, N, EARLY_W>(x, r, w, out, res, M, D, eps, plus_one, tpr, rpc, s);
    case 2: return launch_as<T, W, 2, N, EARLY_W>(x, r, w, out, res, M, D, eps, plus_one, tpr, rpc, s);
    case 4: return launch_as<T, W, 4, N, EARLY_W>(x, r, w, out, res, M, D, eps, plus_one, tpr, rpc, s);
    case 8: return launch_as<T, W, 8, N, EARLY_W>(x, r, w, out, res, M, D, eps, plus_one, tpr, rpc, s);
  }
  if constexpr (N == 1) {
    switch (vpt) {
      case 16: return launch_as<T, W, 16, 1, EARLY_W>(x, r, w, out, res, M, D, eps, plus_one, tpr, rpc, s);
      case 32: return launch_as<T, W, 32, 1, EARLY_W>(x, r, w, out, res, M, D, eps, plus_one, tpr, rpc, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename W, int N>
static int launch_w(const void* x, const void* r, const void* w, void* out, void* res,
                    long long M, int D, float eps, int plus_one, int tpr, int rpc, int vpt,
                    int early_w, cudaStream_t s) {
  if (early_w)
    return launch_vpt<T, W, N, true>(x, r, w, out, res, M, D, eps, plus_one, tpr, rpc, vpt, s);
  return launch_vpt<T, W, N, false>(x, r, w, out, res, M, D, eps, plus_one, tpr, rpc, vpt, s);
}

template <typename T, typename W>
static int launch(const void* x, const void* r, const void* w, void* out, void* res,
                  long long M, int D, float eps, int plus_one, int tpr, int rpc, int vpt,
                  int vec, int early_w, cudaStream_t s) {
  constexpr int NV = 16 / sizeof(T);
  if (vec == NV) {
    const void* ptrs[5] = {x, r, w, out, res};
    for (const void* p : ptrs)
      if ((size_t)p % 16) return (int)cudaErrorInvalidValue;
    if (D % NV) return (int)cudaErrorInvalidValue;
    return launch_w<T, W, NV>(x, r, w, out, res, M, D, eps, plus_one, tpr, rpc, vpt, early_w,
                               s);
  }
  if (vec == 1)
    return launch_w<T, W, 1>(x, r, w, out, res, M, D, eps, plus_one, tpr, rpc, vpt, early_w, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// r == res == nullptr: plain RMSNorm; otherwise the fused residual variant.
// The plan: tpr threads a row, rows_per_cta rows a CTA (more than one only
// with tpr 32), vpt vectors of vec elements a thread (vec 16 bytes' worth,
// or 1: the scalar instance), covering the row: tpr * vpt * vec >= D;
// early_w loads the weights with x (latency-bound calls) instead of after
// the sum (bandwidth-bound calls, where the registers would cut occupancy).
extern "C" int repro_rmsnorm(const void* x, const void* r, const void* w, void* out,
                             void* res, long long M, int D, float eps, int plus_one,
                             int x_dtype, int w_dtype, int tpr, int rows_per_cta, int vpt,
                             int vec, int early_w, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tpr < 32 || tpr % 32 || rows_per_cta < 1 || tpr * rows_per_cta > MAX_THREADS ||
      (rows_per_cta > 1 && tpr != 32) || (long long)tpr * vpt * vec < D)
    return (int)cudaErrorInvalidValue;
  if (x_dtype == DT_F32 && w_dtype == DT_F32)
    return launch<float, float>(x, r, w, out, res, M, D, eps, plus_one, tpr, rows_per_cta, vpt,
                                vec, early_w, s);
  if (x_dtype == DT_F32 && w_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(x, r, w, out, res, M, D, eps, plus_one, tpr,
                                        rows_per_cta, vpt, vec, early_w, s);
  if (x_dtype == DT_BF16 && w_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(x, r, w, out, res, M, D, eps, plus_one, tpr,
                                        rows_per_cta, vpt, vec, early_w, s);
  if (x_dtype == DT_BF16 && w_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, r, w, out, res, M, D, eps, plus_one, tpr,
                                                rows_per_cta, vpt, vec, early_w, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
