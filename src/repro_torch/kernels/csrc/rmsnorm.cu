// RMSNorm and fused residual-add + RMSNorm for Hopper.
//
// Replaces the Pallas kernels rmsnorm / rmsnorm_residual
// (src/repro/kernels/rmsnorm.py, bodies _rmsnorm_kernel and
// _rmsnorm_res_kernel). One block per row of [M, D]; each thread strides the
// row, the sum of squares is reduced in f32 across the block, and a second
// pass over the (L1-resident) row writes the output. The residual variant
// norms the UNROUNDED f32 sum s = x + r and writes s rounded to the IO type,
// which is the Pallas kernel's order (kernels/ref.py rounds s first).
#include "common.cuh"

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = (lane < (int)(blockDim.x >> 5)) ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

template <typename T, typename W>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                               const W* __restrict__ w, T* __restrict__ out,
                               T* __restrict__ res, int D, float eps, int plus_one) {
  __shared__ float red[33];
  const size_t base = (size_t)blockIdx.x * D;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s = to_f32(x[base + d]);
    if (r != nullptr) {
      s += to_f32(r[base + d]);
      res[base + d] = from_f32<T>(s);
    }
    ss += s * s;
  }
  const float inv = rsqrtf(block_sum(ss, red) / (float)D + eps);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s = to_f32(x[base + d]);
    if (r != nullptr) s += to_f32(r[base + d]);
    float wv = to_f32(w[d]);
    if (plus_one) wv += 1.f;
    out[base + d] = from_f32<T>(s * inv * wv);
  }
}

template <typename T, typename W>
static int launch(const void* x, const void* r, const void* w, void* out, void* res,
                  long long M, int D, float eps, int plus_one, cudaStream_t stream) {
  int threads = ((D + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  rmsnorm_kernel<T, W><<<(unsigned)M, threads, 0, stream>>>(
      (const T*)x, (const T*)r, (const W*)w, (T*)out, (T*)res, D, eps, plus_one);
  return (int)cudaGetLastError();
}

// r == res == nullptr: plain RMSNorm; otherwise the fused residual variant.
extern "C" int repro_rmsnorm(const void* x, const void* r, const void* w, void* out,
                             void* res, long long M, int D, float eps, int plus_one,
                             int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == DT_F32 && w_dtype == DT_F32)
    return launch<float, float>(x, r, w, out, res, M, D, eps, plus_one, s);
  if (x_dtype == DT_F32 && w_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(x, r, w, out, res, M, D, eps, plus_one, s);
  if (x_dtype == DT_BF16 && w_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(x, r, w, out, res, M, D, eps, plus_one, s);
  if (x_dtype == DT_BF16 && w_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, r, w, out, res, M, D, eps, plus_one, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
