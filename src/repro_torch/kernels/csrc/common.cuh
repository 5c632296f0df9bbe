// Shared helpers for the port's hand-written Hopper kernels.
//
// The model kernels compute in f32 whatever their IO type, as the Pallas
// kernels they replace do. IO types are f32 or bf16 (f64 for the contention
// kernel), selected at run time by the dtype codes below (the Python wrappers in kernels/_lib.py use the same
// numbers). Each extern "C" entry returns cudaGetLastError() so that a
// refused launch reaches the wrapper, which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum { DT_F32 = 0, DT_BF16 = 1, DT_F64 = 2 };

// Masked logits use the Pallas kernels' -1e30, not -inf: a row whose every
// visible slot is masked then averages V exactly as the TPU kernel does.
// Slots past the end of the array (ragged tiles) use -inf and weigh 0.
constexpr float MASKED = -1.0e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Logit transform shared by both attention kernels: scale, optional tanh
// softcap, then the visibility mask.
__device__ __forceinline__ float attn_logit(float dot, float scale, float softcap, bool ok) {
  float s = dot * scale;
  if (softcap > 0.f) s = softcap * tanhf(s / softcap);
  return ok ? s : MASKED;
}

// sum_i a[i] * b[i * stride] with four independent partial sums: the
// products are latency-bound chains of shared-memory reads otherwise.
__device__ __forceinline__ float dot_f32(const float* a, const float* b, int n, int stride) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    s0 = fmaf(a[i], b[i * stride], s0);
    s1 = fmaf(a[i + 1], b[(i + 1) * stride], s1);
    s2 = fmaf(a[i + 2], b[(i + 2) * stride], s2);
    s3 = fmaf(a[i + 3], b[(i + 3) * stride], s3);
  }
  for (; i < n; ++i) s0 = fmaf(a[i], b[i * stride], s0);
  return (s0 + s1) + (s2 + s3);
}

// Stage a [rows, Dh] tile of K and of V (rows row0.. of a strided [S, Dh]
// array, head dimension contiguous) into shared memory as f32: K padded to
// Dh + 1 floats a row (conflict-free column reads), V at Dh. Rows at or past
// S read as zero. With VEC, each thread moves 16 bytes at a time, which
// keeps many loads in flight; the host picks VEC only when Dh, the row
// strides and both base pointers are 16-byte aligned.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename T, bool VEC, int THREADS>
__device__ __forceinline__ void load_kv_tile(float* ks, float* vs, const T* kb, const T* vb,
                                             long long k_ss, long long v_ss, int row0,
                                             int rows, int S, int Dh) {
  constexpr int N = VEC ? Vec16<T>::N : 1;
  const int per_row = Dh / N;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int j = i / per_row, d0 = (i % per_row) * N, row = row0 + j;
    float kv[N], vv[N];
    if (row < S) {
      if constexpr (VEC) {
        Vec16<T>::load(kb + row * k_ss + d0, kv);
        Vec16<T>::load(vb + row * v_ss + d0, vv);
      } else {
        kv[0] = to_f32(kb[row * k_ss + d0]);
        vv[0] = to_f32(vb[row * v_ss + d0]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) kv[e] = vv[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      ks[j * (Dh + 1) + d0 + e] = kv[e];
      vs[j * Dh + d0 + e] = vv[e];
    }
  }
}

// Whether 16-byte loads are legal for these arrays (see load_kv_tile).
template <typename T>
static bool vec_ok(int Dh, const void* k, const void* v, const long long* strides, int n) {
  constexpr int N = 16 / sizeof(T);
  if (Dh % N || ((size_t)k % 16) || ((size_t)v % 16)) return false;
  for (int i = 0; i < n; ++i)
    if (strides[i] % N) return false;
  return true;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy into shared memory (at shared address dst);
// zero-filled, reading nothing, when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid = true) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
