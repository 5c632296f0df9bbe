// Decode attention for Hopper: one new query token per sequence against a
// KV cache, with grouped-query heads.
//
// Replaces the Pallas kernel decode_attention
// (src/repro/kernels/decode_attention.py, body _decode_kernel). One block
// per (batch row, KV head) covers the g = H / KV query heads that read that
// KV head, so each K/V byte leaves device memory once. The block walks the
// cache in tiles of BK slots staged in shared memory as f32 and carries the
// online softmax (m, l, acc) in f32, as the TPU kernel carried it across its
// sequential grid axis. The cache is read through strides, so the model's
// [B, T, KV, Dh] layout needs no transpose. A slot is visible iff
// 0 <= kv_pos <= q_pos (and q_pos - kv_pos < window when window > 0).
#include "common.cuh"

constexpr int BK = 64;        // cache slots per tile
constexpr int THREADS = 256;

template <typename T, bool VEC>
__global__ void decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ kv_pos,
                              const int* __restrict__ q_pos, T* __restrict__ out,
                              int H, int KV, int S, int Dh,
                              long long q_sb, long long q_sh,
                              long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss,
                              float scale, int window, float softcap) {
  extern __shared__ float smem[];
  const int g = H / KV;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = THREADS / 32;
  float* qs = smem;                     // [g][Dh]
  float* ks = qs + g * Dh;              // [BK][Dh + 1] (padded: no bank conflicts)
  float* vs = ks + BK * (Dh + 1);       // [BK][Dh]
  float* ps = vs + BK * Dh;             // [g][BK] logits, then probabilities
  float* acc = ps + g * BK;             // [g][Dh]
  float* m = acc + g * Dh;              // [g]
  float* l = m + g;                     // [g]
  float* corr = l + g;                  // [g]

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int qp = q_pos[b];
  for (int i = tid; i < g * Dh; i += THREADS) {
    const int qi = i / Dh, d = i % Dh;
    qs[i] = to_f32(q[b * q_sb + (long long)(kvh * g + qi) * q_sh + d]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += THREADS) {
    m[i] = MASKED;
    l[i] = 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += BK) {
    __syncthreads();  // previous tile fully consumed; init visible
    load_kv_tile<T, VEC, THREADS>(ks, vs, kb, vb, k_ss, v_ss, t0, BK, S, Dh);
    __syncthreads();
    for (int i = tid; i < g * BK; i += THREADS) {
      const int qi = i / BK, j = i % BK, slot = t0 + j;
      float s = -INFINITY;
      if (slot < S) {
        const float dot = dot_f32(qs + qi * Dh, ks + j * (Dh + 1), Dh, 1);
        const int kp = kv_pos[slot];
        bool ok = kp >= 0 && kp <= qp;
        if (window > 0) ok = ok && (qp - kp < window);
        s = attn_logit(dot, scale, softcap, ok);
      }
      ps[i] = s;
    }
    __syncthreads();
    for (int qi = warp; qi < g; qi += nwarps) {
      float* row = ps + qi * BK;
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_prev = m[qi];
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
        l[qi] = l[qi] * c + sum;
        m[qi] = m_new;
        corr[qi] = c;
      }
    }
    __syncthreads();
    for (int i = tid; i < g * Dh; i += THREADS) {
      const int qi = i / Dh, d = i % Dh;
      const float* pr = ps + qi * BK;
      acc[i] = acc[i] * corr[qi] + dot_f32(pr, vs + d, BK, Dh);
    }
  }
  __syncthreads();
  for (int i = tid; i < g * Dh; i += THREADS) {
    const int qi = i / Dh, d = i % Dh;
    const int h = kvh * g + qi;
    out[((long long)b * H + h) * Dh + d] = from_f32<T>(acc[i] / fmaxf(l[qi], 1e-30f));
  }
}

template <typename T, bool VEC>
static int launch_as(const void* q, const void* k, const void* v, const int* kv_pos,
                     const int* q_pos, void* out, int B, int H, int KV, int S, int Dh,
                     const long long* st, float scale, int window, float softcap,
                     cudaStream_t stream) {
  const int g = H / KV;
  const size_t smem = sizeof(float) *
      ((size_t)g * Dh + BK * (Dh + 1) + BK * Dh + g * BK + g * Dh + 3 * g);
  cudaError_t err = allow_smem(decode_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV, B);
  decode_kernel<T, VEC><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_pos, q_pos, (T*)out, H, KV, S, Dh,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, const int* kv_pos,
                  const int* q_pos, void* out, int B, int H, int KV, int S, int Dh,
                  const long long* st, float scale, int window, float softcap,
                  cudaStream_t stream) {
  // K/V strides only (st[2..7]): q is read scalar
  if (vec_ok<T>(Dh, k, v, st + 2, 6))
    return launch_as<T, true>(q, k, v, kv_pos, q_pos, out, B, H, KV, S, Dh, st, scale,
                              window, softcap, stream);
  return launch_as<T, false>(q, k, v, kv_pos, q_pos, out, B, H, KV, S, Dh, st, scale,
                             window, softcap, stream);
}

// strides (in elements): q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss; the
// head dimension is contiguous in q, k and v; out is contiguous [B, H, Dh].
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kv_pos, const void* q_pos, void* out,
                                      int B, int H, int KV, int S, int Dh,
                                      const long long* strides, float scale, int window,
                                      float softcap, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return launch<float>(q, k, v, (const int*)kv_pos, (const int*)q_pos, out, B, H, KV, S,
                         Dh, strides, scale, window, softcap, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, (const int*)kv_pos, (const int*)q_pos, out, B, H,
                                 KV, S, Dh, strides, scale, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
