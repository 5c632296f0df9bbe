// Prefill (flash) attention for Hopper: causal, grouped-query heads,
// optional sliding window and tanh softcap, f32 online softmax.
//
// Replaces the Pallas kernel flash_attention
// (src/repro/kernels/flash_attention.py, body _flash_kernel). One block per
// (query tile of BQ rows, head, batch row) walks the KV tiles it can see, so
// the [S, S] score matrix never reaches device memory. Under the causal mask
// the walk stops at the tile holding the block's last query row, and a
// window starts it at the first tile the window reaches: those tiles are
// fully masked for every row, and each row sees at least its own key, so
// skipping them changes no result (the TPU kernel computes them anyway).
// Ragged S is masked in the kernel: no divisibility requirement.
#include "common.cuh"

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;

template <typename T, bool VEC>
__global__ void flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out,
                             int H, int KV, int S, int Dh,
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
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed; init visible
    load_kv_tile<T, VEC, THREADS>(ks, vs, kb, vb, k_ss, v_ss, k0, BK, S, Dh);
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += THREADS) {
      const int r = i / BK, j = i % BK, qi = q0 + r, kj = k0 + j;
      float s = -INFINITY;
      if (kj < S) {
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
                     int KV, int S, int Dh, const long long* st, float scale, int causal,
                     int window, float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)BQ * Dh + BK * (Dh + 1) + BK * Dh + BQ * BK + BQ * Dh + 3 * BQ);
  cudaError_t err = allow_smem(flash_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, VEC><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, KV, S, Dh, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                  int KV, int S, int Dh, const long long* st, float scale, int causal,
                  int window, float softcap, cudaStream_t stream) {
  // K/V strides only (st[3..8]): q is read scalar
  if (vec_ok<T>(Dh, k, v, st + 3, 6))
    return launch_as<T, true>(q, k, v, out, B, H, KV, S, Dh, st, scale, causal, window,
                              softcap, stream);
  return launch_as<T, false>(q, k, v, out, B, H, KV, S, Dh, st, scale, causal, window,
                             softcap, stream);
}

// strides (in elements): q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
// the head dimension is contiguous in q, k and v; out is contiguous
// [B, H, S, Dh].
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int B, int H, int KV, int S, int Dh,
                                     const long long* strides, float scale, int causal,
                                     int window, float softcap, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return launch<float>(q, k, v, out, B, H, KV, S, Dh, strides, scale, causal, window,
                         softcap, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, out, B, H, KV, S, Dh, strides, scale, causal,
                                 window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
