// Decode attention for Hopper: one new query token per sequence against a
// KV cache, with grouped-query heads, split across the SMs.
//
// Replaces the Pallas kernel decode_attention
// (src/repro/kernels/decode_attention.py, body _decode_kernel), which walks
// the cache's KV blocks in sequence and carries the online softmax
// (m, l, acc) across them in f32.
//
// What bounds it on the H100: bytes. Every visible slot's K and V is read
// once and used for about 4 operations a byte (g query heads share it), far
// below the ~295 operations a byte at which the tensor cores would become
// the limit. At decode batch sizes the cache is small (1.6 MB at the smollm
// path's B 4, KV 3, 513 slots), so what costs time is latency: one block per
// (batch row, KV head) would leave most of the 132 SMs idle, each walking
// its whole cache alone.
//
// The design: two launches.
// - decode_split_kernel, grid (n_split, KV, B): each block takes one chunk
//   of `chunk` slots for the g query heads of its KV head. Its threads copy
//   the chunk's K and V rows into shared memory at once, as 16-byte
//   cp.async copies (scalar loads when the strides or bases are not 16-byte
//   aligned), kept in the IO type; the logits take a group of lanes per
//   slot reduced by shuffles; the block writes its per-head partials
//   (m, l, acc[Dh]) in f32 to a workspace the wrapper allocates. The wrapper
//   picks n_split (decode_split) so that B x KV x n_split fills the card,
//   and never lets a split start at or past S: a split of only such slots
//   would carry m = -inf into the merge.
// - decode_combine_kernel, grid (H, B): m = max m_i, l = sum l_i e^(m_i - m),
//   out = sum acc_i e^(m_i - m) / max(l, 1e-30), in the IO type.
// Masked logits are -1e30, as in Pallas: a split whose visible slots are
// all masked carries m = -1e30 and l = its slot count, so a query that sees
// no slot at all gets the mean of V over all S slots, as the TPU kernel
// gives it. The cache is read through strides, so the model's
// [B, T, KV, Dh] layout needs no transpose. A slot is visible iff
// 0 <= kv_pos <= q_pos (and q_pos - kv_pos < window when window > 0).
#include "common.cuh"

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;

// Workspace (f32): m [P], l [P], acc [P, Dh] for P = B x H x n_split
// partials, partial index (b x H + h) x n_split + split.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kv_pos,
                        const int* __restrict__ q_pos, float* __restrict__ ws, int H, int KV,
                        int S, int Dh, int chunk, long long q_sb, long long q_sh,
                        long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                        long long v_sh, long long v_ss, float scale, int window,
                        float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = H / KV, n_split = gridDim.x;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = split * chunk, rows = min(chunk, S - t0);   // rows >= 1
  T* ks = reinterpret_cast<T*>(smem);                  // [chunk][Dh]
  T* vs = ks + chunk * Dh;                             // [chunk][Dh]
  float* qs = reinterpret_cast<float*>(vs + chunk * Dh);   // [g][Dh]
  float* ps = qs + g * Dh;                             // [g][chunk]
  int* kps = reinterpret_cast<int*>(ps + g * chunk);   // [chunk] kv_pos

  const T* kb = k + b * k_sb + kvh * k_sh + t0 * k_ss;
  const T* vb = v + b * v_sb + kvh * v_sh + t0 * v_ss;
  if constexpr (VEC) {
    constexpr int N = 16 / sizeof(T);
    const int per_row = Dh / N;
    for (int i = tid; i < rows * per_row; i += THREADS) {
      const int j = i / per_row, d = (i % per_row) * N;
      cp_async16(smem_u32(ks + j * Dh + d), kb + j * k_ss + d);
      cp_async16(smem_u32(vs + j * Dh + d), vb + j * v_ss + d);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < rows * Dh; i += THREADS) {
      const int j = i / Dh, d = i % Dh;
      ks[i] = kb[j * k_ss + d];
      vs[i] = vb[j * v_ss + d];
    }
  }
  for (int i = tid; i < g * Dh; i += THREADS)   // while the copies fly
    qs[i] = to_f32(q[b * q_sb + (long long)(kvh * g + i / Dh) * q_sh + i % Dh]);
  for (int j = tid; j < rows; j += THREADS) kps[j] = kv_pos[t0 + j];
  const int qp = q_pos[b];
  if constexpr (VEC) cp_async_wait<0>();
  __syncthreads();

  // logits: lps lanes per slot (a power of two covering Dh / 8), lane sub
  // of a slot reading elements sub, sub + lps, ...; every lane of the warp
  // takes part in the shuffles, lanes past the chunk with zeros
  int lps = 1;
  while (lps < 32 && lps * 8 < Dh) lps <<= 1;
  const int spw = 32 / lps, sub = lane % lps;
  for (int j0 = warp * spw; j0 < rows; j0 += NWARPS * spw) {
    const int j = j0 + lane / lps;
    const bool live = j < rows;
    bool ok = false;
    if (live) {
      const int kp = kps[j];
      ok = kp >= 0 && kp <= qp;
      if (window > 0) ok = ok && (qp - kp < window);
    }
    for (int hh = 0; hh < g; ++hh) {
      float part = 0.f;
      if (live)
        for (int d = sub; d < Dh; d += lps)
          part = fmaf(qs[hh * Dh + d], to_f32(ks[j * Dh + d]), part);
      for (int o = lps >> 1; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (live && sub == 0) ps[hh * chunk + j] = attn_logit(part, scale, softcap, ok);
    }
  }
  __syncthreads();

  // per head: the chunk's max and sum; p overwrites the logits
  const long long P = (long long)gridDim.z * H * n_split;
  for (int hh = warp; hh < g; hh += NWARPS) {
    float* row = ps + hh * chunk;
    float mx = MASKED;
    for (int j = lane; j < rows; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < rows; j += 32) {
      const float p = expf(row[j] - mx);
      row[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const long long pi = ((long long)b * H + kvh * g + hh) * n_split + split;
      ws[pi] = mx;
      ws[P + pi] = sum;
    }
  }
  __syncthreads();

  // acc[h][d] = sum_j p[h][j] v[j][d]
  for (int i = tid; i < g * Dh; i += THREADS) {
    const int hh = i / Dh, d = i % Dh;
    const float* pr = ps + hh * chunk;
    float a = 0.f;
    for (int j = 0; j < rows; ++j) a = fmaf(pr[j], to_f32(vs[j * Dh + d]), a);
    const long long pi = ((long long)b * H + kvh * g + hh) * n_split + split;
    ws[2 * P + pi * Dh + d] = a;
  }
}

constexpr int COMBINE_THREADS = 128;

// Block-wide max (is_max) or sum of v over COMBINE_THREADS threads.
__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  v = is_max ? warp_max(v) : warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < COMBINE_THREADS / 32; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();   // red is free again
  return r;
}

template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
    decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int H, int Dh,
                          int n_split) {
  extern __shared__ float wt[];                 // [n_split] e^(m_i - m)
  __shared__ float red[COMBINE_THREADS / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long P = (long long)gridDim.y * H * n_split;
  const long long p0 = ((long long)b * H + h) * n_split;
  const float* m = ws + p0;
  const float* l = ws + P + p0;
  const float* acc = ws + 2 * P + p0 * Dh;
  float mx = -INFINITY;
  for (int i = tid; i < n_split; i += COMBINE_THREADS) mx = fmaxf(mx, m[i]);
  mx = block_reduce(mx, red, true);
  float den = 0.f;
  for (int i = tid; i < n_split; i += COMBINE_THREADS) {
    const float w = expf(m[i] - mx);
    wt[i] = w;
    den += l[i] * w;
  }
  den = fmaxf(block_reduce(den, red, false), 1e-30f);   // also publishes wt
  for (int d = tid; d < Dh; d += COMBINE_THREADS) {
    float a = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_split; ++i) a = fmaf(acc[(long long)i * Dh + d], wt[i], a);
    out[((long long)b * H + h) * Dh + d] = from_f32<T>(a / den);
  }
}

template <typename T, bool VEC>
static int launch_as(const void* q, const void* k, const void* v, const int* kv_pos,
                     const int* q_pos, void* out, float* ws, int B, int H, int KV, int S,
                     int Dh, int chunk, int n_split, const long long* st, float scale,
                     int window, float softcap, cudaStream_t stream) {
  const int g = H / KV;
  const size_t smem = 2 * sizeof(T) * (size_t)chunk * Dh +
                      sizeof(float) * (size_t)g * (Dh + chunk) + sizeof(int) * chunk;
  cudaError_t err = allow_smem(decode_split_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  decode_split_kernel<T, VEC><<<dim3(n_split, KV, B), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_pos, q_pos, ws, H, KV, S, Dh, chunk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t wt = sizeof(float) * n_split;
  err = allow_smem(decode_combine_kernel<T>, wt);
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<dim3(H, B), COMBINE_THREADS, wt, stream>>>(ws, (T*)out, H, Dh,
                                                                        n_split);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, const int* kv_pos,
                  const int* q_pos, void* out, float* ws, int B, int H, int KV, int S, int Dh,
                  int chunk, int n_split, const long long* st, float scale, int window,
                  float softcap, cudaStream_t stream) {
  // K/V strides only (st[2..7]): q is read scalar
  if (vec_ok<T>(Dh, k, v, st + 2, 6))
    return launch_as<T, true>(q, k, v, kv_pos, q_pos, out, ws, B, H, KV, S, Dh, chunk,
                              n_split, st, scale, window, softcap, stream);
  return launch_as<T, false>(q, k, v, kv_pos, q_pos, out, ws, B, H, KV, S, Dh, chunk,
                             n_split, st, scale, window, softcap, stream);
}

// strides (in elements): q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss; the
// head dimension is contiguous in q, k and v; out is contiguous [B, H, Dh];
// ws holds B x H x n_split x (Dh + 2) floats. Every split must start before
// S: (n_split - 1) x chunk < S <= n_split x chunk.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kv_pos, const void* q_pos, void* out,
                                      void* ws, int B, int H, int KV, int S, int Dh,
                                      const long long* strides, float scale, int window,
                                      float softcap, int chunk, int n_split, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (KV <= 0 || H % KV != 0 || chunk <= 0 || n_split <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)(n_split - 1) * chunk >= S || (long long)n_split * chunk < S)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return launch<float>(q, k, v, (const int*)kv_pos, (const int*)q_pos, out, (float*)ws, B,
                         H, KV, S, Dh, chunk, n_split, strides, scale, window, softcap, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, (const int*)kv_pos, (const int*)q_pos, out,
                                 (float*)ws, B, H, KV, S, Dh, chunk, n_split, strides, scale,
                                 window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
