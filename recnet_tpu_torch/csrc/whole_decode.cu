// Greedy whole-decode kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels whole_greedy_decode (K1) and
// whole_greedy_decode_segment (K2) of recnet_tpu/ops/pallas/whole_decode.py
// (step body _make_step). One launch runs n_steps greedy steps for the whole
// batch from a carried state (h, c, token): K1 calls it with a zero state,
// <SOS> and n_steps = T; K2 with the carried state and seg_len.
//
// Each step, per batch row: gather the embedding row of the current token
// (times embedding_scale), unnormalised additive attention over the encoder
// features (score_f = w . tanh(W h + uv_f + b), ctx = sum_f score_f enc_f / L),
// a GRU (r,z,n) or LSTM (i,f,g,o) cell, logits = h' @ out_w + out_b in f32,
// and the first index of the maximum under the order-preserving int key of
// the logits (the Pallas kernel's argmax, which orders -0.0 < +0.0).
// Casts sit where _make_step has them: every product reads dtype operands
// and accumulates in f32; ctx is cast to dtype before its gate product;
// h (and the LSTM c) are computed in f32 and stored in dtype.
//
// What bounds it. On the TPU the ~16 MB of bf16 weights and an ~11 MB encoder
// tile sit in VMEM for the whole loop. A Hopper block has 227 KB of shared
// memory, so here the weights stay in the 50 MB L2 and every block streams
// them from L2 on every step: about 12 MB per block per step at the flagship
// width (w_ih 6.2 MB, out_w 4.3 MB, w_hh 1.6 MB in bf16). Each of those
// weights feeds 8 f32 FMAs on CUDA cores (about 48 M per block per step), so
// the CUDA cores' FMA rate and the latency of the L2 loads bound it; the L2
// bandwidth does not (PERF.md has the measured split by phase).
//
// What the design does about that. A block owns TB = 8 batch rows and runs
// every step for them (greedy rows are independent, so blocks never sync).
// Each weight element read from L2 feeds TB = 8 FMAs, one per row; the row
// vectors (x = [emb, ctx], h) live in shared memory as [k][TB] f32, so one
// weight load pairs with two broadcast 16-byte shared loads. 16 warps and
// k loops unrolled 8 deep keep many L2 loads in flight. A thread owns one
// hidden unit j across all gates, so the cell runs in registers with no
// gate buffer. The argmax is a running (max key, first index) per thread,
// then a warp-shuffle and a cross-warp reduction. Rows past B are masked.
// Next steps (later work): bf16 products on tensor cores (mma.sync
// m16n8k16, with the 8 rows as N), TMA, and weights kept resident across a
// cluster's shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int TB = 8;          // batch rows per block
// 16 warps and 8 loads in flight per k loop keep enough L2 requests
// outstanding; at 512 threads the registers stay under 128 with no spills
constexpr int THREADS = 512;
constexpr int UNROLL = 8;
constexpr int NWARPS = THREADS / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// f32 value rounded to the storage type, kept in f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// order-preserving f32 -> int32 key (whole_decode.py:251-252)
__device__ __forceinline__ int order_key(float x) {
  int bits = __float_as_int(x);
  return bits ^ ((bits >> 31) & 0x7FFFFFFF);
}

// the TB row values of column k of a [k][TB] shared-memory matrix
__device__ __forceinline__ void load_rows(const float* p, float v[TB]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ bool key_wins(int k, int i, int bk, int bi) {
  return k > bk || (k == bk && i < bi);
}

size_t smem_bytes(int L, int F, int A, int E, int H) {
  const size_t floats = (size_t)(E + F) * TB   // x = [emb, ctx]
                        + 2 * (size_t)H * TB   // h, double-buffered
                        + (size_t)H * TB       // c
                        + (size_t)TB * A       // W h
                        + (size_t)TB * L;      // scores
  const size_t ints = 2 * (size_t)NWARPS * TB + TB;
  return floats * sizeof(float) + ints * sizeof(int);
}

template <typename T, int NG>
__global__ void __launch_bounds__(THREADS)
whole_decode_kernel(const T* __restrict__ enc, const T* __restrict__ uv,
                    const T* __restrict__ emb, const T* __restrict__ attn_W,
                    const T* __restrict__ attn_w, const T* __restrict__ attn_b,
                    const T* __restrict__ w_ih, const T* __restrict__ w_hh,
                    const T* __restrict__ bias2, const T* __restrict__ out_w,
                    const T* __restrict__ out_b, const T* __restrict__ h0,
                    const T* __restrict__ c0, const int* __restrict__ tok0,
                    int* __restrict__ tokens, T* __restrict__ h_out,
                    T* __restrict__ c_out, int* __restrict__ tok_out,
                    int B, int L, int F, int A, int E, int H, int V,
                    int n_steps, float emb_scale) {
  extern __shared__ float4 smem_f4[];
  const int K = E + F;
  const int G = NG * H;
  float* x_s = reinterpret_cast<float*>(smem_f4);  // [K][TB]
  float* h_s = x_s + (size_t)K * TB;               // [2][H][TB]
  float* c_s = h_s + 2 * (size_t)H * TB;           // [H][TB]
  float* wh_s = c_s + (size_t)H * TB;              // [TB][A]
  float* sc_s = wh_s + (size_t)TB * A;             // [TB][L]
  int* red_key = reinterpret_cast<int*>(sc_s + (size_t)TB * L);
  int* red_idx = red_key + NWARPS * TB;            // [NWARPS][TB]
  int* tok_s = red_idx + NWARPS * TB;              // [TB]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TB;

  for (int i = tid; i < TB * H; i += THREADS) {
    const int b = i / H, j = i % H, row = row0 + b;
    const bool ok = row < B;
    h_s[j * TB + b] = ok ? to_f(h0[(size_t)row * H + j]) : 0.f;
    c_s[j * TB + b] = ok ? to_f(c0[(size_t)row * H + j]) : 0.f;
  }
  if (tid < TB) tok_s[tid] = row0 + tid < B ? tok0[row0 + tid] : 0;
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < n_steps; ++t) {
    const float* h_cur = h_s + (size_t)cur * H * TB;
    float* h_nxt = h_s + (size_t)(cur ^ 1) * H * TB;

    // 1. embedding row of the current token: an exact row read (equal to
    //    the Pallas one-hot product), times the scale, in dtype
    for (int i = tid; i < TB * E; i += THREADS) {
      const int b = i / E, k = i % E;
      x_s[k * TB + b] =
          round_to<T>(to_f(emb[(size_t)tok_s[b] * E + k]) * emb_scale);
    }
    // 2. W h (TB x A), f32 accumulate
    for (int a = tid; a < A; a += THREADS) {
      float acc[TB] = {};
#pragma unroll UNROLL
      for (int k = 0; k < H; ++k) {
        float hv[TB];
        load_rows(h_cur + k * TB, hv);
        const float w = to_f(attn_W[(size_t)k * A + a]);
#pragma unroll
        for (int b = 0; b < TB; ++b) acc[b] += hv[b] * w;
      }
#pragma unroll
      for (int b = 0; b < TB; ++b) wh_s[b * A + a] = acc[b];
    }
    __syncthreads();

    // 3. scores: one warp per (row, frame)
    for (int p = warp; p < TB * L; p += NWARPS) {
      const int b = p / L, f = p % L, row = row0 + b;
      float s = 0.f;
      if (row < B) {
        const T* uvp = uv + ((size_t)row * L + f) * A;
        for (int a = lane; a < A; a += 32)
          s += tanhf(wh_s[b * A + a] + to_f(uvp[a]) + to_f(attn_b[a])) *
               to_f(attn_w[a]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) sc_s[b * L + f] = s;
    }
    __syncthreads();

    // 4. ctx = sum_f score_f enc_f / L in f32, then cast to dtype
    for (int i = tid; i < TB * F; i += THREADS) {
      const int b = i / F, e = i % F, row = row0 + b;
      float acc = 0.f;
      if (row < B) {
        const T* ep = enc + (size_t)row * L * F + e;
#pragma unroll 4
        for (int f = 0; f < L; ++f)
          acc += sc_s[b * L + f] * to_f(ep[(size_t)f * F]);
      }
      x_s[(E + e) * TB + b] = round_to<T>(acc / (float)L);
    }
    __syncthreads();

    // 5. gates and cell: thread owns hidden unit j in every gate
    for (int j = tid; j < H; j += THREADS) {
      float gi[NG][TB] = {}, gh[NG][TB] = {};
#pragma unroll UNROLL
      for (int k = 0; k < K; ++k) {
        float xv[TB];
        load_rows(x_s + k * TB, xv);
        const T* wr = w_ih + (size_t)k * G + j;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float w = to_f(wr[g * H]);
#pragma unroll
          for (int b = 0; b < TB; ++b) gi[g][b] += xv[b] * w;
        }
      }
#pragma unroll UNROLL
      for (int k = 0; k < H; ++k) {
        float hv[TB];
        load_rows(h_cur + k * TB, hv);
        const T* wr = w_hh + (size_t)k * G + j;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float w = to_f(wr[g * H]);
#pragma unroll
          for (int b = 0; b < TB; ++b) gh[g][b] += hv[b] * w;
        }
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float bi = to_f(bias2[g * H + j]);
        const float bh = to_f(bias2[G + g * H + j]);
#pragma unroll
        for (int b = 0; b < TB; ++b) {
          gi[g][b] += bi;
          gh[g][b] += bh;
        }
      }
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        if constexpr (NG == 3) {  // GRU
          const float r = sigmoid(gi[0][b] + gh[0][b]);
          const float z = sigmoid(gi[1][b] + gh[1][b]);
          const float n = tanhf(gi[2][b] + r * gh[2][b]);
          h_nxt[j * TB + b] =
              round_to<T>((1.0f - z) * n + z * h_cur[j * TB + b]);
        } else {        // LSTM
          const float ig = sigmoid(gi[0][b] + gh[0][b]);
          const float fg = sigmoid(gi[1][b] + gh[1][b]);
          const float gg = tanhf(gi[2][b] + gh[2][b]);
          const float og = sigmoid(gi[3][b] + gh[3][b]);
          const float c = fg * c_s[j * TB + b] + ig * gg;
          h_nxt[j * TB + b] = round_to<T>(og * tanhf(c));
          c_s[j * TB + b] = round_to<T>(c);
        }
      }
    }
    __syncthreads();

    // 6. logits in f32 and the first index of the max key, per row
    int best_key[TB], best_idx[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      best_key[b] = INT_MIN;
      best_idx[b] = INT_MAX;
    }
    for (int v = tid; v < V; v += THREADS) {
      float acc[TB] = {};
#pragma unroll UNROLL
      for (int k = 0; k < H; ++k) {
        float hv[TB];
        load_rows(h_nxt + k * TB, hv);
        const float w = to_f(out_w[(size_t)k * V + v]);
#pragma unroll
        for (int b = 0; b < TB; ++b) acc[b] += hv[b] * w;
      }
      const float bv = to_f(out_b[v]);
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const int key = order_key(acc[b] + bv);
        if (key_wins(key, v, best_key[b], best_idx[b])) {
          best_key[b] = key;
          best_idx[b] = v;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      int k = best_key[b], i = best_idx[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int k2 = __shfl_down_sync(0xffffffffu, k, off);
        const int i2 = __shfl_down_sync(0xffffffffu, i, off);
        if (key_wins(k2, i2, k, i)) {
          k = k2;
          i = i2;
        }
      }
      if (lane == 0) {
        red_key[warp * TB + b] = k;
        red_idx[warp * TB + b] = i;
      }
    }
    __syncthreads();
    if (tid < TB) {
      int k = red_key[tid], i = red_idx[tid];
      for (int w = 1; w < NWARPS; ++w) {
        if (key_wins(red_key[w * TB + tid], red_idx[w * TB + tid], k, i)) {
          k = red_key[w * TB + tid];
          i = red_idx[w * TB + tid];
        }
      }
      tok_s[tid] = i;
      if (row0 + tid < B) tokens[(size_t)(row0 + tid) * n_steps + t] = i;
    }
    __syncthreads();
    cur ^= 1;
  }

  const float* h_fin = h_s + (size_t)cur * H * TB;
  for (int i = tid; i < TB * H; i += THREADS) {
    const int b = i / H, j = i % H, row = row0 + b;
    if (row < B) {
      h_out[(size_t)row * H + j] = from_f<T>(h_fin[j * TB + b]);
      c_out[(size_t)row * H + j] = from_f<T>(c_s[j * TB + b]);
    }
  }
  if (tid < TB && row0 + tid < B) tok_out[row0 + tid] = tok_s[tid];
}

template <typename T, int NG>
int launch(const void* enc, const void* uv, const void* emb,
           const void* attn_W, const void* attn_w, const void* attn_b,
           const void* w_ih, const void* w_hh, const void* bias2,
           const void* out_w, const void* out_b, const void* h0,
           const void* c0, const int* tok0, int* tokens, void* h_out,
           void* c_out, int* tok_out, int B, int L, int F, int A, int E,
           int H, int V, int n_steps, float emb_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, F, A, E, H);
  auto kernel = whole_decode_kernel<T, NG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TB - 1) / TB);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)enc, (const T*)uv, (const T*)emb, (const T*)attn_W,
      (const T*)attn_w, (const T*)attn_b, (const T*)w_ih, (const T*)w_hh,
      (const T*)bias2, (const T*)out_w, (const T*)out_b, (const T*)h0,
      (const T*)c0, tok0, tokens, (T*)h_out, (T*)c_out, tok_out, B, L, F, A,
      E, H, V, n_steps, emb_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* recnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16; n_gates: 3 = GRU, 4 = LSTM.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int recnet_whole_decode(int dtype, int n_gates, const void* enc,
                        const void* uv, const void* emb, const void* attn_W,
                        const void* attn_w, const void* attn_b,
                        const void* w_ih, const void* w_hh, const void* bias2,
                        const void* out_w, const void* out_b, const void* h0,
                        const void* c0, const int* tok0, int* tokens,
                        void* h_out, void* c_out, int* tok_out, int B, int L,
                        int F, int A, int E, int H, int V, int n_steps,
                        float emb_scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define RECNET_LAUNCH(T, NG)                                                  \
  launch<T, NG>(enc, uv, emb, attn_W, attn_w, attn_b, w_ih, w_hh, bias2,     \
                out_w, out_b, h0, c0, tok0, tokens, h_out, c_out, tok_out, B, \
                L, F, A, E, H, V, n_steps, emb_scale, s)
  if (dtype == 0 && n_gates == 3) return RECNET_LAUNCH(float, 3);
  if (dtype == 0 && n_gates == 4) return RECNET_LAUNCH(float, 4);
  if (dtype == 1 && n_gates == 3) return RECNET_LAUNCH(__nv_bfloat16, 3);
  if (dtype == 1 && n_gates == 4) return RECNET_LAUNCH(__nv_bfloat16, 4);
#undef RECNET_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
