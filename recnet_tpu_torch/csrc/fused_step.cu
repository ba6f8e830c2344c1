// Fused attention + GRU decoder step for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_gru_attn_step (K4) of
// recnet_tpu/ops/pallas/fused_step.py (_kernel). One launch runs one GRU
// decoder step for the whole batch: per row,
//   wh = h W (f32 accumulate), score_f = w . tanh(wh + uv_f + b),
//   ctx = sum over chunks of frame_chunk frames of (sum_f score_f enc_f),
//   ctx / L cast to dtype, gates [emb, ctx] W_ih + b_ih and h W_hh + b_hh,
//   r, z, n and h' = (1 - z) n + z h computed in f32 and stored in dtype.
// The vocab projection and the argmax stay with the caller, as on the TPU.
// The chunked ctx sum keeps the Pallas grid's order: each chunk's frames
// are summed from zero and the chunk's sum added to the running ctx.
//
// What bounds it. On the TPU the weights (about 8 MB in bf16: w_ih 6.2 MB,
// w_hh 1.6 MB, W 0.1 MB) sit in VMEM for the call while enc streams one
// frame chunk at a time. Here the weights stay in the 50 MB L2 and every
// block streams all of them once per launch; each weight element feeds
// TB = 8 f32 FMAs on CUDA cores, so the FMA rate and the latency of the L2
// loads bound it, as in the whole-decode kernel (whole_decode.cu), whose
// plan this is without the embedding gather and the projection.
//
// What the design does about that. A block owns TB = 8 batch rows; the row
// vectors (x = [emb, ctx], h) live in shared memory as [k][TB] f32 (about
// 85 KB at the flagship width), so one weight load pairs with two
// broadcast 16-byte shared loads. 16 warps and k loops unrolled 8 deep keep
// many L2 loads in flight. A thread owns one hidden unit j across the three
// gates, so the cell runs in registers. Rows past B are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>

#include "decode_common.cuh"

namespace {

using recnet::from_f;
using recnet::load_rows;
using recnet::round_to;
using recnet::sigmoid;
using recnet::to_f;

constexpr int TB = 8;          // batch rows per block
constexpr int THREADS = 512;
constexpr int UNROLL = 8;
constexpr int NWARPS = THREADS / 32;

size_t smem_bytes(int L, int F, int A, int E, int H) {
  return ((size_t)(E + F) * TB   // x = [emb, ctx]
          + (size_t)H * TB       // h
          + (size_t)TB * A       // W h
          + (size_t)TB * L)      // scores
         * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_step_kernel(const T* __restrict__ emb, const T* __restrict__ h,
                  const T* __restrict__ enc, const T* __restrict__ uv,
                  const T* __restrict__ attn_W, const T* __restrict__ attn_w,
                  const T* __restrict__ attn_b, const T* __restrict__ w_ih,
                  const T* __restrict__ w_hh, const T* __restrict__ bias3,
                  T* __restrict__ h_out, int B, int L, int F, int A, int E,
                  int H, int frame_chunk) {
  extern __shared__ float4 smem_f4[];
  const int K = E + F;
  const int G = 3 * H;
  float* x_s = reinterpret_cast<float*>(smem_f4);  // [K][TB]
  float* h_s = x_s + (size_t)K * TB;               // [H][TB]
  float* wh_s = h_s + (size_t)H * TB;              // [TB][A]
  float* sc_s = wh_s + (size_t)TB * A;             // [TB][L]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TB;

  // 0. the rows of emb and h, in f32 (exact)
  for (int i = tid; i < TB * E; i += THREADS) {
    const int b = i / E, k = i % E, row = row0 + b;
    x_s[k * TB + b] = row < B ? to_f(emb[(size_t)row * E + k]) : 0.f;
  }
  for (int i = tid; i < TB * H; i += THREADS) {
    const int b = i / H, j = i % H, row = row0 + b;
    h_s[j * TB + b] = row < B ? to_f(h[(size_t)row * H + j]) : 0.f;
  }
  __syncthreads();

  // 1. W h (TB x A), f32 accumulate
  for (int a = tid; a < A; a += THREADS) {
    float acc[TB] = {};
#pragma unroll UNROLL
    for (int k = 0; k < H; ++k) {
      float hv[TB];
      load_rows<TB>(h_s + k * TB, hv);
      const float w = to_f(attn_W[(size_t)k * A + a]);
#pragma unroll
      for (int b = 0; b < TB; ++b) acc[b] += hv[b] * w;
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) wh_s[b * A + a] = acc[b];
  }
  __syncthreads();

  // 2. scores: one warp per (row, frame)
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

  // 3. ctx in chunks of frame_chunk frames, / L, cast to dtype
  for (int i = tid; i < TB * F; i += THREADS) {
    const int b = i / F, e = i % F, row = row0 + b;
    float ctx = 0.f, acc = 0.f;
    if (row < B) {
      const T* ep = enc + (size_t)row * L * F + e;
      int left = frame_chunk;          // frames left in the current chunk
      // one flat loop, unrolled so that 4 enc loads are in flight
#pragma unroll 4
      for (int f = 0; f < L; ++f) {
        acc += sc_s[b * L + f] * to_f(ep[(size_t)f * F]);
        if (--left == 0) {             // the chunk's sum joins ctx
          ctx += acc;
          acc = 0.f;
          left = frame_chunk;
        }
      }
    }
    x_s[(E + e) * TB + b] = round_to<T>(ctx / (float)L);
  }
  __syncthreads();

  // 4. gates and the GRU cell: thread owns hidden unit j in r, z, n
  for (int j = tid; j < H; j += THREADS) {
    float gi[3][TB] = {}, gh[3][TB] = {};
#pragma unroll UNROLL
    for (int k = 0; k < K; ++k) {
      float xv[TB];
      load_rows<TB>(x_s + k * TB, xv);
      const T* wr = w_ih + (size_t)k * G + j;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float w = to_f(wr[g * H]);
#pragma unroll
        for (int b = 0; b < TB; ++b) gi[g][b] += xv[b] * w;
      }
    }
#pragma unroll UNROLL
    for (int k = 0; k < H; ++k) {
      float hv[TB];
      load_rows<TB>(h_s + k * TB, hv);
      const T* wr = w_hh + (size_t)k * G + j;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float w = to_f(wr[g * H]);
#pragma unroll
        for (int b = 0; b < TB; ++b) gh[g][b] += hv[b] * w;
      }
    }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float bi = to_f(bias3[g * H + j]);
      const float bh = to_f(bias3[G + g * H + j]);
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        gi[g][b] += bi;
        gh[g][b] += bh;
      }
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const int row = row0 + b;
      const float r = sigmoid(gi[0][b] + gh[0][b]);
      const float z = sigmoid(gi[1][b] + gh[1][b]);
      const float n = tanhf(gi[2][b] + r * gh[2][b]);
      if (row < B)
        h_out[(size_t)row * H + j] =
            from_f<T>((1.0f - z) * n + z * h_s[j * TB + b]);
    }
  }
}

template <typename T>
int launch(const void* emb, const void* h, const void* enc, const void* uv,
           const void* attn_W, const void* attn_w, const void* attn_b,
           const void* w_ih, const void* w_hh, const void* bias3,
           void* h_out, int B, int L, int F, int A, int E, int H,
           int frame_chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, F, A, E, H);
  auto kernel = fused_step_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TB - 1) / TB);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)emb, (const T*)h, (const T*)enc, (const T*)uv,
      (const T*)attn_W, (const T*)attn_w, (const T*)attn_b, (const T*)w_ih,
      (const T*)w_hh, (const T*)bias3, (T*)h_out, B, L, F, A, E, H,
      frame_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* recnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. L must divide by frame_chunk (the
// wrapper checks). Launches on `stream` and returns cudaGetLastError().
int recnet_fused_step(int dtype, const void* emb, const void* h,
                      const void* enc, const void* uv, const void* attn_W,
                      const void* attn_w, const void* attn_b,
                      const void* w_ih, const void* w_hh, const void* bias3,
                      void* h_out, int B, int L, int F, int A, int E, int H,
                      int frame_chunk, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (frame_chunk < 1 || L % frame_chunk != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(emb, h, enc, uv, attn_W, attn_w, attn_b, w_ih, w_hh,
                         bias3, h_out, B, L, F, A, E, H, frame_chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(emb, h, enc, uv, attn_W, attn_w, attn_b,
                                 w_ih, w_hh, bias3, h_out, B, L, F, A, E, H,
                                 frame_chunk, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
