// Fused attention + GRU decoder step for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_gru_attn_step (K4) of
// recnet_tpu/ops/pallas/fused_step.py (_kernel). One call runs one GRU
// decoder step for the whole batch: per row,
//   wh = h W (f32 accumulate), score_f = w . tanh(wh + uv_f + b),
//   ctx = sum over chunks of frame_chunk frames of (sum_f score_f enc_f),
//   ctx / L cast to dtype, gates [emb, ctx] W_ih + b_ih and h W_hh + b_hh,
//   r, z, n and h' = (1 - z) n + z h computed in f32 and stored in dtype.
// The vocab projection and the argmax stay with the caller, as on the TPU.
// The chunked ctx sum keeps the Pallas grid's order: each chunk's frames
// are summed from zero and the chunk's sum added to the running ctx.
//
// On the TPU the weights (about 8 MB in bf16: w_ih 6.2 MB, w_hh 1.6 MB, W
// 0.1 MB) sit in VMEM for the call while enc streams one frame chunk at a
// time. Three bodies share this file; the wrapper picks one by dtype and
// shape (ops/cuda/fused_step.py step_body).
//
// * The tensor-core route (bf16, H a multiple of 16): two kernels.
//   What bounds it. K4 is one step, so nothing carries over inside the
//   call and the gate product is an ordinary GEMM, [emb, ctx, h] (B x
//   (E + F + H)) times [w_ih; w_hh] ((E + F + H) x 3H): 7.9 GFLOP at the
//   flagship width and B = 1024, 8 us at the bf16 tensor-core peak. What
//   is left is per row and bounded by device memory: enc (B L F, 88 MB)
//   and uv (7.3 MB), 0.03 ms at the HBM rate, which is the call's bound.
//   What the design does about that.
//   - Kernel A, the attention pass (attn_pass_kernel): RA = 4 rows a block
//     (256 blocks at B = 1024, two an SM). W h on CUDA cores from 8-byte
//     loads of W, 16 rows of W in flight a thread (a load feeds 16 FMAs);
//     the scores a warp 8 (row, frame) items at a time, all their uv loads
//     in flight before the first tanh; then ctx from 16-byte streaming
//     loads of enc (8 features a thread, 7 frames in flight). A loop whose
//     loads sit between their uses and a branch issues them one after
//     another, so every phase loads first and computes after. It writes
//     each row's GEMM operand X = [emb, ctx / L in bf16, zero pad, h] to a
//     scratch tensor, the columns laid out as layout.gate_tiles lays out
//     the weights' rows. What is left above the bound: every block reads
//     all of W (128 KB, 33.5 MB a call from L2), and W h and the scores
//     run before the block's enc stream starts.
//   - Kernel B, the gate GEMM (gate_gemm_kernel): a block owns BM = 64
//     rows x UT = 4 unit tiles of 16 units x all three gates (128 blocks
//     at the flagship width, one wave), so each weight tile is read B / BM
//     times from L2 instead of once per 8 rows. The gate tiles come in the
//     layout [unit tile][k16 step][gate][16 inputs][16 units] (made once
//     per parameter set), so a k16 step of a unit tile's three gates is
//     1536 contiguous bytes. A ring of 4 stages of 2 k16 steps brings the
//     X tiles (64 x 16) and weight tiles to shared memory by cp.async;
//     each thread's copy addresses are computed once, before the k loop
//     (recomputed every step, their divisions and bounds tests took as
//     long as the products). ldmatrix (X) and ldmatrix.trans (weights)
//     give the fragments of mma.sync m16n8k16, X as A and the weights as
//     B. A warp owns 32 rows x 16 units x 3 gates,
//     with the w_ih x and w_hh h steps in separate accumulators (the n gate
//     needs gh_n alone), so every (row, unit) has its three gates in one
//     thread and the GRU cell runs in the epilogue, in registers. Each mma
//     starts from a zero accumulator and its partial is added in f32, as in
//     K1's tensor-core body (chained tensor-core accumulation cost K1 1.2-
//     1.5 points of bf16 token agreement). Rows past B read zero-filled X
//     rows and are not stored; X's zero pad past E + F meets zero rows of
//     the tiles.
// * The TF32 route (f32, H a multiple of 16 up to 907): the same two
//   stages in f32, four launches.
//   What bounds it. The step's bytes: enc (B L F f32, 17.2 MB at B = 100,
//   176 MB at 1024), uv and the f32 gate tiles (15.5 MB), 0.0104 ms at B =
//   100 and 0.0635 at 1024 at the HBM rate. The gate product as three TF32
//   terms is 2.3 GFLOP at B = 100 (24 at 1024); mma.sync m16n8k8 runs TF32
//   at half the wgmma peak, and at B = 1024 these products pace kernel B.
//   What the design does about that.
//   - Kernel A, three launches. W h (attn_wh_f32_kernel): a block a tile of
//     16 rows x 32 columns of W, both in flight by cp.async at entry, h laid
//     out again by k so that a k's 16 rows are four 16-byte loads. The
//     scores (attn_scores_f32_kernel): a warp a (row, frame) item, 16-byte
//     loads of uv and W h. ctx (attn_ctx_f32_kernel): a thread a (row, 4
//     features), every frame's 16-byte streaming load in flight, 14 at a
//     time, so enc streams near the HBM rate with no dependence chain in
//     its way; the same launch copies X's emb, pad and h columns. X = [emb,
//     ctx / L, zeros, h] in f32, its columns the rows of
//     layout.gate_tiles_f32 (E + F padded to a multiple of 8). A first
//     design that gave each row tile one cluster (W h and the scores shared
//     in distributed shared memory, enc staged in shared memory) spent its
//     time in that chain, and read slower at both batches.
//   - Kernel B (gate_gemm_f32_kernel): mma.sync m16n8k8 on TF32 splits, a
//     product as a_lo b_hi + a_hi b_lo + a_hi b_hi from a zero accumulator
//     a k8 step, added in IEEE f32 (as whole_decode_tf32.cu). The weights
//     are A straight from the f32 gate tiles (each lane's 16 bytes are its
//     fragment), X's rows are B. A block takes BN rows x 256 / BN unit
//     tiles x 3 gates (8 warps, a warp 16 units x 32 rows, two blocks an
//     SM); its k8 steps stream through a cp.async ring. The k range is cut
//     into KP = 8 parts (the [emb, ctx, pad] steps into the first ones, the
//     h steps into the rest, so a block holds gi's sums or gh's), one a
//     block of a cluster of 8: 128 blocks at B = 100. Each block pushes its
//     part's sums to the block that owns their rows, which adds the parts
//     in part order, then the biases and the GRU cell in f32. BN is 128,
//     or 32 where 128-row tiles would pad the batch by more than an eighth
//     (the wrapper's gate_rows: at B = 100, 32 rows read 0.046 ms for
//     0.052 on the H100, at 1024 128 rows 0.229 for 0.251). Every sum's
//     order is fixed by the shape alone, so a row's h' is bit-equal at
//     either BN, whatever the batch. A wgmma body (one warpgroup, the three gates' nine terms
//     under one wait a k8 step) gave the same h' bit for bit but ran
//     slower: the from-zero rule needs a wait and a temporary accumulator a
//     k8 step, and the registers of N = 64 rows spill.
// * The CUDA-core body (fused_step_kernel), the first design: f32 shapes
//   the TF32 route does not take, bf16 shapes the tensor-core route does
//   not take, and cuda_cores.
//   What bounds it: every block of TB = 8 rows streams all gate weights
//   from L2 (1.0 GB of L2 reads a call at B = 1024) and each 2-byte weight
//   load feeds TB = 8 f32 FMAs, so the L2 load latency and the FMA rate
//   bound it, as in the whole-decode kernel's CUDA-core body (whole_decode.
//   cu), whose plan this is without the embedding gather and the
//   projection. The row vectors (x = [emb, ctx], h) live in shared memory
//   as [k][TB] f32, so one weight load pairs with two broadcast 16-byte
//   shared loads; 16 warps and k loops unrolled 8 deep keep many L2 loads
//   in flight; a thread owns one hidden unit j across the three gates, so
//   the cell runs in registers. Rows past B are masked.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>

#include "decode_common.cuh"
#include "hopper_mma.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using recnet::from_f;
using recnet::load_rows;
using recnet::round_to;
using recnet::sigmoid;
using recnet::to_f;

// ---------------------------------------------------------------------------
// the CUDA-core body (f32, and bf16 under cuda_cores)
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// the tensor-core route (bf16): kernel A, the attention pass
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int RA = 4;              // rows per block
constexpr int THREADS_A = 256;
constexpr int NWARPS_A = THREADS_A / 32;
constexpr int WB = 16;             // rows of W a thread loads at once
constexpr int SB = 8;              // score items a warp loads at once
constexpr int EB = 7;              // enc frames a thread loads at once

// W h is split over (group of 4 columns, part of the k range) items, one
// a thread; the parts' partial sums are added in part order
__host__ __device__ inline int wh_parts(int A) {
  const int groups = (A + 3) / 4;
  return groups >= THREADS_A ? 1 : THREADS_A / groups;
}

size_t attn_smem_bytes(int L, int A, int H) {
  const int groups = (A + 3) / 4;
  return ((size_t)RA * H                               // h, f32
          + (size_t)RA * A                             // W h
          + (size_t)wh_parts(A) * RA * 4 * groups      // W h partials
          + (size_t)RA * L                             // scores
          + 2 * (size_t)A)                             // attn w, b
         * sizeof(float);
}

// the 4 columns a0..a0+3 of a row of W (zero past A); one 8-byte load when
// the row allows it
__device__ __forceinline__ void load4(const bf16* p, int left, bool vec,
                                      float w[4]) {
  if (vec) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = to_f(v[c]);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) w[c] = c < left ? to_f(p[c]) : 0.f;
}

__global__ void __launch_bounds__(THREADS_A)
attn_pass_kernel(const bf16* __restrict__ emb, const bf16* __restrict__ h,
                 const bf16* __restrict__ enc, const bf16* __restrict__ uv,
                 const bf16* __restrict__ attn_W,
                 const bf16* __restrict__ attn_w,
                 const bf16* __restrict__ attn_b, bf16* __restrict__ x,
                 int B, int L, int F, int A, int E, int H, int ldx,
                 int frame_chunk, int vec4, int vec_enc) {
  extern __shared__ float4 smem_f4[];
  const int groups = (A + 3) / 4, parts = wh_parts(A);
  float* h_s = reinterpret_cast<float*>(smem_f4);   // [RA][H]
  float* wh_s = h_s + RA * H;                       // [RA][A]
  float* part_s = wh_s + RA * A;                    // [parts][RA][4 groups]
  float* sc_s = part_s + parts * RA * 4 * groups;   // [RA][L]
  float* aw_s = sc_s + RA * L;                      // attn w, then b

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * RA;
  const int K = E + F;
  const int kx = ldx - H;          // X's h columns start here (16 nKx)

  // 0. h (shared, f32, and X's h columns, 16 bytes a copy: H is a multiple
  //    of 16 and X's rows and h columns start 32-byte aligned), emb and
  //    the zero pad to X; the loops unrolled so that their loads overlap
  const int H8 = H / 8;
#pragma unroll 4
  for (int i = tid; i < RA * H8; i += THREADS_A) {
    const int b = i / H8, j0 = (i % H8) * 8, row = row0 + b;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < B) {
      raw = *reinterpret_cast<const uint4*>(h + (size_t)row * H + j0);
      *reinterpret_cast<uint4*>(x + (size_t)row * ldx + kx + j0) = raw;
    }
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int q = 0; q < 8; ++q) h_s[b * H + j0 + q] = to_f(v[q]);
  }
#pragma unroll 8
  for (int i = tid; i < RA * E; i += THREADS_A) {
    const int b = i / E, k = i % E, row = row0 + b;
    if (row < B) x[(size_t)row * ldx + k] = emb[(size_t)row * E + k];
  }
  const int pad = kx - K;
  for (int i = tid; i < RA * pad; i += THREADS_A) {
    const int b = i / pad, row = row0 + b;
    if (row < B) x[(size_t)row * ldx + K + i % pad] = from_f<bf16>(0.f);
  }
  for (int a = tid; a < A; a += THREADS_A) {
    aw_s[a] = to_f(attn_w[a]);
    aw_s[A + a] = to_f(attn_b[a]);
  }
  __syncthreads();

  // 1. W h (RA x A), f32 accumulate: item (group q of 4 columns, part p of
  //    the k range k = p, p + parts, ...); a warp shares p, so its h reads
  //    are broadcasts
  for (int item = tid; item < groups * parts; item += THREADS_A) {
    const int q = item % groups, p = item / groups, a0 = 4 * q;
    float acc[RA][4] = {};
    for (int k0 = p; k0 < H; k0 += WB * parts) {
      float w[WB][4];                  // WB rows of W, all loads in flight
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        const int k = k0 + u * parts;
        if (k < H)
          load4(attn_W + (size_t)k * A + a0, A - a0, vec4, w[u]);
      }
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        const int k = k0 + u * parts;
        if (k >= H) break;
#pragma unroll
        for (int b = 0; b < RA; ++b) {
          const float hv = h_s[b * H + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[b][c] += hv * w[u][c];
        }
      }
    }
#pragma unroll
    for (int b = 0; b < RA; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part_s[(p * RA + b) * 4 * groups + a0 + c] = acc[b][c];
  }
  __syncthreads();
  for (int i = tid; i < RA * A; i += THREADS_A) {
    const int b = i / A, a = i % A;
    float s = 0.f;
    for (int p = 0; p < parts; ++p)
      s += part_s[(p * RA + b) * 4 * groups + a];
    wh_s[i] = s;
  }
  __syncthreads();

  // 2. scores: a warp takes SB (row, frame) items at a time, a lane 4
  //    attention units of each, every item's uv loads issued before the
  //    first tanh
  for (int p0 = warp; p0 < RA * L; p0 += NWARPS_A * SB) {
    float s[SB] = {};
    for (int a0 = 4 * lane; a0 < A; a0 += 128) {
      float v[SB][4];
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int p = p0 + u * NWARPS_A, row = row0 + p / L;
        if (p < RA * L && row < B)
          load4(uv + ((size_t)row * L + p % L) * A + a0, A - a0, vec4, v[u]);
        else
          v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int b = min((p0 + u * NWARPS_A) / L, RA - 1);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (a0 + c < A)
            s[u] += tanhf(wh_s[b * A + a0 + c] + v[u][c] + aw_s[A + a0 + c]) *
                    aw_s[a0 + c];
      }
    }
#pragma unroll
    for (int u = 0; u < SB; ++u) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[u] += __shfl_down_sync(0xffffffffu, s[u], off);
      const int p = p0 + u * NWARPS_A;
      if (lane == 0 && p < RA * L) sc_s[p] = s[u];
    }
  }
  __syncthreads();

  // 3. ctx in chunks of frame_chunk frames (each chunk summed from zero,
  //    then added to ctx), / L, rounded to bf16 into X. enc is read once:
  //    streaming loads, so that it does not push the gate tiles out of L2
  if (vec_enc) {   // 8 features, 16 bytes, a load
    const int F8 = F / 8;
    for (int i = tid; i < RA * F8; i += THREADS_A) {
      const int b = i / F8, e0 = (i % F8) * 8, row = row0 + b;
      if (row >= B) continue;
      const bf16* ep = enc + (size_t)row * L * F + e0;
      float ctx[8] = {}, acc[8] = {};
      int left = frame_chunk;          // frames left in the current chunk
      for (int f0 = 0; f0 < L; f0 += EB) {
        uint4 raw[EB];                 // EB frames' loads, all in flight
#pragma unroll
        for (int u = 0; u < EB; ++u)
          if (f0 + u < L)
            raw[u] = __ldcs(reinterpret_cast<const uint4*>(
                ep + (size_t)(f0 + u) * F));
#pragma unroll
        for (int u = 0; u < EB; ++u) {
          if (f0 + u >= L) break;
          const bf16* v = reinterpret_cast<const bf16*>(&raw[u]);
          const float s = sc_s[b * L + f0 + u];
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[q] += s * to_f(v[q]);
          if (--left == 0) {           // the chunk's sum joins ctx
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              ctx[q] += acc[q];
              acc[q] = 0.f;
            }
            left = frame_chunk;
          }
        }
      }
      bf16* xp = x + (size_t)row * ldx + E + e0;
#pragma unroll
      for (int q = 0; q < 8; ++q) xp[q] = from_f<bf16>(ctx[q] / (float)L);
    }
  } else {
    for (int i = tid; i < RA * F; i += THREADS_A) {
      const int b = i / F, e = i % F, row = row0 + b;
      if (row >= B) continue;
      const bf16* ep = enc + (size_t)row * L * F + e;
      float ctx = 0.f, acc = 0.f;
      int left = frame_chunk;
#pragma unroll 4
      for (int f = 0; f < L; ++f) {
        acc += sc_s[b * L + f] * to_f(ep[(size_t)f * F]);
        if (--left == 0) {
          ctx += acc;
          acc = 0.f;
          left = frame_chunk;
        }
      }
      x[(size_t)row * ldx + E + e] = from_f<bf16>(ctx / (float)L);
    }
  }
}

// ---------------------------------------------------------------------------
// the tensor-core route (bf16): kernel B, the gate GEMM and the GRU cell
// ---------------------------------------------------------------------------

constexpr int BM = 64;             // rows per block
constexpr int UT = 4;              // 16-unit tiles per block, x 3 gates
constexpr int THREADS_B = 256;     // 8 warps: 2 row halves x UT unit tiles
constexpr int KSTEPS = 2;          // k16 steps per stage of the ring
constexpr int STAGES = 4;          // stages of the cp.async ring
constexpr int WTILE = 256;         // bf16 elements of a 16 x 16 tile
constexpr int X_TILE = BM * 16;    // a k16 step's X tile, [BM rows][16]
constexpr int SUB = X_TILE + UT * 3 * WTILE;   // a k16 step's tiles
constexpr int SUB_CHUNKS = SUB / 8;            // their 16-byte copies
constexpr int STAGE = KSTEPS * SUB;
constexpr int CPT = SUB_CHUNKS / THREADS_B;    // a thread's copies a step
static_assert(SUB_CHUNKS % THREADS_B == 0, "copies split evenly");
static_assert(THREADS_B / 32 == 2 * UT, "a warp owns 32 rows x 1 unit tile");

size_t gate_smem_bytes() { return sizeof(bf16) * STAGES * STAGE; }

// one k16 step of a warp: its 32 rows x 16 units x 3 gates, each mma from a
// zero accumulator and its partial added in f32
__device__ __forceinline__ void gate_step(const bf16* st, const int a_off[2],
                                          int b_off,
                                          float (&acc)[2][3][2][4]) {
  unsigned af[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) recnet::ldmatrix_x4<false>(af[mi], st + a_off[mi]);
#pragma unroll
  for (int gt = 0; gt < 3; ++gt) {
    unsigned bw[4];   // units 0-7: bw[0..1], units 8-15: bw[2..3]
    recnet::ldmatrix_x4<true>(bw, st + X_TILE + gt * WTILE + b_off);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        recnet::mma_bf16(d, af[mi], bw + 2 * ni);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][gt][ni][e] += d[e];
      }
  }
}

__global__ void __launch_bounds__(THREADS_B, 1)
gate_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                 const bf16* __restrict__ bias3, bf16* __restrict__ h_out,
                 int B, int H, int ldx) {
  extern __shared__ float4 smem_f4[];
  bf16* ring = reinterpret_cast<bf16*>(smem_f4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * BM;
  const int ut0 = blockIdx.y * UT;
  const int n_ut = H / 16;
  const int nKg = ldx / 16;          // k16 steps: nKx of x, then n_ut of h
  const int nKx = nKg - n_ut;

  // A k16 step's copies: X's 64 rows x 2 16-byte halves, then the UT unit
  // tiles' 3 gate tiles of 32 16-byte chunks, CPT a thread. Both are
  // [16-element rows of 32 bytes], the halves XOR-swizzled by row / 4 so
  // that ldmatrix's 8-row reads fall in distinct banks. Each copy's shared
  // offset, source at step 0 and source stride per step are fixed for the
  // thread; rows past B, unit tiles past H and steps past the last read
  // zeros.
  int c_dst[CPT], c_stride[CPT];
  const bf16* c_src[CPT];
  bool c_ok[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + i * THREADS_B;
    if (c < 2 * BM) {
      const int r = c >> 1, half = c & 1, row = row0 + r;
      c_ok[i] = row < B;
      c_src[i] = x + (c_ok[i] ? (size_t)row * ldx + half * 8 : 0);
      c_stride[i] = 16;
      c_dst[i] = r * 16 + ((half ^ ((r >> 2) & 1)) << 3);
    } else {
      const int w = c - 2 * BM, u = w / 96, gt = (w % 96) >> 5, cc = w & 31,
                k = cc >> 1, ug = ut0 + u;
      c_ok[i] = ug < n_ut;
      c_src[i] = wg + (c_ok[i] ? ((size_t)ug * nKg * 3 + gt) * WTILE + cc * 8
                               : 0);
      c_stride[i] = 3 * WTILE;
      c_dst[i] = X_TILE + (u * 3 + gt) * WTILE + k * 16 +
                 (((cc & 1) ^ ((k >> 2) & 1)) << 3);
    }
  }
  // the copies of stage t (k16 steps t KSTEPS ..) into a ring slot
  auto issue = [&](int slot, int t) {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int s = t * KSTEPS + ks;
      bf16* st = ring + slot * STAGE + ks * SUB;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const bool ok = c_ok[i] && s < nKg;
        recnet::cp_async16_zfill(
            st + c_dst[i], ok ? c_src[i] + (size_t)s * c_stride[i] : c_src[i],
            ok);
      }
    }
  };

  // this warp's rows rh * 32.. and unit tile u; ldmatrix row addresses:
  // X (A operand) rows lane % 16, inputs +8 for lanes 16-31; a weight tile
  // (B operand, transposed) inputs lane % 8 (+8 for lanes 8-15 and 24-31),
  // units +8 for lanes 16-31
  const int rh = warp & 1, u = warp >> 1;
  int a_off[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = rh * 32 + mi * 16 + (lane & 15), half = lane >> 4;
    a_off[mi] = r * 16 + ((half ^ ((r >> 2) & 1)) << 3);
  }
  const int bk = (lane & 7) + (((lane >> 3) & 1) << 3), bh = lane >> 4;
  const int b_off = u * 3 * WTILE + bk * 16 + ((bh ^ ((bk >> 2) & 1)) << 3);

  float ai[2][3][2][4] = {}, ah[2][3][2][4] = {};
  const int n_st = (nKg + KSTEPS - 1) / KSTEPS;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_st) issue(t, t);
    recnet::cp_async_commit();
  }
  for (int t = 0; t < n_st; ++t) {
    recnet::cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage t landed for every thread; slot t - 1 is free
    if (t + STAGES - 1 < n_st) issue((t + STAGES - 1) % STAGES, t + STAGES - 1);
    recnet::cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int s = t * KSTEPS + ks;
      const bf16* st = ring + (t % STAGES) * STAGE + ks * SUB;
      if (s < nKx)
        gate_step(st, a_off, b_off, ai);
      else if (s < nKg)
        gate_step(st, a_off, b_off, ah);
    }
  }
  recnet::cp_async_wait<0>();

  // the epilogue: biases, the GRU cell in f32, h' in bf16. Accumulator
  // element e of (mi, ni) holds row g + 8 (e / 2) and unit 2 t4 + e % 2
  const int ug = ut0 + u;
  if (ug >= n_ut) return;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + rh * 32 + mi * 16 + g + hr * 8;
      if (row >= B) continue;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int j = ug * 16 + ni * 8 + 2 * t4;
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(
            x + (size_t)row * ldx + 16 * nKx + j);
        float hn[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = hr * 2 + c;
          float gi[3], gh[3];
#pragma unroll
          for (int gt = 0; gt < 3; ++gt) {
            gi[gt] = ai[mi][gt][ni][e] + to_f(bias3[gt * H + j + c]);
            gh[gt] = ah[mi][gt][ni][e] + to_f(bias3[3 * H + gt * H + j + c]);
          }
          const float r = sigmoid(gi[0] + gh[0]);
          const float z = sigmoid(gi[1] + gh[1]);
          const float n = tanhf(gi[2] + r * gh[2]);
          const float hp = to_f(c == 0 ? hv.x : hv.y);
          hn[c] = (1.0f - z) * n + z * hp;
        }
        *reinterpret_cast<__nv_bfloat162*>(h_out + (size_t)row * H + j) =
            __floats2bfloat162_rn(hn[0], hn[1]);
      }
    }
}

// ---------------------------------------------------------------------------
// the TF32 route (f32): kernel A, the attention pass, in three launches
// ---------------------------------------------------------------------------

constexpr int THREADS_AF = 256;
constexpr int NWARPS_AF = THREADS_AF / 32;
constexpr int WH_ROWS = 16;        // W h: rows of a block's tile
constexpr int WH_COLS = 32;        // its columns of W
constexpr int WH_PARTS = 16;       // parts of its k range
constexpr int EB_F = 14;           // enc frames a thread loads at once
constexpr size_t SMEM_LIMIT = 232448;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// the slice [lo, hi) of n items that block r of c takes
__host__ __device__ inline void slice(int n, int r, int c, int& lo, int& hi) {
  lo = r * n / c;
  hi = (r + 1) * n / c;
}

// byte offsets of the W h launch's shared arrays
// (ops/cuda/fused_step.py attn_tf32_smem_bytes mirrors it)
struct WhSmem {
  int hld;
  size_t w, hrow, h, total;
  __host__ __device__ explicit WhSmem(int H) {
    hld = H + 4;                  // h's rows as copied, 4 words apart mod 32
    const int parts = WH_PARTS * WH_ROWS * WH_COLS;        // then the parts'
    const int hrows = WH_ROWS * hld;                       // sums in place
    size_t o = 0;
    w = o;    o = align16(o + 4 * (size_t)H * WH_COLS);    // [H][WH_COLS]
    hrow = o; o = align16(o + 4 * (size_t)(hrows > parts ? hrows : parts));
    h = o;    o = align16(o + 4 * (size_t)H * WH_ROWS);    // [H][WH_ROWS]
    total = o;
  }
};

// Kernel A, first launch: W h (B x A) in f32, a block a tile of WH_ROWS
// rows x WH_COLS columns of W. Its W columns and h rows are in flight by
// 16-byte cp.async at entry; h is laid out again as [k][row], so a k's 16
// rows are four 16-byte loads that every thread of a part shares. A thread
// takes 2 columns x 16 rows over one of WH_PARTS parts of the k range; the
// parts' sums (in the freed copy of h) are added in part order. The order
// depends on neither the batch nor the grid.
__global__ void __launch_bounds__(THREADS_AF)
attn_wh_f32_kernel(const float* __restrict__ h,
                   const float* __restrict__ attn_W, float* __restrict__ wh,
                   int B, int A, int H, int vec) {
  extern __shared__ float4 smem_f4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_f4);
  const WhSmem lay(H);
  float* w_s = reinterpret_cast<float*>(sm + lay.w);
  float* hrow_s = reinterpret_cast<float*>(sm + lay.hrow);
  float* h_s = reinterpret_cast<float*>(sm + lay.h);
  float* part_s = hrow_s;   // once h is laid out again

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * WH_COLS, row0 = blockIdx.y * WH_ROWS;
  const int rows = min(WH_ROWS, B - row0), cols = min(WH_COLS, A - c0);
  if (vec) {   // A, H multiples of 4; W and h 16-byte aligned
    const int q4 = WH_COLS / 4;
    for (int c = tid; c < H * q4; c += THREADS_AF) {
      const int k = c / q4, q = c % q4;
      recnet::cp_async16_zfill(
          w_s + 4 * c, attn_W + (size_t)k * A + c0 + 4 * (4 * q < cols ? q : 0),
          4 * q < cols);
    }
    const int r4 = H / 4;
    for (int c = tid; c < rows * r4; c += THREADS_AF)
      recnet::cp_async16(hrow_s + (c / r4) * lay.hld + 4 * (c % r4),
                         h + (size_t)(row0 + c / r4) * H + 4 * (c % r4));
  } else {
    for (int i = tid; i < H * WH_COLS; i += THREADS_AF) {
      const int k = i / WH_COLS, c = i % WH_COLS;
      w_s[i] = c < cols ? attn_W[(size_t)k * A + c0 + c] : 0.f;
    }
    for (int i = tid; i < rows * H; i += THREADS_AF)
      hrow_s[(i / H) * lay.hld + i % H] = h[(size_t)row0 * H + i];
  }
  recnet::cp_async_commit();
  recnet::cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < H * WH_ROWS; i += THREADS_AF) {
    const int b = i % WH_ROWS, k = i / WH_ROWS;
    h_s[i] = b < rows ? hrow_s[b * lay.hld + k] : 0.f;
  }
  __syncthreads();

  // thread (column pair cp, part p): k = p, p + WH_PARTS, ...
  const int cp = tid % (WH_COLS / 2), p = tid / (WH_COLS / 2);
  float acc[WH_ROWS][2] = {};
#pragma unroll 4
  for (int k = p; k < H; k += WH_PARTS) {
    const float2 w = *reinterpret_cast<const float2*>(w_s + k * WH_COLS +
                                                      2 * cp);
    float hv[WH_ROWS];
#pragma unroll
    for (int b = 0; b < WH_ROWS; b += 8)
      recnet::load_rows<8>(h_s + k * WH_ROWS + b, hv + b);
#pragma unroll
    for (int b = 0; b < WH_ROWS; ++b) {
      acc[b][0] += hv[b] * w.x;
      acc[b][1] += hv[b] * w.y;
    }
  }
  __syncthreads();   // every thread is past h's copy: it holds the parts
#pragma unroll
  for (int b = 0; b < WH_ROWS; ++b)
    *reinterpret_cast<float2*>(part_s + (p * WH_ROWS + b) * WH_COLS +
                               2 * cp) = make_float2(acc[b][0], acc[b][1]);
  __syncthreads();
  for (int i = tid; i < rows * WH_COLS; i += THREADS_AF) {
    const int b = i / WH_COLS, c = i % WH_COLS;
    float s = 0.f;
#pragma unroll 4
    for (int q = 0; q < WH_PARTS; ++q)
      s += part_s[(q * WH_ROWS + b) * WH_COLS + c];
    if (c < cols) wh[(size_t)(row0 + b) * A + c0 + c] = s;
  }
}

// Kernel A, second launch: the scores, a warp a (row, frame) item, a lane
// 4 attention units at a time (16-byte loads of uv and W h where A is a
// multiple of 4), reduced by shuffles, into sc (B x L).
__global__ void __launch_bounds__(THREADS_AF)
attn_scores_f32_kernel(const float* __restrict__ uv,
                       const float* __restrict__ wh,
                       const float* __restrict__ attn_w,
                       const float* __restrict__ attn_b,
                       float* __restrict__ sc, int B, int L, int A,
                       int vec) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * NWARPS_AF + (threadIdx.x >> 5);
  if (i >= B * L) return;
  const float* up = uv + (size_t)i * A;
  const float* wp = wh + (size_t)(i / L) * A;
  float s = 0.f;
  for (int a0 = 4 * lane; a0 < A; a0 += 128) {
    float u[4], w[4];
    if (vec) {
      const float4 qu = *reinterpret_cast<const float4*>(up + a0);
      const float4 qw = *reinterpret_cast<const float4*>(wp + a0);
      u[0] = qu.x; u[1] = qu.y; u[2] = qu.z; u[3] = qu.w;
      w[0] = qw.x; w[1] = qw.y; w[2] = qw.z; w[3] = qw.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        u[c] = a0 + c < A ? up[a0 + c] : 0.f;
        w[c] = a0 + c < A ? wp[a0 + c] : 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (a0 + c < A)
        s += tanhf(w[c] + u[c] + attn_b[a0 + c]) * attn_w[a0 + c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) sc[i] = s;
}

// Kernel A, third launch: ctx, a stream of enc, and X's other columns. A
// thread a (row, 4 features): every frame's 16-byte load of them in
// flight, EB_F at a time, read once (streaming loads: enc does not push
// the gate tiles out of L2); the frames summed in chunks of frame_chunk
// (each chunk from zero, then added to ctx), / L, into X. The threads
// past those copy a row's emb, zero pad and h columns, 4 columns each
// (vec_x) or one.
__global__ void __launch_bounds__(THREADS_AF)
attn_ctx_f32_kernel(const float* __restrict__ emb,
                    const float* __restrict__ h,
                    const float* __restrict__ enc,
                    const float* __restrict__ sc, float* __restrict__ x,
                    int B, int L, int F, int E, int H, int ldx,
                    int frame_chunk, int vec_enc, int vec_x) {
  const unsigned nq = vec_enc ? F / 4 : F;
  unsigned item = blockIdx.x * THREADS_AF + threadIdx.x;
  if (item >= (unsigned)B * nq) {    // X's emb, pad and h columns
    const int kx = ldx - H, pad = kx - E - F, w = vec_x ? 4 : 1;
    const unsigned nc = (E + pad + H) / w;
    item -= (unsigned)B * nq;
    if (item >= (unsigned)B * nc) return;
    const int row = (int)(item / nc), c = (int)(item % nc) * w;
    float* xr = x + (size_t)row * ldx;
    const float* src = c < E ? emb + (size_t)row * E + c
                             : h + (size_t)row * H + c - E - pad;
    float* dst = xr + (c < E ? c : c < E + pad ? E + F + c - E
                                               : kx + c - E - pad);
    if (vec_x)
      *reinterpret_cast<float4*>(dst) =
          c >= E && c < E + pad ? make_float4(0.f, 0.f, 0.f, 0.f)
                                : *reinterpret_cast<const float4*>(src);
    else
      *dst = c >= E && c < E + pad ? 0.f : *src;
    return;
  }
  const int row = (int)(item / nq), q = (int)(item % nq);
  const float* sp = sc + (size_t)row * L;
  float* xp = x + (size_t)row * ldx + E;
  if (vec_enc) {
    const float4* ep = reinterpret_cast<const float4*>(
        enc + (size_t)row * L * F + 4 * q);
    const int f4 = F / 4;
    float ctx[4] = {}, acc[4] = {};
    int left = frame_chunk;            // frames left in the current chunk
    for (int f0 = 0; f0 < L; f0 += EB_F) {
      float4 v[EB_F];                  // EB_F frames' loads, all in flight
#pragma unroll
      for (int u = 0; u < EB_F; ++u)
        if (f0 + u < L) v[u] = __ldcs(ep + (size_t)(f0 + u) * f4);
#pragma unroll
      for (int u = 0; u < EB_F; ++u) {
        if (f0 + u >= L) break;
        const float s = sp[f0 + u];
        acc[0] += s * v[u].x;
        acc[1] += s * v[u].y;
        acc[2] += s * v[u].z;
        acc[3] += s * v[u].w;
        if (--left == 0) {             // the chunk's sum joins ctx
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            ctx[c] += acc[c];
            acc[c] = 0.f;
          }
          left = frame_chunk;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) xp[4 * q + c] = ctx[c] / (float)L;
  } else {
    const float* ep = enc + (size_t)row * L * F + q;
    float ctx = 0.f, acc = 0.f;
    int left = frame_chunk;
#pragma unroll 4
    for (int f = 0; f < L; ++f) {
      acc += sp[f] * ep[(size_t)f * F];
      if (--left == 0) {
        ctx += acc;
        acc = 0.f;
        left = frame_chunk;
      }
    }
    xp[q] = ctx / (float)L;
  }
}

// ---------------------------------------------------------------------------
// the TF32 route (f32): kernel B, the gate GEMM and the GRU cell
// ---------------------------------------------------------------------------


constexpr int KP = 8;              // k parts: a cluster's blocks, fixed
constexpr int THREADS_BF = 256;    // 8 warps: a warp 16 units x 32 rows
constexpr int KS_F = 4;            // k8 steps a stage of the ring
constexpr int TWO_PER_SM = 115712; // shared memory of a block, two an SM
                                   // (228 KB less 1 KB a block, halved)

// The k parts: the first px of the KP parts split X's [emb, ctx, pad] k8
// steps (gi), the others its h steps (gh), in proportion to their counts;
// a block sums one part, so it holds one kind of sum.
__host__ __device__ inline int x_parts(int nKx, int nKh) {
  const int px = (KP * nKx + (nKx + nKh) / 2) / (nKx + nKh);
  return px < 1 ? 1 : (px > KP - 1 ? KP - 1 : px);
}

constexpr int TILE_F = 128;        // f32 values of a 16 x 8 weight tile

// BN rows x UT unit tiles (x 3 gates) a block, BN UT = 8 x 32
template <int BN>
struct GateF32 {
  static constexpr int UT = 256 / BN;
  static constexpr int RG = BN / 32;                  // row groups of a block
  static constexpr int W_STEP = UT * 3 * TILE_F;      // a k8 step's weights
  static constexpr int X_STEP = BN * 8;               // and its X tile
  static constexpr int STEP = W_STEP + X_STEP;        // floats
  static constexpr int CHUNKS = STEP / 4;             // 16-byte copies
  static constexpr int CPT = (CHUNKS + THREADS_BF - 1) / THREADS_BF;
  // the parts' sums that this block adds up, in the ring once every
  // block's loop is done: its BN / KP rows of the block's, [KP parts][3
  // gates][row][unit], a row PLD apart
  static constexpr int OWN = BN / KP;
  static constexpr int PLD = UT * 16 + 4;
  static constexpr int RECV = KP * 3 * OWN * PLD;
  // stages of the cp.async ring: as many as two blocks an SM allow, 2 to 5
  static constexpr int FIT = TWO_PER_SM / (4 * KS_F * STEP);
  static constexpr int STAGES = FIT < 2 ? 2 : (FIT > 5 ? 5 : FIT);
  static constexpr int RING = STAGES * KS_F * STEP;
  static constexpr size_t SMEM = 4 * (size_t)(RING > RECV ? RING : RECV);
  static_assert(UT * RG == THREADS_BF / 32, "a warp a unit tile x 32 rows");
};

// one k8 step of a warp: 16 units x 3 gates x its nf 8-row fragments, each
// product in three TF32 terms from a zero accumulator, added in f32
__device__ __forceinline__ void gate_step_f32(const float* wst,
                                              const float* xst, int lane,
                                              int nf, float (&acc)[3][4][4]) {
  unsigned ahi[3][4], alo[3][4];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float4 a = reinterpret_cast<const float4*>(wst + g * TILE_F)[lane];
    recnet::split_tf32(a.x, ahi[g][0], alo[g][0]);
    recnet::split_tf32(a.y, ahi[g][1], alo[g][1]);
    recnet::split_tf32(a.z, ahi[g][2], alo[g][2]);
    recnet::split_tf32(a.w, ahi[g][3], alo[g][3]);
  }
  const int t = lane & 3;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    if (f >= nf) break;
    // row g of the fragment: its inputs t and t + 4, stored with the
    // halves swapped on every other group of 4 rows (no bank conflicts)
    const int r = f * 8 + (lane >> 2), sw = ((r >> 2) & 1) * 4;
    const float* xr = xst + r * 8;
    unsigned bhi[2], blo[2];
    recnet::split_tf32(xr[t ^ sw], bhi[0], blo[0]);
    recnet::split_tf32(xr[(t + 4) ^ sw], bhi[1], blo[1]);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float d[4];
      recnet::mma_3xtf32(d, ahi[g], alo[g], bhi, blo);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][f][e] += d[e];
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS_BF, 2)
gate_gemm_f32_kernel(const float* __restrict__ x,
                     const float* __restrict__ wg,
                     const float* __restrict__ bias3,
                     float* __restrict__ h_out, int B, int H, int ldx) {
  using S = GateF32<BN>;
  cg::cluster_group cluster = cg::this_cluster();
  const int kp = (int)cluster.block_rank();     // this block's k part
  extern __shared__ float4 smem_f4[];
  float* ring = reinterpret_cast<float*>(smem_f4);
  float* recv = ring;   // once every block of the cluster is past its loop
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_ut = H / 16;
  const int n_ug = (n_ut + S::UT - 1) / S::UT;
  const int cid = (int)(blockIdx.x / KP);
  const int ut0 = (cid % n_ug) * S::UT, row0 = (cid / n_ug) * BN;
  const int nK = ldx / 8, nKx = nK - H / 8;      // k8 steps: X's, then h's
  const int px = x_parts(nKx, nK - nKx);
  int s_lo, s_hi;
  if (kp < px) {
    slice(nKx, kp, px, s_lo, s_hi);
  } else {
    slice(nK - nKx, kp - px, KP - px, s_lo, s_hi);
    s_lo += nKx;
    s_hi += nKx;
  }

  // A k8 step's copies: the UT unit tiles' 3 gate tiles (96 16-byte chunks
  // each, contiguous), then X's BN rows x 2 halves, CPT a thread. Each
  // copy's shared offset, source at step 0 and source stride per step are
  // fixed for the thread; unit tiles past H and rows past B read zeros.
  int c_dst[S::CPT], c_stride[S::CPT];
  const float* c_src[S::CPT];
  bool c_ok[S::CPT], c_any[S::CPT];
#pragma unroll
  for (int i = 0; i < S::CPT; ++i) {
    const int c = tid + i * THREADS_BF;
    c_any[i] = c < S::CHUNKS;
    if (c < S::UT * 96) {
      const int u = c / 96, ug = ut0 + u;
      c_ok[i] = ug < n_ut;
      c_src[i] = wg + (c_ok[i] ? (size_t)ug * nK * 3 * TILE_F + (c % 96) * 4
                               : 0);
      c_stride[i] = 3 * TILE_F;
      c_dst[i] = c * 4;
    } else {
      const int w = c - S::UT * 96, r = w >> 1, half = w & 1,
                row = row0 + r;
      c_ok[i] = c_any[i] && row < B;
      c_src[i] = x + (c_ok[i] ? (size_t)row * ldx + half * 4 : 0);
      c_stride[i] = 8;
      c_dst[i] = S::W_STEP + r * 8 + ((half ^ ((r >> 2) & 1)) << 2);
    }
  }
  // the copies of stage t (k8 steps s_lo + t KS_F ..) into a ring slot
  auto issue = [&](int slot, int t) {
#pragma unroll
    for (int ks = 0; ks < KS_F; ++ks) {
      const int s = s_lo + t * KS_F + ks;
      if (s >= s_hi) break;
      float* st = ring + (slot * KS_F + ks) * S::STEP;
#pragma unroll
      for (int i = 0; i < S::CPT; ++i)
        if (c_any[i])
          recnet::cp_async16_zfill(
              st + c_dst[i],
              c_ok[i] ? c_src[i] + (size_t)s * c_stride[i] : c_src[i],
              c_ok[i]);
    }
  };

  // this warp's unit tile u and row group q (rows q * 32 ..); its 8-row
  // fragments that hold a row below B
  const int u = warp / S::RG, q = warp % S::RG;
  const int nf = max(0, min(4, (B - row0 - q * 32 + 7) / 8));
  float acc[3][4][4] = {};   // gi's part (kp < px) or gh's
  const int n_st = (s_hi - s_lo + KS_F - 1) / KS_F;
#pragma unroll
  for (int t = 0; t < S::STAGES - 1; ++t) {
    if (t < n_st) issue(t, t);
    recnet::cp_async_commit();
  }
  for (int t = 0; t < n_st; ++t) {
    recnet::cp_async_wait<S::STAGES - 2>();
    __syncthreads();   // stage t landed for every thread; slot t - 1 is free
    if (t + S::STAGES - 1 < n_st)
      issue((t + S::STAGES - 1) % S::STAGES, t + S::STAGES - 1);
    recnet::cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < KS_F; ++ks) {
      const int s = s_lo + t * KS_F + ks;
      if (s >= s_hi) break;
      const float* st = ring + ((t % S::STAGES) * KS_F + ks) * S::STEP;
      const float* wst = st + u * 3 * TILE_F;
      gate_step_f32(wst, st + S::W_STEP + q * 32 * 8, lane, nf, acc);
    }
  }
  recnet::cp_async_wait<0>();

  // this part's sums to the block that adds up their rows: row r's to
  // block r / OWN, in the slot of this part. Accumulator element e of
  // fragment f holds unit g + 8 (e / 2) and row 2 t + e % 2 of the
  // fragment.
  recnet::cluster_arrive();   // every block's ring is free once all arrive
  recnet::cluster_wait();
  {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int unit = u * 16 + g + 8 * (e >> 1);
        const int r = q * 32 + f * 8 + 2 * t4 + (e & 1);
        float* dst = cluster.map_shared_rank(recv, r / S::OWN) +
                     (kp * 3 * S::OWN + r % S::OWN) * S::PLD + unit;
#pragma unroll
        for (int gt = 0; gt < 3; ++gt)
          dst[gt * S::OWN * S::PLD] = acc[gt][f][e];
      }
  }
  recnet::cluster_arrive();   // the sums are in their blocks once all arrive
  recnet::cluster_wait();

  // this block sums the parts, in part order (gi the first px, gh the
  // others), for its OWN rows of the block's; the biases and the GRU cell
  // in f32; h' for rows below B
  const int nu = S::UT * 16;
  for (int i = tid; i < S::OWN * nu; i += THREADS_BF) {
    const int ro = i / nu, unit = i % nu;
    const int row = row0 + kp * S::OWN + ro, j = ut0 * 16 + unit;
    if (row >= B || j >= H) continue;
    float v[6] = {};
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      const int o = p < px ? 0 : 3;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[o + c] += recv[((p * 3 + c) * S::OWN + ro) * S::PLD + unit];
    }
    float gi3[3], gh3[3];
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) {
      gi3[gt] = v[gt] + bias3[gt * H + j];
      gh3[gt] = v[3 + gt] + bias3[3 * H + gt * H + j];
    }
    const float rg = sigmoid(gi3[0] + gh3[0]);
    const float zg = sigmoid(gi3[1] + gh3[1]);
    const float ng = tanhf(gi3[2] + rg * gh3[2]);
    const float hp = x[(size_t)row * ldx + nKx * 8 + j];
    h_out[(size_t)row * H + j] = (1.0f - zg) * ng + zg * hp;
  }
}

// how many clusters of `c` blocks of `kernel` the card holds at once
template <typename... Params>
int active_clusters(void (*kernel)(Params...), int threads, size_t smem,
                    int c) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)c, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return -1;
  return n;
}

// a launch of `kernel` in clusters of `c` blocks along x
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int blocks, int threads,
                            size_t smem, int c, cudaStream_t stream,
                            Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_attn_f32(const float* emb, const float* h,
                            const float* enc, const float* uv,
                            const float* attn_W, const float* attn_w,
                            const float* attn_b, float* x, float* scratch,
                            int B, int L, int F, int A, int E, int H, int ldx,
                            int frame_chunk, cudaStream_t s) {
  float* wh = scratch;                       // B x A, then the scores
  float* sc = scratch + (size_t)B * A;       // B x L
  const size_t smem = WhSmem(H).total;
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_wh_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int vec_wh = A % 4 == 0 && H % 4 == 0 && (size_t)attn_W % 16 == 0 &&
                     (size_t)h % 16 == 0;
  attn_wh_f32_kernel<<<dim3((A + WH_COLS - 1) / WH_COLS,
                            (B + WH_ROWS - 1) / WH_ROWS),
                       THREADS_AF, smem, s>>>(h, attn_W, wh, B, A, H, vec_wh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int vec_sc = A % 4 == 0 && (size_t)uv % 16 == 0;
  attn_scores_f32_kernel<<<(B * L + NWARPS_AF - 1) / NWARPS_AF, THREADS_AF,
                           0, s>>>(uv, wh, attn_w, attn_b, sc, B, L, A,
                                   vec_sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int vec_enc = F % 4 == 0 && (size_t)enc % 16 == 0;
  const int vec_x = E % 4 == 0 && F % 4 == 0 && (size_t)emb % 16 == 0 &&
                    (size_t)h % 16 == 0 && (size_t)x % 16 == 0;
  const long long items = (long long)B * ((vec_enc ? F / 4 : F) +
                                          (ldx - F) / (vec_x ? 4 : 1));
  if (items >= (1ll << 31)) return cudaErrorInvalidValue;
  attn_ctx_f32_kernel<<<(unsigned)((items + THREADS_AF - 1) / THREADS_AF),
                        THREADS_AF, 0, s>>>(emb, h, enc, sc, x, B, L, F, E,
                                            H, ldx, frame_chunk, vec_enc,
                                            vec_x);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_gate_f32(const float* x, const float* tiles,
                            const float* bias3, float* h_out, int B, int H,
                            int ldx, cudaStream_t s) {
  using S = GateF32<BN>;
  const int n_ug = (H / 16 + S::UT - 1) / S::UT;
  return launch_clusters(gate_gemm_f32_kernel<BN>,
                         n_ug * ((B + BN - 1) / BN) * KP, THREADS_BF, S::SMEM,
                         KP, s, x, tiles, bias3, h_out, B, H, ldx);
}

}  // namespace

extern "C" {

const char* recnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The CUDA-core body. dtype: 0 = float32, 1 = bfloat16. L must divide by
// frame_chunk (the wrapper checks). Launches on `stream` and returns
// cudaGetLastError().
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

// The tensor-core route, bf16 throughout. kernels: 1 = kernel A (emb, h,
// enc, uv and the attention weights -> x), 2 = kernel B (x, the gate tiles
// and bias3 -> h_out), 3 = both, in that order on `stream`. x is (B, ldx)
// with ldx = 16 ceil((E + F) / 16) + H; tiles as layout.gate_tiles makes
// them. Returns the first launch error.
int recnet_fused_step_tc(int kernels, const void* emb, const void* h,
                         const void* enc, const void* uv, const void* attn_W,
                         const void* attn_w, const void* attn_b,
                         const void* tiles, const void* bias3, void* x,
                         void* h_out, int B, int L, int F, int A, int E,
                         int H, int ldx, int frame_chunk, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || H % 16 != 0 || ldx % 16 != 0 || ldx <= H)
    return (int)cudaErrorInvalidValue;
  if (kernels & 1) {
    if (frame_chunk < 1 || L % frame_chunk != 0 ||
        ldx != (E + F + 15) / 16 * 16 + H)
      return (int)cudaErrorInvalidValue;
    const size_t smem = attn_smem_bytes(L, A, H);
    cudaError_t err = cudaFuncSetAttribute(
        attn_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int vec4 =
        A % 4 == 0 && (size_t)attn_W % 8 == 0 && (size_t)uv % 8 == 0;
    const int vec_enc = F % 8 == 0 && (size_t)enc % 16 == 0;
    attn_pass_kernel<<<(B + RA - 1) / RA, THREADS_A, smem, s>>>(
        (const bf16*)emb, (const bf16*)h, (const bf16*)enc, (const bf16*)uv,
        (const bf16*)attn_W, (const bf16*)attn_w, (const bf16*)attn_b,
        (bf16*)x, B, L, F, A, E, H, ldx, frame_chunk, vec4, vec_enc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (kernels & 2) {
    const size_t smem = gate_smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(
        gate_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((B + BM - 1) / BM, (H / 16 + UT - 1) / UT);
    gate_gemm_kernel<<<grid, THREADS_B, smem, s>>>(
        (const bf16*)x, (const bf16*)tiles, (const bf16*)bias3,
        (bf16*)h_out, B, H, ldx);
    return (int)cudaGetLastError();
  }
  return (int)cudaSuccess;
}

// How many clusters of kernel B (rows rows a block) the card holds at
// once; -1 where it cannot say.
int recnet_fused_step_tf32_clusters(int rows) {
  if (rows == 128)
    return active_clusters(gate_gemm_f32_kernel<128>, THREADS_BF,
                           GateF32<128>::SMEM, KP);
  if (rows == 32)
    return active_clusters(gate_gemm_f32_kernel<32>, THREADS_BF,
                           GateF32<32>::SMEM, KP);
  return -1;
}

// The W h launch's shared memory in bytes; the wrapper's
// attn_tf32_smem_bytes mirrors it.
long long recnet_fused_step_tf32_attn_smem(int H) {
  return (long long)WhSmem(H).total;
}

// The TF32 route, f32 throughout. kernels: 1 = kernel A (emb, h, enc, uv
// and the attention weights -> x, by W h and the scores in scratch, B x
// (A + L): three launches), 2 = kernel B (x, the f32 gate tiles and bias3
// -> h_out), 3 = all, in that order on `stream`. x is (B, ldx) with ldx =
// 8 ceil((E + F) / 8) + H; tiles as layout.gate_tiles_f32 makes them.
// rows_b: kernel B's rows a block (32 or 128, with 256 / rows_b unit
// tiles; h_out is bit-equal for each; the wrapper's gate_rows picks). Returns the first launch error.
int recnet_fused_step_tf32(int kernels, const float* emb, const float* h,
                           const float* enc, const float* uv,
                           const float* attn_W, const float* attn_w,
                           const float* attn_b, const float* tiles,
                           const float* bias3, float* x, float* scratch,
                           float* h_out, int B, int L, int F, int A, int E,
                           int H, int ldx, int frame_chunk, int rows_b,
                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || H % 16 != 0 || ldx % 8 != 0 || ldx <= H)
    return (int)cudaErrorInvalidValue;
  if (kernels & 1) {
    if (frame_chunk < 1 || L % frame_chunk != 0 ||
        ldx != (E + F + 7) / 8 * 8 + H)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        launch_attn_f32(emb, h, enc, uv, attn_W, attn_w, attn_b, x, scratch,
                        B, L, F, A, E, H, ldx, frame_chunk, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (kernels & 2) {
    if ((size_t)x % 16 != 0 || (size_t)tiles % 16 != 0)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaErrorInvalidValue;
    if (rows_b == 128)
      err = launch_gate_f32<128>(x, tiles, bias3, h_out, B, H, ldx, s);
    else if (rows_b == 32)
      err = launch_gate_f32<32>(x, tiles, bias3, h_out, B, H, ldx, s);
    return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
