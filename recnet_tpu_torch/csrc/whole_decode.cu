// Greedy whole-decode kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels whole_greedy_decode (K1, with its
// early_exit, dual and ablate variants, K5) and whole_greedy_decode_segment
// (K2) of recnet_tpu/ops/pallas/whole_decode.py (step body _make_step). One
// launch runs n_steps greedy steps for the whole batch from a carried state
// (h, c, token): K1 calls it with a zero state, <SOS> and n_steps = T; K2
// with the carried state and seg_len.
//
// Each step, per batch row: gather the embedding row of the current token
// (times embedding_scale; a token outside [0, V) reads a zero row, as the
// Pallas one-hot product does), unnormalised additive attention over the
// encoder features (score_f = w . tanh(W h + uv_f + b),
// ctx = sum_f score_f enc_f / L), a GRU (r,z,n) or LSTM (i,f,g,o) cell,
// logits = h' @ out_w + out_b in f32, and the first index of the maximum
// under the order-preserving int key of the logits (the Pallas kernel's
// argmax, which orders -0.0 < +0.0).
// Casts sit where _make_step has them: every product reads dtype operands
// and accumulates in f32; ctx is cast to dtype before its gate product;
// h (and the LSTM c) are computed in f32 and stored in dtype.
//
// What bounds it. On the TPU the ~16 MB of bf16 weights and an ~11 MB encoder
// tile sit in VMEM for the whole loop. A Hopper block has 227 KB of shared
// memory, so here the weights stay in the 50 MB L2 and every block streams
// them from L2 on every step: about 12 MB per block per step at the flagship
// width (w_ih 6.2 MB, out_w 4.3 MB, w_hh 1.6 MB in bf16), 48 GB of L2 reads
// per decode at B = 1024 (128 blocks x 31 steps). The products are 6.1 M
// multiply-adds per row and step (388.6 GFLOP a decode at B = 1024): 0.39
// ms at the tensor cores' bf16 peak, so the L2 read rate, not the
// arithmetic, sets the floor once the products run on the tensor cores.
// Each step also reads the rows' encoder features (88 MB at B = 1024) from
// device memory, since they do not fit in L2 beside the weights.
//
// Two bodies here, and a third for f32 in whole_decode_tf32.cu (its own
// library: three-term TF32 products on the tensor cores, an 8-row tile
// spread over a cluster at small batches); the wrapper
// (ops/cuda/whole_decode.py, kernel_route) picks one for each launch, and
// every K5 variant exists on the two here:
//
// * The tensor-core body (tc_decode_kernel, whole_decode_tc.cuh) runs
//   every bf16 launch with H a multiple of 16 unless cuda_cores asks for
//   the other: production K1/K2 and the early exit, instantiated here, and
//   the K5 probes dual and ablate, instantiated in whole_decode_probes.cu
//   (a source of their own, so that their 16 instantiations build beside
//   this file and not after it). A block owns TB = 8 batch rows, which are
//   the N = 8 of mma.sync m16n8k16 (bf16 in, f32 accumulators); the
//   weights are A, 16 output units x 16 inputs. A warp owns 16 hidden units
//   and runs every gate tile of them (r, z, n or i, f, g, o; w_ih x and
//   w_hh h in separate accumulators, as the GRU n gate needs), so each
//   accumulator element (unit, row) sits in one thread for every gate and
//   the cell runs in registers. The weights come as tiles: the wrapper
//   copies w_ih and w_hh, out_w and W once per parameter set into
//   tile-contiguous blocks ([unit tile][k16 step][gate][16 inputs][16
//   units], 12.2 MB at the flagship width in bf16), because in the JAX
//   input-major layout a tile's 16 rows lie a weight row apart and each
//   512-byte copy then touched 16 cache lines (K1 12.2 ms; 8.1 ms on the
//   tiles). Each warp streams its tiles L2 -> shared memory through its own
//   ring of 4 slots with 16-byte cp.async, a warp's copy reading 512
//   contiguous bytes, and ldmatrix.trans turns a [input][unit] tile into an
//   A fragment (the two 8-unit halves of a tile row are XOR-swizzled by
//   input row so the transposing reads are free of bank conflicts). Each
//   mma starts from a zero accumulator and its 16-term partial is added in
//   f32 on the CUDA cores (fresh_mma). The rows' x = [emb, ctx] and h are
//   bf16 in shared memory ([row][input], exact: bf16 mode rounds them to
//   bf16 anyway) and are the B fragments; zero tile rows past E + F meet
//   x's zero tail. The projection streams out_w's column tiles the same
//   way, 48 vocab columns per item (zero past V, masked), and the argmax
//   runs on the accumulator fragment (f32 logit = acc + out_b, the order
//   key, lowest index on ties), then a shuffle across the 8 lanes that
//   hold a row and a cross-warp reduction. W h takes the same pipeline, a
//   16-unit tile of A a warp (on CUDA cores it cost 1.2 ms of an 8.6 ms
//   decode). The ctx reads of enc take 8 features (16 bytes) a thread,
//   frames summed f = 0..L-1 in order, 4 in flight.
// * The CUDA-core body (whole_decode_kernel, below), the first design: f32
//   where the TF32 body does not take it (H not a multiple of 16, rows too
//   wide for its shared memory) and f32's probes, bf16 shapes the
//   tensor-core body does not take (H not a multiple of 16), and any
//   variant asked for with cuda_cores (the first design's production step
//   and its probes, kept as the redesigns' baseline). A
//   thread owns one hidden unit across all gates and each weight load
//   feeds TB = 8 f32 FMAs, one per row, from [k][TB] f32 row vectors in
//   shared memory.
//
// dual on the tensor-core body. The production step's blocks each read all
// 12.15 MB of weight tiles from L2 every step, so the L2 read stream bounds
// it (48.2 GB a decode at B = 1024). dual's block takes 16 rows as two
// 8-row halves that share each weight tile in shared memory (one copy,
// one ldmatrix.trans, two mma.sync back to back: the Pallas kernel's "A's
// matmul adjacent to B's"), which halves the L2 bytes a row (24.1 GB a
// decode). Its grid is half as wide (64 blocks at B = 1024 on 132 SMs).
// On an H100 80GB HBM3 at 700 W (flagship GRU, bf16) it takes production's
// time at B = 1024 (7.45-7.67 ms against 7.65-7.68) and 0.58 of it at
// B = 2048 (8.80-8.84 ms against 15.27-15.30, production in two waves of
// 128 blocks): what bounds the decode is each SM's own read stream, about
// 50 GB/s an SM, not the L2's aggregate rate, so sharing a tile pays only
// where it lets one wave of blocks hold more rows. An LSTM under dual
// takes a 3-slot ring to fit 16 rows beside it (whole_decode_tc.cuh,
// tc_slots).
//
// The K5 variants are compile-time variants of each body (template
// parameter VAR; VAR = 0 carries none of their code):
// * EARLY_EXIT: the block stops its step loop once every one of its real
//   rows has current token 0 (the Pallas per-tile while_loop; its tile is
//   this block's 8 rows). Every thread reads the flag after a barrier, so
//   the break is uniform across the block.
// * DUAL: the Hopper reading of the Pallas _dual_kernel's two row-halves.
//   On the tensor-core body, two 8-row halves sharing each weight tile (as
//   above). On the CUDA-core body, the block's two 4-row halves each run on
//   256 threads and sync on their own named barrier (bar.sync 1 / bar.sync
//   2), so one half's projection can overlap the other half's gates. Each
//   row's arithmetic is its body's production step's, so the tokens are
//   bit-identical to that body's production tokens.
// * ABL_*: the profiling stubs of _make_step (emb, attn / score1 / fma,
//   proj / nativeargmax / argmax), one part at a time, for cost attribution
//   by subtraction: full - variant on the tensor-core body splits the
//   production step by phase.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

#include "decode_common.cuh"
#include "whole_decode_tc.cuh"

namespace {

using recnet::load_rows;
using recnet::round_to;

// 8 loads in flight per k loop of the CUDA-core body; at 512 threads the
// registers stay under 128 with no spills
constexpr int UNROLL = 8;

// the barrier of a thread group: the whole block, or under DUAL one half
// on its own named barrier (ids 1 and 2; 0 is __syncthreads')
template <bool HALVES>
__device__ __forceinline__ void group_sync(int grp) {
  if constexpr (HALVES)
    asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "n"(THREADS / 2)
                 : "memory");
  else
    __syncthreads();
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

template <typename T, int NG, int VAR>
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
  constexpr bool HALVES = (VAR & DUAL) != 0;
  constexpr int RB = HALVES ? TB / 2 : TB;           // rows of a group
  constexpr int NT = HALVES ? THREADS / 2 : THREADS; // threads of a group
  constexpr int NW = NT / 32;
  constexpr int ATTN = (VAR >> ABL_ATTN_SHIFT) & 3;
  constexpr int PROJ = (VAR >> ABL_PROJ_SHIFT) & 3;

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

  // A thread group owns RB rows: the whole block, or under DUAL one half.
  // Its views of the shared arrays start at its first row rb.
  const int grp = HALVES ? (int)threadIdx.x / NT : 0;
  const int rb = grp * RB;
  const int tid = threadIdx.x - grp * NT;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TB + rb;
  float* x_g = x_s + rb;
  float* c_g = c_s + rb;
  float* wh_g = wh_s + (size_t)rb * A;
  float* sc_g = sc_s + (size_t)rb * L;
  int* key_g = red_key + rb;
  int* idx_g = red_idx + rb;
  int* tok_g = tok_s + rb;

  for (int i = tid; i < RB * H; i += NT) {
    const int b = i / H, j = i % H, row = row0 + b;
    const bool ok = row < B;
    h_s[j * TB + rb + b] = ok ? to_f(h0[(size_t)row * H + j]) : 0.f;
    c_g[j * TB + b] = ok ? to_f(c0[(size_t)row * H + j]) : 0.f;
  }
  if (tid < RB) tok_g[tid] = row0 + tid < B ? tok0[row0 + tid] : 0;
  group_sync<HALVES>(grp);

  int cur = 0;
  for (int t = 0; t < n_steps; ++t) {
    if constexpr ((VAR & EARLY_EXIT) != 0) {
      // the Pallas condition hard-codes token 0, not cfg.pad_token
      // (whole_decode.py:302); rows past B do not count
      bool stop = true;
#pragma unroll
      for (int b = 0; b < RB; ++b) stop &= row0 + b >= B || tok_g[b] == 0;
      if (stop) break;
    }
    const float* h_cur = h_s + (size_t)cur * H * TB + rb;
    float* h_nxt = h_s + (size_t)(cur ^ 1) * H * TB + rb;

    // 1. embedding row of the current token: an exact row read (equal to
    //    the Pallas one-hot product, which gives a zero row for a token
    //    outside [0, V)), times the scale, in dtype
    for (int i = tid; i < RB * E; i += NT) {
      const int b = i / E, k = i % E;
      float v = 0.f;
      if constexpr ((VAR & ABL_EMB) == 0) {
        const int tk = tok_g[b];
        if ((unsigned)tk < (unsigned)V)
          v = round_to<T>(to_f(emb[(size_t)tk * E + k]) * emb_scale);
      }
      x_g[k * TB + b] = v;
    }
    if constexpr (ATTN == 1) {
      // ablated attention: ctx = 0
      for (int i = tid; i < RB * F; i += NT)
        x_g[(E + i % F) * TB + i / F] = 0.f;
    } else {
      // 2. W h (RB x A), f32 accumulate
      for (int a = tid; a < A; a += NT) {
        float acc[RB] = {};
#pragma unroll UNROLL
        for (int k = 0; k < H; ++k) {
          float hv[RB];
          load_rows<RB>(h_cur + k * TB, hv);
          const float w = to_f(attn_W[(size_t)k * A + a]);
#pragma unroll
          for (int b = 0; b < RB; ++b) acc[b] += hv[b] * w;
        }
#pragma unroll
        for (int b = 0; b < RB; ++b) wh_g[b * A + a] = acc[b];
      }
      group_sync<HALVES>(grp);

      // 3. scores: one warp per (row, frame)
      for (int p = warp; p < RB * L; p += NW) {
        const int b = p / L, f = p % L, row = row0 + b;
        float s = 0.f;
        if (row < B) {
          const T* uvp = uv + ((size_t)row * L + f) * A;
          if constexpr (ATTN == 2) {   // score = act[0], no score matvec
            if (lane == 0)
              s = tanhf(wh_g[b * A] + to_f(uvp[0]) + to_f(attn_b[0]));
          } else {
            for (int a = lane; a < A; a += 32)
              s += tanhf(wh_g[b * A + a] + to_f(uvp[a]) + to_f(attn_b[a])) *
                   to_f(attn_w[a]);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) sc_g[b * L + f] = s;
      }
      group_sync<HALVES>(grp);

      // 4. ctx = sum_f score_f enc_f / L in f32, then cast to dtype
      for (int i = tid; i < RB * F; i += NT) {
        const int b = i / F, e = i % F, row = row0 + b;
        float acc = 0.f;
        if constexpr (ATTN == 3) {     // ctx = sum_f score_f, no enc, no / L
          for (int f = 0; f < L; ++f) acc += sc_g[b * L + f];
          x_g[(E + e) * TB + b] = round_to<T>(acc);
        } else {
          if (row < B) {
            const T* ep = enc + (size_t)row * L * F + e;
#pragma unroll 4
            for (int f = 0; f < L; ++f)
              acc += sc_g[b * L + f] * to_f(ep[(size_t)f * F]);
          }
          x_g[(E + e) * TB + b] = round_to<T>(acc / (float)L);
        }
      }
    }
    group_sync<HALVES>(grp);

    // 5. gates and cell: thread owns hidden unit j in every gate
    for (int j = tid; j < H; j += NT) {
      float gi[NG][RB] = {}, gh[NG][RB] = {};
#pragma unroll UNROLL
      for (int k = 0; k < K; ++k) {
        float xv[RB];
        load_rows<RB>(x_g + k * TB, xv);
        const T* wr = w_ih + (size_t)k * G + j;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float w = to_f(wr[g * H]);
#pragma unroll
          for (int b = 0; b < RB; ++b) gi[g][b] += xv[b] * w;
        }
      }
#pragma unroll UNROLL
      for (int k = 0; k < H; ++k) {
        float hv[RB];
        load_rows<RB>(h_cur + k * TB, hv);
        const T* wr = w_hh + (size_t)k * G + j;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float w = to_f(wr[g * H]);
#pragma unroll
          for (int b = 0; b < RB; ++b) gh[g][b] += hv[b] * w;
        }
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float bi = to_f(bias2[g * H + j]);
        const float bh = to_f(bias2[G + g * H + j]);
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          gi[g][b] += bi;
          gh[g][b] += bh;
        }
      }
#pragma unroll
      for (int b = 0; b < RB; ++b) {
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
          const float c = fg * c_g[j * TB + b] + ig * gg;
          h_nxt[j * TB + b] = round_to<T>(og * tanhf(c));
          c_g[j * TB + b] = round_to<T>(c);
        }
      }
    }
    group_sync<HALVES>(grp);

    // 6. logits in f32 and the first index of the max key, per row
    if constexpr (PROJ == 1) {         // ablated projection: token stays
      if (tid < RB && row0 + tid < B)
        tokens[(size_t)(row0 + tid) * n_steps + t] = tok_g[tid];
    } else {
      int best_key[RB], best_idx[RB];
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        best_key[b] = INT_MIN;
        best_idx[b] = INT_MAX;
      }
      for (int v = tid; v < V; v += NT) {
        float acc[RB] = {};
#pragma unroll UNROLL
        for (int k = 0; k < H; ++k) {
          float hv[RB];
          load_rows<RB>(h_nxt + k * TB, hv);
          const float w = to_f(out_w[(size_t)k * V + v]);
#pragma unroll
          for (int b = 0; b < RB; ++b) acc[b] += hv[b] * w;
        }
        const float bv = to_f(out_b[v]);
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          float logit = acc[b] + bv;
          // a float argmax ties -0.0 with +0.0
          if constexpr (PROJ == 2) logit = logit == 0.f ? 0.f : logit;
          const int key = order_key(logit);
          if (key_wins(key, v, best_key[b], best_idx[b])) {
            best_key[b] = key;
            best_idx[b] = v;
          }
        }
      }
#pragma unroll
      for (int b = 0; b < RB; ++b) {
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
          key_g[warp * TB + b] = k;
          idx_g[warp * TB + b] = i;
        }
      }
      group_sync<HALVES>(grp);
      if (tid < RB) {
        int k = key_g[tid], i = idx_g[tid];
        for (int w = 1; w < NW; ++w) {
          if (key_wins(key_g[w * TB + tid], idx_g[w * TB + tid], k, i)) {
            k = key_g[w * TB + tid];
            i = idx_g[w * TB + tid];
          }
        }
        // ablated argmax: the token is int(max logit), often outside [0, V)
        if constexpr (PROJ == 3) i = (int)__int_as_float(order_key(
                                         __int_as_float(k)));
        tok_g[tid] = i;
        if (row0 + tid < B) tokens[(size_t)(row0 + tid) * n_steps + t] = i;
      }
    }
    group_sync<HALVES>(grp);
    cur ^= 1;
  }

  const float* h_fin = h_s + (size_t)cur * H * TB + rb;
  for (int i = tid; i < RB * H; i += NT) {
    const int b = i / H, j = i % H, row = row0 + b;
    if (row < B) {
      h_out[(size_t)row * H + j] = from_f<T>(h_fin[j * TB + b]);
      c_out[(size_t)row * H + j] = from_f<T>(c_g[j * TB + b]);
    }
  }
  if (tid < RB && row0 + tid < B) tok_out[row0 + tid] = tok_g[tid];
}

template <typename T, int NG, int VAR>
int launch(const Operands& o, cudaStream_t stream) {
  const size_t smem = smem_bytes(o.L, o.F, o.A, o.E, o.H);
  auto kernel = whole_decode_kernel<T, NG, VAR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((o.B + TB - 1) / TB);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)o.enc, (const T*)o.uv, (const T*)o.emb, (const T*)o.attn_W,
      (const T*)o.attn_w, (const T*)o.attn_b, (const T*)o.w_ih,
      (const T*)o.w_hh, (const T*)o.bias2, (const T*)o.out_w,
      (const T*)o.out_b, (const T*)o.h0, (const T*)o.c0, o.tok0, o.tokens,
      (T*)o.h_out, (T*)o.c_out, o.tok_out, o.B, o.L, o.F, o.A, o.E, o.H,
      o.V, o.n_steps, o.emb_scale);
  return (int)cudaGetLastError();
}

// the CUDA-core body's built variants: production, early exit, dual, and
// one ablated part
template <typename T, int NG>
int launch_variant(int variant, const Operands& o, cudaStream_t s) {
  switch (variant) {
    case 0: return launch<T, NG, 0>(o, s);
    case EARLY_EXIT: return launch<T, NG, EARLY_EXIT>(o, s);
    case DUAL: return launch<T, NG, DUAL>(o, s);
    case ABL_EMB: return launch<T, NG, ABL_EMB>(o, s);
    case 1 << ABL_ATTN_SHIFT: return launch<T, NG, 1 << ABL_ATTN_SHIFT>(o, s);
    case 2 << ABL_ATTN_SHIFT: return launch<T, NG, 2 << ABL_ATTN_SHIFT>(o, s);
    case 3 << ABL_ATTN_SHIFT: return launch<T, NG, 3 << ABL_ATTN_SHIFT>(o, s);
    case 1 << ABL_PROJ_SHIFT: return launch<T, NG, 1 << ABL_PROJ_SHIFT>(o, s);
    case 2 << ABL_PROJ_SHIFT: return launch<T, NG, 2 << ABL_PROJ_SHIFT>(o, s);
    case 3 << ABL_PROJ_SHIFT: return launch<T, NG, 3 << ABL_PROJ_SHIFT>(o, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the tensor-core body's production step and early exit, on the weight
// tiles (the probes are whole_decode_probes.cu's)
template <int NG>
int launch_bf16_tc(int variant, const Operands& o, cudaStream_t s) {
  if (variant == TENSOR_CORES) return launch_tc<NG, 0>(o, s);
  if (variant == (TENSOR_CORES | EARLY_EXIT))
    return launch_tc<NG, EARLY_EXIT>(o, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* recnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The width of out_w's column groups in the tensor-core body's weight tiles.
int recnet_whole_decode_out_group() { return 16 * PT; }

// The tensor-core body's shared memory in bytes for n_gates and a variant
// (the TENSOR_CORES bit ignored), K = E + F; the wrapper's tc_smem_bytes
// mirrors it.
long long recnet_whole_decode_tc_smem(int n_gates, int variant, int L, int A,
                                      int K, int H) {
  return (long long)tc_smem(n_gates, variant, L, A, K, H);
}

// dtype: 0 = float32, 1 = bfloat16; n_gates: 3 = GRU, 4 = LSTM; variant:
// 0 for K1/K2, else the K5 variant bits (EARLY_EXIT, DUAL, one ABL_ part),
// all on the CUDA-core body; bf16 TENSOR_CORES (| EARLY_EXIT) runs the
// tensor-core body, which reads the weight tiles in place of the matrices:
// w_ih holds the gate tiles [H / 16][nKx + nKh][n_gates][16][16] (w_ih's
// rows zero-padded to nKx * 16, then w_hh's rows; nKx = ceil((E + F) / 16),
// nKh = H / 16), out_w the column tiles [ceil(V / out_group)][H / 16]
// [out_group / 16][16][16] (columns zero-padded), attn_W the column tiles
// of W with groups of 16 columns, and w_hh is not read. The tensor-core
// probes (TENSOR_CORES | DUAL or an ABL_ part) are
// recnet_whole_decode_probe's, in whole_decode_probes.cu.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int recnet_whole_decode(int dtype, int n_gates, int variant, const void* enc,
                        const void* uv, const void* emb, const void* attn_W,
                        const void* attn_w, const void* attn_b,
                        const void* w_ih, const void* w_hh, const void* bias2,
                        const void* out_w, const void* out_b, const void* h0,
                        const void* c0, const int* tok0, int* tokens,
                        void* h_out, void* c_out, int* tok_out, int B, int L,
                        int F, int A, int E, int H, int V, int n_steps,
                        float emb_scale, void* stream) {
  const Operands o{enc,   uv,   emb,   attn_W, attn_w, attn_b, w_ih,
                   w_hh,  bias2, out_w, out_b, h0,     c0,     tok0,
                   tokens, h_out, c_out, tok_out, B,   L,      F,
                   A,     E,    H,     V,      n_steps, emb_scale};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool tc = (variant & TENSOR_CORES) != 0;
  if (dtype == 1 && tc)
    return n_gates == 3 ? launch_bf16_tc<3>(variant, o, s)
         : n_gates == 4 ? launch_bf16_tc<4>(variant, o, s)
                        : (int)cudaErrorInvalidValue;
  if (tc) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && n_gates == 3) return launch_variant<float, 3>(variant, o, s);
  if (dtype == 0 && n_gates == 4) return launch_variant<float, 4>(variant, o, s);
  if (dtype == 1 && n_gates == 3)
    return launch_variant<__nv_bfloat16, 3>(variant, o, s);
  if (dtype == 1 && n_gates == 4)
    return launch_variant<__nv_bfloat16, 4>(variant, o, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
