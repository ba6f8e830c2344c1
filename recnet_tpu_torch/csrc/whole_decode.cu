// Greedy whole-decode kernel for NVIDIA Hopper (sm_90a).
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
// Two bodies share the entry point:
//
// * The tensor-core body (tc_decode_kernel): bf16 K1, K2 and the early
//   exit, the production path. A block owns TB = 8 batch rows, which are
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
// * The CUDA-core body (whole_decode_kernel), the first design: f32 (no
//   TF32, so the f32 tokens equal the plain twin's), the K5 probes dual and
//   ablate, the bf16 production step under cuda_cores (the baseline ablate
//   subtracts from), and bf16 shapes the tensor-core body does not take (H
//   not a multiple of 16); the wrapper picks the body. A thread owns one
//   hidden unit across all gates and each weight load feeds TB = 8 f32 FMAs,
//   one per row, from [k][TB] f32 row vectors in shared memory.
//
// Next step (ROADMAP): a cluster of 2 blocks with TMA multicast of each
// weight tile, so that one L2 read feeds 16 rows.
//
// The K5 variants of the CUDA-core body are compile-time variants (template
// parameter VAR; VAR = 0 carries none of their code):
// * EARLY_EXIT: the block stops its step loop once every one of its real
//   rows has current token 0 (the Pallas per-tile while_loop; its tile is
//   this block's 8 rows). Every thread reads the flag after a barrier, so
//   the break is uniform across the block.
// * DUAL: the Hopper reading of the Pallas _dual_kernel's two row-halves.
//   The block's two 4-row halves each run on 256 threads and sync on their
//   own named barrier (bar.sync 1 / bar.sync 2), so one half's projection
//   can overlap the other half's gates. Each row's arithmetic is the
//   production step's, so the tokens are bit-identical.
// * ABL_*: the profiling stubs of _make_step (emb, attn / score1 / fma,
//   proj / nativeargmax / argmax), one part at a time, for cost attribution
//   by subtraction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

#include "decode_common.cuh"
#include "hopper_mma.cuh"

namespace {

using recnet::from_f;
using recnet::load_rows;
using recnet::round_to;
using recnet::sigmoid;
using recnet::to_f;

constexpr int TB = 8;          // batch rows per block
// 16 warps and 8 loads in flight per k loop keep enough L2 requests
// outstanding; at 512 threads the registers stay under 128 with no spills
constexpr int THREADS = 512;
constexpr int UNROLL = 8;
constexpr int NWARPS = THREADS / 32;

// variant bits (VAR); the wrapper builds the same code
constexpr int EARLY_EXIT = 1;
constexpr int DUAL = 2;
constexpr int ABL_EMB = 4;          // zero embedding
constexpr int ABL_ATTN_SHIFT = 3;   // 1 zero ctx, 2 score = act[0],
                                    // 3 ctx = sum_f score_f (no enc, no / L)
constexpr int ABL_PROJ_SHIFT = 5;   // 1 the token stays, 2 float first-max
                                    // argmax, 3 token = int(max logit)
constexpr int TENSOR_CORES = 256;   // bf16 K1/K2 and early exit: the
                                    // tensor-core body

// order-preserving f32 -> int32 key (whole_decode.py:251-252); the map is
// its own inverse
__device__ __forceinline__ int order_key(float x) {
  int bits = __float_as_int(x);
  return bits ^ ((bits >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ bool key_wins(int k, int i, int bk, int bi) {
  return k > bk || (k == bk && i < bi);
}

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

// ---------------------------------------------------------------------------
// the tensor-core body (bf16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using recnet::cp_async16;
using recnet::ldmatrix_x2;
using recnet::ldmatrix_x4;
using recnet::mma_bf16;

constexpr int PT = 3;        // 16-column tiles of out_w per projection item
constexpr int TILE = 256;    // bf16 elements of a 16 x 16 weight tile

// Slots of each warp's cp.async ring (3 items in flight); on the weight
// tiles deeper rings gained nothing for the GRU (kernel_probes.py).
constexpr int RING_SLOTS = 4;

// row stride (elements) of the rows' bf16 vectors in shared memory: whole
// k16 steps, then +8 so that the 8 rows' 16-byte ldmatrix reads fall in
// distinct banks (a stride of 16 bytes modulo 128)
__host__ __device__ inline int padded_ld(int n) {
  return (n + 63) / 64 * 64 + 8;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// byte offsets of the tensor-core body's shared arrays
struct TcSmem {
  int xld, hld;
  size_t x, h, c, wh, att, sc, red, tok, ring, total;
  __host__ __device__ TcSmem(int L, int A, int K, int H, int NG) {
    xld = padded_ld(K);
    hld = padded_ld(H);
    size_t o = 0;
    x = o;   o = align16(o + sizeof(bf16) * TB * xld);          // [TB][xld]
    h = o;   o = align16(o + sizeof(bf16) * 2 * TB * hld);      // [2][TB][hld]
    c = o;   o = align16(o + sizeof(bf16) * TB * H);            // [TB][H]
    wh = o;  o = align16(o + sizeof(float) * TB * A);           // [TB][A]
    att = o; o = align16(o + sizeof(float) * 2 * A);            // w, b
    sc = o;  o = align16(o + sizeof(float) * TB * L);           // [TB][L]
    red = o; o = align16(o + sizeof(int) * 2 * NWARPS * TB);
    tok = o; o = align16(o + sizeof(int) * TB);
    ring = o;
    total = o + sizeof(bf16) * NWARPS * RING_SLOTS * NG * TILE;
  }
};

// d = one k16 slice of A B, from a zero accumulator. The callers add d to
// their sums in IEEE f32 on the CUDA cores: the tensor cores' own f32
// accumulation across slices rounds less exactly, and with it the bf16
// tokens of the flagship decode agreed with the twin's on 97.5% (GRU)
// where the CUDA-core body's do on 98.4-98.9%; this way on 98.8-99.0%.
__device__ __forceinline__ void fresh_mma(float d[4], const unsigned a[4],
                                          const unsigned b[2]) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  mma_bf16(d, a, b);
}

// A warp's software pipeline over n items: issue(slot) starts the copies
// of the next item into a ring slot, consume(slot) multiplies the item in
// a slot; STAGES - 1 items stay in flight. Every item commits one cp.async
// group (empty past n), so wait_group<STAGES - 2> means "item i arrived".
template <int STAGES, typename Issue, typename Consume>
__device__ __forceinline__ void warp_pipeline(int n, Issue& issue,
                                              Consume& consume) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) issue(s);
    recnet::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    recnet::cp_async_wait<STAGES - 2>();
    __syncwarp();   // every lane's copies landed; slot i - 1 was read
    if (i + STAGES - 1 < n) issue((i + STAGES - 1) % STAGES);
    recnet::cp_async_commit();
    consume(i % STAGES);
  }
}

template <int NG, bool EARLY>
__global__ void __launch_bounds__(THREADS, 1)
tc_decode_kernel(const bf16* __restrict__ enc, const bf16* __restrict__ uv,
                 const bf16* __restrict__ emb, const bf16* __restrict__ wa,
                 const bf16* __restrict__ attn_w,
                 const bf16* __restrict__ attn_b,
                 const bf16* __restrict__ wg, const bf16* __restrict__ bias2,
                 const bf16* __restrict__ wo,
                 const bf16* __restrict__ out_b, const bf16* __restrict__ h0,
                 const bf16* __restrict__ c0, const int* __restrict__ tok0,
                 int* __restrict__ tokens, bf16* __restrict__ h_out,
                 bf16* __restrict__ c_out, int* __restrict__ tok_out, int B,
                 int L, int F, int A, int E, int H, int V, int n_steps,
                 float emb_scale, int vec_enc) {
  extern __shared__ float4 smem_f4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_f4);
  const int K = E + F;
  const int G = NG * H;
  const TcSmem lay(L, A, K, H, NG);
  const int xld = lay.xld, hld = lay.hld;
  bf16* x_s = reinterpret_cast<bf16*>(sm + lay.x);
  bf16* h_s = reinterpret_cast<bf16*>(sm + lay.h);
  bf16* c_s = reinterpret_cast<bf16*>(sm + lay.c);      // bf16, as stored
  float* wh_s = reinterpret_cast<float*>(sm + lay.wh);
  float* sc_s = reinterpret_cast<float*>(sm + lay.sc);
  float* aw_s = reinterpret_cast<float*>(sm + lay.att);  // attn w, then b
  int* red_key = reinterpret_cast<int*>(sm + lay.red);  // [NWARPS][TB]
  int* red_idx = red_key + NWARPS * TB;
  int* tok_s = reinterpret_cast<int*>(sm + lay.tok);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TB;
  bf16* ring = reinterpret_cast<bf16*>(sm + lay.ring)
               + (size_t)warp * RING_SLOTS * NG * TILE;

  // fragment coordinates of this lane. Accumulator element e holds unit
  // g + 8 (e / 2) of the tile and row 2 t4 + e % 2.
  const int g = lane >> 2, t4 = lane & 3;
  // ldmatrix.trans row of a swizzled [16 inputs][16 units] tile: lanes
  // 0-7 / 8-15 / 16-23 / 24-31 read inputs 0-7 / 0-7 / 8-15 / 8-15 at
  // units 0-7 / 8-15 / 0-7 / 8-15 (a[0..3])
  const int a_k = (lane & 7) + ((lane >> 4) << 3);
  const int a_off = a_k * 16 + ((((lane >> 3) & 1) ^ ((a_k >> 2) & 1)) << 3);
  // ldmatrix row of the rows' vectors: row lane % 8, inputs +8 for 8-15
  const int b_row = lane & 7, b_k = ((lane >> 3) & 1) << 3;
  // this lane's 16-byte chunk of a tile (row-major [16 inputs][16 units]
  // in the weight tiles): input lane / 2, units +8 if odd, swizzled
  const int c_k = lane >> 1;
  const int c_off = c_k * 16 + (((lane & 1) ^ ((c_k >> 2) & 1)) << 3);

  for (int i = tid; i < TB * xld; i += THREADS) x_s[i] = from_f<bf16>(0.f);
  for (int i = tid; i < TB * H; i += THREADS) {
    const int b = i / H, j = i % H, row = row0 + b;
    const bool ok = row < B;
    h_s[b * hld + j] = ok ? h0[(size_t)row * H + j] : from_f<bf16>(0.f);
    c_s[i] = ok ? c0[(size_t)row * H + j] : from_f<bf16>(0.f);
  }
  if (tid < TB) tok_s[tid] = row0 + tid < B ? tok0[row0 + tid] : 0;
  for (int a = tid; a < A; a += THREADS) {
    aw_s[a] = to_f(attn_w[a]);
    aw_s[A + a] = to_f(attn_b[a]);
  }
  __syncthreads();

  const int nKx = (K + 15) / 16, nKh = H / 16, nKg = nKx + nKh;
  const int n_vg = (V + 16 * PT - 1) / (16 * PT);
  const int n_at = (A + 15) / 16;   // 16-unit tiles of W h
  int cur = 0;
  for (int t = 0; t < n_steps; ++t) {
    if constexpr (EARLY) {
      // the Pallas condition hard-codes token 0 (whole_decode.py:302)
      bool stop = true;
#pragma unroll
      for (int b = 0; b < TB; ++b) stop &= row0 + b >= B || tok_s[b] == 0;
      if (stop) break;
    }
    const bf16* hc = h_s + (size_t)cur * TB * hld;
    bf16* hn = h_s + (size_t)(cur ^ 1) * TB * hld;

    // 1. embedding rows (a zero row outside [0, V)), scaled, in bf16; and
    //    W h on tensor cores, one 16-unit tile of A a warp
    for (int i = tid; i < TB * E; i += THREADS) {
      const int b = i / E, k = i % E, tk = tok_s[b];
      float v = 0.f;
      if ((unsigned)tk < (unsigned)V)
        v = to_f(emb[(size_t)tk * E + k]) * emb_scale;
      x_s[b * xld + k] = from_f<bf16>(v);
    }
    {
      float acc[4] = {};
      const int n_items = (n_at - warp + NWARPS - 1) / NWARPS * nKh;
      int is = 0, iu = warp;
      auto issue = [&](int slot) {
        cp_async16(ring + slot * (NG * TILE) + c_off,
                   wa + (size_t)(iu * nKh + is) * TILE + lane * 8);
        if (++is == nKh) {
          is = 0;
          iu += NWARPS;
        }
      };
      int cs = 0, cu = warp;
      auto consume = [&](int slot) {
        unsigned bfr[2], af[4];
        ldmatrix_x2(bfr, hc + b_row * hld + cs * 16 + b_k);
        ldmatrix_x4<true>(af, ring + slot * (NG * TILE) + a_off);
        float d[4];
        fresh_mma(d, af, bfr);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += d[e];
        if (++cs < nKh) return;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int a = cu * 16 + g + (e >> 1) * 8;
          if (a < A) wh_s[(2 * t4 + (e & 1)) * A + a] = acc[e];
          acc[e] = 0.f;
        }
        cs = 0;
        cu += NWARPS;
      };
      warp_pipeline<RING_SLOTS>(n_items, issue, consume);
    }
    __syncthreads();

    // 2. scores: one warp per (row, frame), two in flight
#pragma unroll 2
    for (int p = warp; p < TB * L; p += NWARPS) {
      const int b = p / L, f = p % L, row = row0 + b;
      float s = 0.f;
      if (row < B) {
        const bf16* uvp = uv + ((size_t)row * L + f) * A;
        for (int a = lane; a < A; a += 32) {
          s += tanhf(wh_s[b * A + a] + to_f(uvp[a]) + aw_s[A + a]) * aw_s[a];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) sc_s[b * L + f] = s;
    }
    __syncthreads();

    // 3. ctx = sum_f score_f enc_f / L in f32 (f in order), cast to bf16
    if (vec_enc) {   // 8 features, 16 bytes, a load
      const int F8 = F / 8;
      for (int i = tid; i < TB * F8; i += THREADS) {
        const int b = i / F8, e0 = (i % F8) * 8, row = row0 + b;
        float acc[8] = {};
        if (row < B) {
          const bf16* ep = enc + (size_t)row * L * F + e0;
#pragma unroll 4
          for (int f = 0; f < L; ++f) {
            const uint4 raw =
                *reinterpret_cast<const uint4*>(ep + (size_t)f * F);
            const bf16* v = reinterpret_cast<const bf16*>(&raw);
            const float s = sc_s[b * L + f];
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[q] += s * to_f(v[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < 8; ++q)
          x_s[b * xld + E + e0 + q] = from_f<bf16>(acc[q] / (float)L);
      }
    } else {
      for (int i = tid; i < TB * F; i += THREADS) {
        const int b = i / F, e = i % F, row = row0 + b;
        float acc = 0.f;
        if (row < B) {
          const bf16* ep = enc + (size_t)row * L * F + e;
#pragma unroll 4
          for (int f = 0; f < L; ++f)
            acc += sc_s[b * L + f] * to_f(ep[(size_t)f * F]);
        }
        x_s[b * xld + E + e] = from_f<bf16>(acc / (float)L);
      }
    }
    __syncthreads();

    // 4. gates on tensor cores: the warp's unit tiles ut = warp, warp +
    //    NWARPS, ..., each nKx k16 steps of w_ih x, then nKh of w_hh h
    {
      float ai[NG][4] = {}, ah[NG][4] = {};
      const int n_ut = H / 16;
      const int n_items = (n_ut - warp + NWARPS - 1) / NWARPS * nKg;
      int is = 0, iu = warp;
      auto issue = [&](int slot) {   // 512 contiguous bytes a gate
        const bf16* src = wg + (size_t)(iu * nKg + is) * NG * TILE + lane * 8;
        bf16* dst = ring + slot * (NG * TILE) + c_off;
#pragma unroll
        for (int gt = 0; gt < NG; ++gt)
          cp_async16(dst + gt * TILE, src + gt * TILE);
        if (++is == nKg) {
          is = 0;
          iu += NWARPS;
        }
      };
      int cs = 0, cu = warp;
      auto consume = [&](int slot) {
        const bool hp = cs >= nKx;
        unsigned bfr[2];
        ldmatrix_x2(bfr, hp ? hc + b_row * hld + (cs - nKx) * 16 + b_k
                            : x_s + b_row * xld + cs * 16 + b_k);
        const bf16* tile = ring + slot * (NG * TILE) + a_off;
#pragma unroll
        for (int gt = 0; gt < NG; ++gt) {
          unsigned af[4];
          ldmatrix_x4<true>(af, tile + gt * TILE);
          float d[4];
          fresh_mma(d, af, bfr);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (hp)
              ah[gt][e] += d[e];
            else
              ai[gt][e] += d[e];
          }
        }
        if (++cs < nKg) return;
        // the cell of units cu * 16.., in registers
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = cu * 16 + g + (e >> 1) * 8, b = 2 * t4 + (e & 1);
          float gi[NG], gh[NG];
#pragma unroll
          for (int gt = 0; gt < NG; ++gt) {
            gi[gt] = ai[gt][e] + to_f(bias2[gt * H + j]);
            gh[gt] = ah[gt][e] + to_f(bias2[G + gt * H + j]);
            ai[gt][e] = ah[gt][e] = 0.f;
          }
          if constexpr (NG == 3) {  // GRU
            const float r = sigmoid(gi[0] + gh[0]);
            const float z = sigmoid(gi[1] + gh[1]);
            const float n = tanhf(gi[2] + r * gh[2]);
            hn[b * hld + j] =
                from_f<bf16>((1.0f - z) * n + z * to_f(hc[b * hld + j]));
          } else {                  // LSTM
            const float ig = sigmoid(gi[0] + gh[0]);
            const float fg = sigmoid(gi[1] + gh[1]);
            const float gg = tanhf(gi[2] + gh[2]);
            const float og = sigmoid(gi[3] + gh[3]);
            const float c = fg * to_f(c_s[b * H + j]) + ig * gg;
            hn[b * hld + j] = from_f<bf16>(og * tanhf(c));
            c_s[b * H + j] = from_f<bf16>(c);
          }
        }
        cs = 0;
        cu += NWARPS;
      };
      warp_pipeline<RING_SLOTS>(n_items, issue, consume);
    }
    __syncthreads();

    // 5. logits = h' @ out_w + out_b on tensor cores, PT column tiles an
    //    item, and a running (max key, first index) of the thread's two
    //    rows over the accumulator fragments
    int best_key[2] = {INT_MIN, INT_MIN}, best_idx[2] = {INT_MAX, INT_MAX};
    {
      float acc[PT][4] = {};
      const int n_items = (n_vg - warp + NWARPS - 1) / NWARPS * nKh;
      int is = 0, iv = warp;
      auto issue = [&](int slot) {
        const bf16* src = wo + (size_t)(iv * nKh + is) * PT * TILE + lane * 8;
        bf16* dst = ring + slot * (NG * TILE) + c_off;
#pragma unroll
        for (int p = 0; p < PT; ++p) cp_async16(dst + p * TILE, src + p * TILE);
        if (++is == nKh) {
          is = 0;
          iv += NWARPS;
        }
      };
      int cs = 0, cv = warp;
      auto consume = [&](int slot) {
        unsigned bfr[2];
        ldmatrix_x2(bfr, hn + b_row * hld + cs * 16 + b_k);
        const bf16* tile = ring + slot * (NG * TILE) + a_off;
#pragma unroll
        for (int p = 0; p < PT; ++p) {
          unsigned af[4];
          ldmatrix_x4<true>(af, tile + p * TILE);
          float d[4];
          fresh_mma(d, af, bfr);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][e] += d[e];
        }
        if (++cs < nKh) return;
#pragma unroll
        for (int p = 0; p < PT; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int v = (cv * PT + p) * 16 + g + (e >> 1) * 8;
            if (v < V) {
              const int key = order_key(acc[p][e] + to_f(out_b[v]));
              const int q = e & 1;
              if (key_wins(key, v, best_key[q], best_idx[q])) {
                best_key[q] = key;
                best_idx[q] = v;
              }
            }
            acc[p][e] = 0.f;
          }
        cs = 0;
        cv += NWARPS;
      };
      warp_pipeline<RING_SLOTS>(n_items, issue, consume);
    }
    // the 8 lanes with the same t4 hold rows 2 t4 and 2 t4 + 1
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      int k = best_key[q], i = best_idx[q];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const int k2 = __shfl_xor_sync(0xffffffffu, k, off);
        const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
        if (key_wins(k2, i2, k, i)) {
          k = k2;
          i = i2;
        }
      }
      if (g == 0) {
        red_key[warp * TB + 2 * t4 + q] = k;
        red_idx[warp * TB + 2 * t4 + q] = i;
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

  const bf16* h_fin = h_s + (size_t)cur * TB * hld;
  for (int i = tid; i < TB * H; i += THREADS) {
    const int b = i / H, j = i % H, row = row0 + b;
    if (row < B) {
      h_out[(size_t)row * H + j] = h_fin[b * hld + j];
      c_out[(size_t)row * H + j] = c_s[i];
    }
  }
  if (tid < TB && row0 + tid < B) tok_out[row0 + tid] = tok_s[tid];
}

// the launch's operands, as the C entry point takes them
struct Operands {
  const void *enc, *uv, *emb, *attn_W, *attn_w, *attn_b, *w_ih, *w_hh,
      *bias2, *out_w, *out_b, *h0, *c0;
  const int* tok0;
  int* tokens;
  void *h_out, *c_out;
  int* tok_out;
  int B, L, F, A, E, H, V, n_steps;
  float emb_scale;
};

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

// the built variants: production, early exit, dual, and one ablated part
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

template <int NG, bool EARLY>
int launch_tc(const Operands& o, cudaStream_t stream) {
  const size_t smem = TcSmem(o.L, o.A, o.E + o.F, o.H, NG).total;
  auto kernel = tc_decode_kernel<NG, EARLY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_enc = o.F % 8 == 0 && (size_t)o.enc % 16 == 0;
  const dim3 grid((o.B + TB - 1) / TB);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const bf16*)o.enc, (const bf16*)o.uv, (const bf16*)o.emb,
      (const bf16*)o.attn_W, (const bf16*)o.attn_w, (const bf16*)o.attn_b,
      (const bf16*)o.w_ih, (const bf16*)o.bias2, (const bf16*)o.out_w,
      (const bf16*)o.out_b, (const bf16*)o.h0, (const bf16*)o.c0, o.tok0,
      o.tokens, (bf16*)o.h_out, (bf16*)o.c_out, o.tok_out, o.B, o.L, o.F,
      o.A, o.E, o.H, o.V, o.n_steps, o.emb_scale, vec_enc);
  return (int)cudaGetLastError();
}

// the tensor-core body: production or the early exit, on the weight tiles
template <int NG>
int launch_bf16_tc(int variant, const Operands& o, cudaStream_t s) {
  if (o.H % 16 != 0 || (size_t)o.w_ih % 16 != 0 || (size_t)o.out_w % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (variant == TENSOR_CORES) return launch_tc<NG, false>(o, s);
  if (variant == (TENSOR_CORES | EARLY_EXIT)) return launch_tc<NG, true>(o, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* recnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The width of out_w's column groups in the tensor-core body's weight tiles.
int recnet_whole_decode_out_group() { return 16 * PT; }

// dtype: 0 = float32, 1 = bfloat16; n_gates: 3 = GRU, 4 = LSTM; variant:
// 0 for K1/K2, else the K5 variant bits (EARLY_EXIT, DUAL, one ABL_ part),
// all on the CUDA-core body; bf16 TENSOR_CORES (| EARLY_EXIT) runs the
// tensor-core body, which reads the weight tiles in place of the matrices:
// w_ih holds the gate tiles [H / 16][nKx + nKh][n_gates][16][16] (w_ih's
// rows zero-padded to nKx * 16, then w_hh's rows; nKx = ceil((E + F) / 16),
// nKh = H / 16), out_w the column tiles [ceil(V / out_group)][H / 16]
// [out_group / 16][16][16] (columns zero-padded), attn_W the column tiles
// of W with groups of 16 columns, and w_hh is not read.
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
