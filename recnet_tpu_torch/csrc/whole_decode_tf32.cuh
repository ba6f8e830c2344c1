// The TF32 body of the f32 greedy whole decode (sm_90a), shared by
// whole_decode_tf32.cu (production K1/K2 and the early exit) and
// whole_decode_tf32_probes.cu (the K5 probes dual and ablate), as
// whole_decode_tc.cuh is for the bf16 body.
//
// It replaces, for f32 operands, the Pallas TPU kernels whole_greedy_decode
// (K1 and its K5 variants) and whole_greedy_decode_segment (K2) of
// recnet_tpu/ops/pallas/whole_decode.py (step body _make_step, the dual
// kernel _dual_kernel): n_steps greedy steps for 8-row tiles of the batch
// from a carried state (h, c, token), each step the embedding row (times
// embedding_scale; a zero row for a token outside [0, V)), the
// unnormalised additive attention (score_f = w . tanh(W h + uv_f + b), ctx
// = sum_f score_f enc_f / L), the GRU (r, z, n) or LSTM (i, f, g, o) cell,
// logits = h' @ out_w + out_b and the first index of the maximum under the
// order-preserving int key. Every product reads f32 operands, every sum is
// f32, h and c are f32, as _make_step computes them in f32 mode.
// whole_decode.cu's header says the same of its two bf16-era bodies; its
// CUDA-core body, the first design, stays the baseline of this one
// (cuda_cores).
//
// What bounds it. The f32 weights are 6.07 M values at the flagship width
// (w_ih 3.08 M, w_hh 0.79 M, out_w 2.14 M, W 0.07 M): 24.3 MB that every
// 8-row tile reads from L2 every step, 6.07 M multiply-adds a row a step.
// As three-term TF32 products on the tensor cores (494.7 TFLOP/s dense),
// B = 1024 needs at least 2.36 ms a decode, B = 100 0.23 ms; the f32
// CUDA-core rate (67 TFLOP/s) would need 5.80 ms at B = 1024. The bf16
// tensor-core body showed that one SM's own stream of weight tiles from
// L2, about 50 GB/s, paces a block; so a block's bytes, not the card's
// arithmetic, set the time, and at the eval batch (B = 100: 13 tiles of 8
// rows) 13 SMs of 132 would carry the whole decode.
//
// The design:
// * Three-term TF32 products. mma.sync m16n8k8 takes TF32 (10 mantissa
//   bits); each f32 operand x is split in registers as it is loaded into
//   hi = cvt.rna.tf32(x) and lo = tf32(x - hi), and a product is
//   a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first, from a zero
//   accumulator, added to the running sums in IEEE f32 on the CUDA cores
//   (hopper_mma.cuh mma_3xtf32): about 2^-21 of |a b| a product, where one
//   TF32 term would move the logits about 1e-3 and flip tokens. The split
//   is never stored: stored hi / lo tiles would double the bytes again.
// * The weights are A, 16 output units x 8 inputs a tile, 512 bytes laid out
//   in fragment order (ops/cuda/layout.py: lane l's four values a[0..3] at
//   16 l bytes), so each lane's 16-byte cp.async copy is its own fragment
//   and one 16-byte shared load reads it back without bank conflicts. The
//   gate tiles are [unit tile][k8 step][gate][32 lanes][4], the W and out_w
//   column tiles [column group][k8 step][tile][32][4], made once per
//   parameter set. Each warp streams its items (one k8 step of a unit
//   tile's gates, of 3 out_w column tiles, of a W tile) through its own
//   cp.async ring, as the bf16 body does: 4 slots, 3 for an LSTM, whose 4
//   gate tiles a slot would not fit beside the rows' f32 buffers.
// * The rows' x = [emb, ctx] and h sit in shared memory in f32, [row][k]
//   with a row stride of 4 mod 32 words, so the B fragments' 32-bit loads
//   (row g, input t and t + 4) hit 32 distinct banks.
// * Spread over a cluster. A cluster of C blocks (C in 1, 2, 4, 8; the
//   wrapper picks the largest with ceil(B / 8) C <= the SM count) shares
//   one 8-row tile: block r takes its slice of the unit tiles (every gate
//   of them, and their c), of the out_w column groups and of enc's
//   features, so it streams about 1 / C of the weights a step. Each block
//   computes W h and the scores whole (1% of the bytes), then the blocks
//   exchange through distributed shared memory, under cluster barriers:
//   each block's slice of ctx (into every block's x), each block's slice
//   of h' (into every block's next h), and each block's best (key, index)
//   a row, merged in the kernel's tie order. Where a block has fewer unit
//   tiles than warps (C = 4, 8 at the flagship), its warps take units of a
//   tile's gate sums, each gate's x part (gi) and the tile's h part (gh of
//   every gate), which meet in shared memory for the cell: each sum is the
//   same sequence of f32 adds as at C = 1, so tokens, h and c are bit-equal
//   for every C, whatever the batch (the cluster's size follows it). W h,
//   whole in every block, splits its k steps over warps the same way at
//   every C; the gates and the projection do not split them.
//
// The body is one template, tf32_decode_kernel<NG, VAR>; VAR carries the K5
// variant bits of whole_decode_tc.cuh, and VAR = 0 is the production step:
// * EARLY_EXIT: the cluster stops once every real row of its tile has token
//   0 (every block holds the same tokens, so the break is uniform).
// * DUAL: a tile of 16 rows, the two N = 8 halves of mma.sync m16n8k8: each
//   weight fragment (the A operand) is read from the ring once and split
//   into hi and lo once, then multiplied against half 0's and half 1's B
//   fragments, so one L2 read and one split of a tile feed 16 rows. Each
//   row's sums are production's sequence of f32 adds, so tokens, h and c
//   equal production's bit for bit at every cluster size. The 16 rows'
//   buffers do not fit beside production's rings (x alone takes 129 KB at
//   the flagship), so under DUAL: x stages only the inputs from the last
//   whole k8 step of the embedding on (ctx, and the embedding's tail), the
//   B fragments of the embedding's other steps read straight from the
//   table rows in L2; h is one buffer, each block writing its slice of h'
//   to h_out in global memory and every block copying the tile's h' back
//   after the cluster barrier; c stays in c_out in global memory (each
//   block its units); and the rings take 3 slots (GRU) or 2 (LSTM).
// * ABL_*: the profiling stubs of the Pallas _make_step, one part at a
//   time, each dropping the work of its part: emb (zero embedding rows: no
//   gather), attn (ctx = 0: no W h, scores, enc reads or ctx exchange and
//   its cluster barrier), score1 (score = tanh(W h + uv + b)[unit 0]: no
//   attn_w dot), fma (ctx = sum_f score_f on every feature: no enc reads,
//   no / L; each block writes its own x, so no exchange and no barrier),
//   proj (the token stays: no out_w stream, no argmax, no exchange of keys
//   and its barrier), nativeargmax (the float order, -0 = +0, in place of
//   the int key), argmax (token = int(max logit), often outside [0, V)).
//   Every block of a cluster runs the same barriers in every variant.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

#include "decode_common.cuh"
#include "hopper_mma.cuh"

namespace {

namespace cg = cooperative_groups;

using recnet::cp_async16;
using recnet::mma_3xtf32;
using recnet::sigmoid;
using recnet::split_tf32;

constexpr int TB = 8;            // batch rows of a tile (the mma's N)
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 128;        // f32 values of a 16 x 8 weight tile
constexpr int PT = 3;            // out_w column tiles an item (48 columns)
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr size_t SMEM_LIMIT = 232448;

// variant bits (VAR), whole_decode_tc.cuh's; the wrapper builds the same
constexpr int EARLY_EXIT = 1;
constexpr int DUAL = 2;
constexpr int ABL_EMB = 4;          // zero embedding
constexpr int ABL_ATTN_SHIFT = 3;   // 1 zero ctx, 2 score = act[0],
                                    // 3 ctx = sum_f score_f (no enc, no / L)
constexpr int ABL_PROJ_SHIFT = 5;   // 1 the token stays, 2 float first-max
                                    // argmax, 3 token = int(max logit)

// Rows of a tile: 8, or 16 under DUAL.
__host__ __device__ constexpr int tf32_rows(int var) {
  return (var & DUAL) ? 2 * TB : TB;
}

// Ring slots a warp: 4, or 3 for an LSTM (4 gate tiles a slot); under
// DUAL, beside the 16 rows' buffers, 3 (GRU) or 2 (LSTM).
__host__ __device__ constexpr int tf32_slots(int ng, int var) {
  return (var & DUAL) ? (ng == 4 ? 2 : 3) : (ng == 4 ? 3 : 4);
}

// Gate-sum units a warp holds at most: 3, 2 under DUAL (two halves' sums
// in registers).
__host__ __device__ constexpr int tf32_hold(int var) {
  return (var & DUAL) ? 2 : 3;
}

// A row stride of 4 mod 32 words over n values in whole k8 steps.
__host__ __device__ inline int row_ld(int n) {
  return ((n + 7) / 8 * 8 + 31) / 32 * 32 + 4;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// byte offsets of the shared arrays for variant `var` (K = E + F;
// ops/cuda/whole_decode.py tf32_smem_bytes mirrors it, so the wrapper
// refuses what cannot fit). x holds the inputs x0.. of each row: all of
// them, or under DUAL those from the embedding's last whole k8 step on.
struct Tf32Smem {
  int x0, xld, hld;
  size_t x, h, c, wh, att, sc, red, xch, tok, ring, total;
  __host__ __device__ Tf32Smem(int L, int A, int E, int K, int H, int NG,
                               int var) {
    const bool dual = (var & DUAL) != 0;
    const size_t R = tf32_rows(var);
    x0 = dual ? E / 8 * 8 : 0;
    xld = row_ld(K - x0);
    hld = row_ld(H);
    size_t o = 0;
    x = o;   o = align16(o + 4 * R * xld);                   // [R][xld]
    h = o;   o = align16(o + 4 * (dual ? 1 : 2) * R * hld);  // [2][R][hld]
    c = o;   o = align16(o + (dual ? 0 : 4 * R * H));        // [R][H]
    wh = o;  o = align16(o + 4 * R * A);                     // [R][A]
    att = o; o = align16(o + 4 * (size_t)2 * A);             // w, b
    sc = o;  o = align16(o + 4 * R * L);                     // [R][L]
    red = o; o = align16(o + 4 * (size_t)2 * NWARPS * R);    // keys, indices
    xch = o; o = align16(o + 4 * (size_t)2 * MAX_CLUSTER * R);
    tok = o; o = align16(o + 4 * R);
    ring = o;
    total = o + 4 * (size_t)NWARPS * tf32_slots(NG, var) * NG * TILE;
  }
};

// the body's shared memory for a variant, in bytes
inline size_t tf32_smem(int NG, int var, int L, int A, int E, int K, int H) {
  return Tf32Smem(L, A, E, K, H, NG, var).total;
}

__device__ __forceinline__ int order_key(float x) {
  const int bits = __float_as_int(x);
  return bits ^ ((bits >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ bool key_wins(int k, int i, int bk, int bi) {
  return k > bk || (k == bk && i < bi);
}

// the argmax key of a logit: the int key (-0 < +0), or under the
// nativeargmax stub (PROJ 2) the float order, which ties -0 with +0
template <int PROJ>
__device__ __forceinline__ int argmax_key(float logit) {
  if constexpr (PROJ == 2) logit = logit == 0.f ? 0.f : logit;
  return order_key(logit);
}

// the token of the winning key: its index, or under the argmax stub
// (PROJ 3) int(max logit)
template <int PROJ>
__device__ __forceinline__ int argmax_token(int key, int idx) {
  if constexpr (PROJ == 3)
    return (int)__int_as_float(order_key(__int_as_float(key)));
  return idx;
}

// The slice [lo, hi) of n items that block r of C takes.
__device__ __forceinline__ void slice(int n, int r, int C, int& lo, int& hi) {
  lo = r * n / C;
  hi = (r + 1) * n / C;
}

// The B fragments of 8 rows' f32 vector v (row stride ld) at inputs k0..k0+7,
// split: (hi, lo) of (row g, input k0 + t) and (row g, k0 + t + 4).
__device__ __forceinline__ void b_frag(const float* v, int ld, int k0,
                                       int lane, unsigned bhi[2],
                                       unsigned blo[2]) {
  const float* p = v + (lane >> 2) * ld + k0 + (lane & 3);
  split_tf32(p[0], bhi[0], blo[0]);
  split_tf32(p[4], bhi[1], blo[1]);
}

// The A fragment of the weight tile at `tile` (fragment order: this lane's
// four values at 4 lane), split.
__device__ __forceinline__ void a_frag(const float* tile, int lane,
                                       unsigned ahi[4], unsigned alo[4]) {
  const float4 a = reinterpret_cast<const float4*>(tile)[lane];
  split_tf32(a.x, ahi[0], alo[0]);
  split_tf32(a.y, ahi[1], alo[1]);
  split_tf32(a.z, ahi[2], alo[2]);
  split_tf32(a.w, ahi[3], alo[3]);
}

// A warp's software pipeline over n items (whole_decode_tc.cuh's).
template <int STAGES, typename Issue, typename Consume>
__device__ __forceinline__ void pipeline(int n, Issue& issue,
                                         Consume& consume) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) issue(s);
    recnet::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    recnet::cp_async_wait<STAGES - 2>();
    __syncwarp();
    if (i + STAGES - 1 < n) issue((i + STAGES - 1) % STAGES);
    recnet::cp_async_commit();
    consume(i % STAGES);
  }
  recnet::cp_async_wait<0>();
}

// One phase of the block: output tiles [lo, hi), n_k k8 steps each, over
// the NWARPS warps. A warp takes tiles lo + w, lo + w + NWARPS, ...; with
// fewer tiles than warps and SPLIT_K, ks = NWARPS / (hi - lo) warps share a
// tile, each a contiguous part of its k steps, and the tile's first warp
// adds the others' partials (left in their rings: NACC x 128 floats, within
// any ring) in k order. mma(slot, k, acc) multiplies the item in a ring slot
// into acc[NACC][4]; epi(tile, acc) ends a tile. Block-uniform; ends with a
// barrier.
template <int STAGES, int NACC, bool SPLIT_K, typename Issue, typename Mma,
          typename Epi>
__device__ __forceinline__ void phase(int lo, int hi, int n_k, float* rings,
                                      int ring_floats, Issue& issue, Mma& mma,
                                      Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = hi - lo;
  const int ks = !SPLIT_K || n >= NWARPS || n < 1 ? 1 : NWARPS / n;
  const int part = warp % ks;
  const int k0 = part * n_k / ks, k1 = (part + 1) * n_k / ks;
  const int first = lo + warp / ks, stride = NWARPS / ks;
  const int n_tiles = first < hi ? (hi - first + stride - 1) / stride : 0;
  float acc[NACC][4];
#pragma unroll
  for (int q = 0; q < NACC; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  int it = first, ik = k0;
  auto iss = [&](int slot) {
    issue(slot, it, ik);
    if (++ik == k1) {
      ik = k0;
      it += stride;
    }
  };
  int ct = first, ck = k0;
  auto con = [&](int slot) {
    mma(slot, ck, acc);
    if (++ck < k1) return;
    ck = k0;
    if (ks == 1) {
      epi(ct, acc);
#pragma unroll
      for (int q = 0; q < NACC; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    }
    ct += stride;
  };
  pipeline<STAGES>(n_tiles * (k1 - k0), iss, con);
  if (ks > 1) {
    float* own = rings + (size_t)warp * ring_floats;
    if (part != 0 && n_tiles) {
#pragma unroll
      for (int q = 0; q < NACC; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) own[(q * 4 + e) * 32 + lane] = acc[q][e];
    }
    __syncthreads();
    if (part == 0 && n_tiles) {
      for (int p = 1; p < ks; ++p) {
        const float* other = rings + (size_t)(warp + p) * ring_floats;
#pragma unroll
        for (int q = 0; q < NACC; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[q][e] += other[(q * 4 + e) * 32 + lane];
      }
      epi(first, acc);
    }
  }
  __syncthreads();
}

template <int NG, int VAR>
__global__ void __launch_bounds__(THREADS, 1)
tf32_decode_kernel(const float* __restrict__ enc, const float* __restrict__ uv,
                   const float* __restrict__ emb, const float* __restrict__ wa,
                   const float* __restrict__ attn_w,
                   const float* __restrict__ attn_b,
                   const float* __restrict__ wg,
                   const float* __restrict__ bias2,
                   const float* __restrict__ wo,
                   const float* __restrict__ out_b,
                   const float* __restrict__ h0, const float* __restrict__ c0,
                   const int* __restrict__ tok0, int* __restrict__ tokens,
                   float* __restrict__ h_out, float* __restrict__ c_out,
                   int* __restrict__ tok_out, int B, int L, int F, int A,
                   int E, int H, int V, int n_steps, float emb_scale,
                   int vec_enc) {
  constexpr bool EARLY = (VAR & EARLY_EXIT) != 0;
  constexpr bool DUALV = (VAR & DUAL) != 0;
  constexpr bool NO_EMB = (VAR & ABL_EMB) != 0;
  constexpr int ATTN = (VAR >> ABL_ATTN_SHIFT) & 3;
  constexpr int PROJ = (VAR >> ABL_PROJ_SHIFT) & 3;
  constexpr int NH = DUALV ? 2 : 1;          // 8-row halves of the tile
  constexpr int R = NH * TB;                 // rows of the tile
  constexpr int SLOTS = tf32_slots(NG, VAR);
  constexpr int HOLD = tf32_hold(VAR);
  constexpr int SLOT = NG * TILE;   // floats of a ring slot

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int cr = (int)cluster.block_rank();

  extern __shared__ float4 smem_f4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_f4);
  const int K = E + F;
  const int G = NG * H;
  const Tf32Smem lay(L, A, E, K, H, NG, VAR);
  const int x0 = DUALV ? lay.x0 : 0, xld = lay.xld, hld = lay.hld;
  float* x_s = reinterpret_cast<float*>(sm + lay.x);
  float* h_s = reinterpret_cast<float*>(sm + lay.h);
  float* c_s = reinterpret_cast<float*>(sm + lay.c);      // not under DUAL
  float* wh_s = reinterpret_cast<float*>(sm + lay.wh);
  float* aw_s = reinterpret_cast<float*>(sm + lay.att);   // w, then b
  float* sc_s = reinterpret_cast<float*>(sm + lay.sc);
  int* red_key = reinterpret_cast<int*>(sm + lay.red);    // [NWARPS][R]
  int* red_idx = red_key + NWARPS * R;
  int* xch_key = reinterpret_cast<int*>(sm + lay.xch);    // [C][R]
  int* xch_idx = xch_key + MAX_CLUSTER * R;
  int* tok_s = reinterpret_cast<int*>(sm + lay.tok);
  float* rings = reinterpret_cast<float*>(sm + lay.ring);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = (int)(blockIdx.x / C) * R;
  float* ring = rings + (size_t)warp * SLOTS * SLOT;

  const int nKx = (K + 7) / 8, nKh = H / 8, nKg = nKx + nKh;
  const int n_ut = H / 16;                        // unit tiles
  const int n_vg = (V + 16 * PT - 1) / (16 * PT); // out_w column groups
  const int n_at = (A + 15) / 16;                 // W column tiles
  int ut_lo, ut_hi, vg_lo, vg_hi;
  slice(n_ut, cr, C, ut_lo, ut_hi);
  slice(n_vg, cr, C, vg_lo, vg_hi);
  const int nq = vec_enc ? F / 4 : F;   // enc's features (quads: vec_enc)
  int f_lo, f_hi;
  slice(nq, cr, C, f_lo, f_hi);

  for (int i = tid; i < R * xld; i += THREADS) x_s[i] = 0.f;
  for (int i = tid; i < R * H; i += THREADS) {
    const int b = i / H, j = i % H, row = row0 + b;
    const bool ok = row < B;
    h_s[b * hld + j] = ok ? h0[(size_t)row * H + j] : 0.f;
    if constexpr (!DUALV) c_s[i] = ok ? c0[(size_t)row * H + j] : 0.f;
  }
  if constexpr (DUALV) {   // c lives in c_out: each block its units
    const int u0 = ut_lo * 16, nu = (ut_hi - ut_lo) * 16;
    for (int i = tid; i < R * nu; i += THREADS) {
      const int row = row0 + i / nu, j = u0 + i % nu;
      if (row < B)
        __stcg(c_out + (size_t)row * H + j, c0[(size_t)row * H + j]);
    }
  }
  if (tid < R) tok_s[tid] = row0 + tid < B ? tok0[row0 + tid] : 0;
  for (int a = tid; a < A; a += THREADS) {
    aw_s[a] = attn_w[a];
    aw_s[A + a] = attn_b[a];
  }
  cluster.sync();   // every block's x is zero before any ctx lands in it

  int cur = 0;
  for (int t = 0; t < n_steps; ++t) {
    if constexpr (EARLY) {
      // the Pallas condition hard-codes token 0 (whole_decode.py:302)
      bool stop = true;
#pragma unroll
      for (int b = 0; b < R; ++b) stop &= row0 + b >= B || tok_s[b] == 0;
      if (stop) break;
    }
    // h: double-buffered, or under DUAL one buffer (h' goes to h_out)
    const float* hc = h_s + (DUALV ? 0 : (size_t)cur * R * hld);
    float* hn = h_s + (DUALV ? 0 : (size_t)(cur ^ 1) * R * hld);

    // 1. embedding rows (a zero row outside [0, V)), scaled: the staged
    //    inputs x0..E - 1 (all of them but under DUAL; none under the emb
    //    stub, which leaves the zero rows of the start)
    if constexpr (!NO_EMB) {
      const int ne = E - x0;
      for (int i = tid; i < R * ne; i += THREADS) {
        const int b = i / ne, k = x0 + i % ne, tk = tok_s[b];
        x_s[b * xld + k - x0] =
            (unsigned)tk < (unsigned)V ? emb[(size_t)tk * E + k] * emb_scale
                                       : 0.f;
      }
    }
    // the split B fragments of half hh's x at k8 step k; under DUAL the
    // embedding's steps before x0 read the table row of the lane's row g
    auto x_frag = [&](int hh, int k, unsigned bhi[2], unsigned blo[2]) {
      const int k0 = k * 8;
      if (DUALV && k0 < x0) {
        const int tk = tok_s[hh * TB + g];
        float v0 = 0.f, v1 = 0.f;
        if ((unsigned)tk < (unsigned)V) {
          const float* row = emb + (size_t)tk * E + k0 + t4;
          v0 = __ldg(row) * emb_scale;
          v1 = __ldg(row + 4) * emb_scale;
        }
        split_tf32(v0, bhi[0], blo[0]);
        split_tf32(v1, bhi[1], blo[1]);
      } else {
        b_frag(x_s + (size_t)hh * TB * xld, xld, k0 - x0, lane, bhi, blo);
      }
    };

    // the attn stub: ctx stays the zero of the start
    if constexpr (ATTN != 1) {
      // 2. W h, whole in every block: A = W's column tiles
      {
        auto issue = [&](int slot, int u, int k) {
          cp_async16(ring + slot * SLOT + lane * 4,
                     wa + ((size_t)u * nKh + k) * TILE + lane * 4);
        };
        auto mma = [&](int slot, int k, float (&acc)[NH][4]) {
          unsigned ahi[4], alo[4];
          a_frag(ring + slot * SLOT, lane, ahi, alo);
#pragma unroll
          for (int hh = 0; hh < NH; ++hh) {
            unsigned bhi[2], blo[2];
            b_frag(hc + (size_t)hh * TB * hld, hld, k * 8, lane, bhi, blo);
            float d[4];
            mma_3xtf32(d, ahi, alo, bhi, blo);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[hh][e] += d[e];
          }
        };
        auto epi = [&](int u, float (&acc)[NH][4]) {
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int a = u * 16 + g + (e >> 1) * 8;
              if (a < A)
                wh_s[(hh * TB + 2 * t4 + (e & 1)) * A + a] = acc[hh][e];
            }
        };
        phase<SLOTS, NH, true>(0, n_at, nKh, rings, SLOTS * SLOT, issue, mma,
                               epi);
      }

      // 3. scores: one warp per (row, frame), two in flight
#pragma unroll 2
      for (int p = warp; p < R * L; p += NWARPS) {
        const int b = p / L, f = p % L, row = row0 + b;
        float s = 0.f;
        if (row < B) {
          const float* uvp = uv + ((size_t)row * L + f) * A;
          if constexpr (ATTN == 2) {   // score1: act[0], no attn_w dot
            if (lane == 0) s = tanhf(wh_s[b * A] + uvp[0] + aw_s[A]);
          } else {
            for (int a = lane; a < A; a += 32)
              s += tanhf(wh_s[b * A + a] + uvp[a] + aw_s[A + a]) * aw_s[a];
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) sc_s[b * L + f] = s;
      }
      __syncthreads();

      // ctx's first input in a row of x: an offset, where a pointer
      // (loop-invariant, so kept in two registers across the step) cost
      // the gate loop its interleaved mma.sync chains
      const int cx = E - x0;
      if constexpr (ATTN == 3) {
        // 4. fma: ctx = sum_f score_f on every feature, no enc, no / L;
        //    every block has the scores, so each writes its own x
        if (tid < R) {
          float acc = 0.f;
          for (int f = 0; f < L; ++f) acc += sc_s[tid * L + f];
          wh_s[tid * A] = acc;   // W h is spent
        }
        __syncthreads();
        for (int i = tid; i < R * F; i += THREADS)
          x_s[(i / F) * xld + cx + i % F] = wh_s[(i / F) * A];
      } else if (vec_enc) {
        // 4. this block's slice of ctx = sum_f score_f enc_f / L (f in
        //    order), into every block's x; 4 features, 16 bytes, a load
        const int w = f_hi - f_lo;
        for (int i = tid; i < R * w; i += THREADS) {
          const int b = i / w, e0 = (f_lo + i % w) * 4, row = row0 + b;
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row < B) {
            const float* ep = enc + (size_t)row * L * F + e0;
#pragma unroll 4
            for (int f = 0; f < L; ++f) {
              const float4 v =
                  *reinterpret_cast<const float4*>(ep + (size_t)f * F);
              const float s = sc_s[b * L + f];
              acc.x += s * v.x;
              acc.y += s * v.y;
              acc.z += s * v.z;
              acc.w += s * v.w;
            }
          }
          const float inv = (float)L;
          const float4 ctx = make_float4(acc.x / inv, acc.y / inv,
                                         acc.z / inv, acc.w / inv);
          for (int r = 0; r < C; ++r) {
            float* dst = cluster.map_shared_rank(x_s, r) + b * xld + cx + e0;
            dst[0] = ctx.x;
            dst[1] = ctx.y;
            dst[2] = ctx.z;
            dst[3] = ctx.w;
          }
        }
      } else {
        const int w = f_hi - f_lo;
        for (int i = tid; i < R * w; i += THREADS) {
          const int b = i / w, e = f_lo + i % w, row = row0 + b;
          float acc = 0.f;
          if (row < B) {
            const float* ep = enc + (size_t)row * L * F + e;
#pragma unroll 4
            for (int f = 0; f < L; ++f)
              acc += sc_s[b * L + f] * ep[(size_t)f * F];
          }
          const float ctx = acc / (float)L;
          for (int r = 0; r < C; ++r)
            cluster.map_shared_rank(x_s, r)[b * xld + cx + e] = ctx;
        }
      }
    }
    // ctx from other blocks only where it is exchanged
    if constexpr (ATTN == 1 || ATTN == 3)
      __syncthreads();
    else
      cluster.sync();

    // 5. gates of this block's unit tiles, and the cell; h' into every
    //    block's next h (under DUAL into h_out)
    {
      // the cell of unit u's element e of half hh from its gates' sums
      auto cell = [&](int u, int hh, int e, const float (&si)[NG],
                      const float (&sh)[NG]) {
        const int j = u * 16 + g + (e >> 1) * 8;
        const int b = hh * TB + 2 * t4 + (e & 1);
        const int row = row0 + b;
        float gi[NG], gh[NG];
#pragma unroll
        for (int gt = 0; gt < NG; ++gt) {
          gi[gt] = si[gt] + bias2[gt * H + j];
          gh[gt] = sh[gt] + bias2[G + gt * H + j];
        }
        float hv;
        if constexpr (NG == 3) {   // GRU
          const float r = sigmoid(gi[0] + gh[0]);
          const float z = sigmoid(gi[1] + gh[1]);
          const float n = tanhf(gi[2] + r * gh[2]);
          hv = (1.0f - z) * n + z * hc[b * hld + j];
        } else {                   // LSTM
          const float ig = sigmoid(gi[0] + gh[0]);
          const float fg = sigmoid(gi[1] + gh[1]);
          const float gg = tanhf(gi[2] + gh[2]);
          const float og = sigmoid(gi[3] + gh[3]);
          float cp;
          if constexpr (DUALV)
            cp = row < B ? __ldcg(c_out + (size_t)row * H + j) : 0.f;
          else
            cp = c_s[b * H + j];
          const float c = fg * cp + ig * gg;
          hv = og * tanhf(c);
          if constexpr (DUALV) {
            if (row < B) __stcg(c_out + (size_t)row * H + j, c);
          } else {
            c_s[b * H + j] = c;
          }
        }
        if constexpr (DUALV) {
          if (row < B) __stcg(h_out + (size_t)row * H + j, hv);
        } else {
          for (int r = 0; r < C; ++r)
            cluster.map_shared_rank(hn, r)[b * hld + j] = hv;
        }
      };
      // Fewer unit tiles than warps (a cluster's share at small batches)
      // split each tile's gate sums into units: one gate's x part (gi, the
      // k8 steps of x = [emb, ctx]) a unit, and the h part of every gate
      // (gh, w_hh's k8 steps) a unit, so that the splits fall only between
      // sums that the cell adds anyway: each sum is the same sequence of
      // adds as a warp that takes the whole tile makes, and h' does not
      // depend on the cluster's size. The units' sums meet in the rings,
      // so they must fit there.
      const int n_t = ut_hi - ut_lo;
      const int n_x = n_t * NG, n_units = n_x + n_t;
      if (n_t >= NWARPS || n_units > HOLD * NWARPS
          || n_t * 2 * NG * 4 * 32 * NH > NWARPS * SLOTS * SLOT) {
        // a warp a unit tile's gates, an item one k8 step of them
        auto issue = [&](int slot, int u, int k) {   // NG tiles of 512 B
          const float* src =
              wg + ((size_t)u * nKg + k) * NG * TILE + lane * 4;
          float* dst = ring + slot * SLOT + lane * 4;
#pragma unroll
          for (int gt = 0; gt < NG; ++gt)
            cp_async16(dst + gt * TILE, src + gt * TILE);
        };
        // acc[(hh * 2 + part) * NG + gate]: part 0 x, 1 h
        auto mma = [&](int slot, int k, float (&acc)[NH * 2 * NG][4]) {
          const bool hp = k >= nKx;
          unsigned bhi[NH][2], blo[NH][2];
#pragma unroll
          for (int hh = 0; hh < NH; ++hh) {
            if (hp)
              b_frag(hc + (size_t)hh * TB * hld, hld, (k - nKx) * 8, lane,
                     bhi[hh], blo[hh]);
            else
              x_frag(hh, k, bhi[hh], blo[hh]);
          }
#pragma unroll
          for (int gt = 0; gt < NG; ++gt) {
            unsigned ahi[4], alo[4];
            a_frag(ring + slot * SLOT + gt * TILE, lane, ahi, alo);
#pragma unroll
            for (int hh = 0; hh < NH; ++hh) {
              float d[4];
              mma_3xtf32(d, ahi, alo, bhi[hh], blo[hh]);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if (hp)
                  acc[(hh * 2 + 1) * NG + gt][e] += d[e];
                else
                  acc[hh * 2 * NG + gt][e] += d[e];
              }
            }
          }
        };
        auto epi = [&](int u, float (&acc)[NH * 2 * NG][4]) {
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float si[NG], sh[NG];
#pragma unroll
              for (int gt = 0; gt < NG; ++gt) {
                si[gt] = acc[hh * 2 * NG + gt][e];
                sh[gt] = acc[(hh * 2 + 1) * NG + gt][e];
              }
              cell(u, hh, e, si, sh);
            }
        };
        // no k split (with 9 or more tiles it would not split anyway)
        phase<SLOTS, NH * 2 * NG, false>(ut_lo, ut_hi, nKg, rings,
                                         SLOTS * SLOT, issue, mma, epi);
      } else {
        // unit i < n_x: tile ut_lo + i / NG, gate i % NG, x part, an item
        // NG k8 steps of that gate; unit n_x + t: tile ut_lo + t, h part, an
        // item one k8 step of every gate. A warp takes units warp, warp +
        // NWARPS, ..., at most HOLD, their sums in registers; then the
        // sums meet in shared memory for the cell.
        const int mine = warp < n_units
                             ? (n_units - warp + NWARPS - 1) / NWARPS : 0;
        const int x_items = (nKx + NG - 1) / NG;
        auto items_of = [&](int i) { return i < n_x ? x_items : nKh; };
        int n_items = 0;
        for (int j = 0; j < mine; ++j) n_items += items_of(warp + j * NWARPS);
        float acc[HOLD][NH][NG][4] = {};
        int ij = 0, ik = 0;
        auto issue = [&](int slot) {
          const int i = warp + ij * NWARPS;
          float* dst = ring + slot * SLOT + lane * 4;
          if (i < n_x) {
            const int u = ut_lo + i / NG, gt = i % NG;
            const float* src = wg + ((size_t)u * nKg * NG + gt) * TILE
                               + lane * 4;
#pragma unroll
            for (int q = 0; q < NG; ++q)
              if (ik + q < nKx)
                cp_async16(dst + q * TILE,
                           src + (size_t)(ik + q) * NG * TILE);
            ik += NG;
            if (ik >= nKx) {
              ik = 0;
              ++ij;
            }
          } else {
            const int u = ut_lo + i - n_x;
            const float* src =
                wg + ((size_t)u * nKg + nKx + ik) * NG * TILE + lane * 4;
#pragma unroll
            for (int gt = 0; gt < NG; ++gt)
              cp_async16(dst + gt * TILE, src + gt * TILE);
            if (++ik == nKh) {
              ik = 0;
              ++ij;
            }
          }
        };
        int cj = 0, ck = 0;
        // d added to gate gt's sum of half hh of held unit cj (a
        // warp-uniform branch)
        auto add = [&](int hh, int gt_slot, const float (&d)[4]) {
#pragma unroll
          for (int j = 0; j < HOLD; ++j)
            if (j == cj) {
#pragma unroll
              for (int gt = 0; gt < NG; ++gt)
                if (gt == gt_slot)
#pragma unroll
                  for (int e = 0; e < 4; ++e) acc[j][hh][gt][e] += d[e];
            }
        };
        auto consume = [&](int slot) {
          const int i = warp + cj * NWARPS;
          if (i < n_x) {
#pragma unroll
            for (int q = 0; q < NG; ++q) {
              const int k = ck + q;
              if (k < nKx) {
                unsigned ahi[4], alo[4];
                a_frag(ring + slot * SLOT + q * TILE, lane, ahi, alo);
#pragma unroll
                for (int hh = 0; hh < NH; ++hh) {
                  unsigned bhi[2], blo[2];
                  x_frag(hh, k, bhi, blo);
                  float d[4];
                  mma_3xtf32(d, ahi, alo, bhi, blo);
                  add(hh, 0, d);
                }
              }
            }
            ck += NG;
            if (ck >= nKx) {
              ck = 0;
              ++cj;
            }
          } else {
            unsigned bhi[NH][2], blo[NH][2];
#pragma unroll
            for (int hh = 0; hh < NH; ++hh)
              b_frag(hc + (size_t)hh * TB * hld, hld, ck * 8, lane, bhi[hh],
                     blo[hh]);
#pragma unroll
            for (int gt = 0; gt < NG; ++gt) {
              unsigned ahi[4], alo[4];
              a_frag(ring + slot * SLOT + gt * TILE, lane, ahi, alo);
#pragma unroll
              for (int hh = 0; hh < NH; ++hh) {
                float d[4];
                mma_3xtf32(d, ahi, alo, bhi[hh], blo[hh]);
                add(hh, gt, d);
              }
            }
            if (++ck == nKh) {
              ck = 0;
              ++cj;
            }
          }
        };
        pipeline<SLOTS>(n_items, issue, consume);
        __syncthreads();       // every ring is free: the sums meet there
        // st[half][tile - ut_lo][x, h][gate][4][32 lanes]
        float* st = rings;
        auto at = [&](int hh, int t, int part, int gt, int e) {
          return ((((hh * n_t + t) * 2 + part) * NG + gt) * 4 + e) * 32
                 + lane;
        };
#pragma unroll
        for (int j = 0; j < HOLD; ++j) {
          if (j < mine) {
            const int i = warp + j * NWARPS;
#pragma unroll
            for (int hh = 0; hh < NH; ++hh) {
              if (i < n_x) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  st[at(hh, i / NG, 0, i % NG, e)] = acc[j][hh][0][e];
              } else {
#pragma unroll
                for (int gt = 0; gt < NG; ++gt)
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    st[at(hh, i - n_x, 1, gt, e)] = acc[j][hh][gt][e];
              }
            }
          }
        }
        __syncthreads();
        for (int t = warp; t < n_t; t += NWARPS) {
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float si[NG], sh[NG];
#pragma unroll
              for (int gt = 0; gt < NG; ++gt) {
                si[gt] = st[at(hh, t, 0, gt, e)];
                sh[gt] = st[at(hh, t, 1, gt, e)];
              }
              cell(ut_lo + t, hh, e, si, sh);
            }
        }
        __syncthreads();       // the rings are the next phase's again
      }
    }
    cluster.sync();
    if constexpr (DUALV) {   // the tile's h' back from h_out (0 past B)
      for (int i = tid; i < R * H; i += THREADS) {
        const int b = i / H, j = i % H, row = row0 + b;
        h_s[b * hld + j] = row < B ? __ldcg(h_out + (size_t)row * H + j) : 0.f;
      }
      __syncthreads();
    }

    if constexpr (PROJ == 1) {   // the proj stub: the token stays
      if (cr == 0 && tid < R && row0 + tid < B)
        tokens[(size_t)(row0 + tid) * n_steps + t] = tok_s[tid];
    } else {
      // 6. logits of this block's column groups + out_b, and a running
      //    (max key, first index) of the thread's two rows of each half
      int best_key[NH][2], best_idx[NH][2];
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          best_key[hh][q] = INT_MIN;
          best_idx[hh][q] = INT_MAX;
        }
      {
        auto issue = [&](int slot, int v, int k) {
          const float* src =
              wo + ((size_t)v * nKh + k) * PT * TILE + lane * 4;
          float* dst = ring + slot * SLOT + lane * 4;
#pragma unroll
          for (int p = 0; p < PT; ++p)
            cp_async16(dst + p * TILE, src + p * TILE);
        };
        // acc[hh * PT + p]
        auto mma = [&](int slot, int k, float (&acc)[NH * PT][4]) {
          unsigned bhi[NH][2], blo[NH][2];
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
            b_frag(hn + (size_t)hh * TB * hld, hld, k * 8, lane, bhi[hh],
                   blo[hh]);
#pragma unroll
          for (int p = 0; p < PT; ++p) {
            unsigned ahi[4], alo[4];
            a_frag(ring + slot * SLOT + p * TILE, lane, ahi, alo);
#pragma unroll
            for (int hh = 0; hh < NH; ++hh) {
              float d[4];
              mma_3xtf32(d, ahi, alo, bhi[hh], blo[hh]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[hh * PT + p][e] += d[e];
            }
          }
        };
        auto epi = [&](int v, float (&acc)[NH * PT][4]) {
#pragma unroll
          for (int p = 0; p < PT; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = (v * PT + p) * 16 + g + (e >> 1) * 8;
              if (col < V) {
                const float bv = out_b[col];
                const int q = e & 1;
#pragma unroll
                for (int hh = 0; hh < NH; ++hh) {
                  const int key = argmax_key<PROJ>(acc[hh * PT + p][e] + bv);
                  if (key_wins(key, col, best_key[hh][q], best_idx[hh][q])) {
                    best_key[hh][q] = key;
                    best_idx[hh][q] = col;
                  }
                }
              }
            }
        };
        // no k split: the logits do not depend on the cluster's size
        phase<SLOTS, NH * PT, false>(vg_lo, vg_hi, nKh, rings, SLOTS * SLOT,
                                     issue, mma, epi);
      }
      // the 8 lanes with the same t4 hold rows 2 t4 and 2 t4 + 1 of each
      // half
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          int k = best_key[hh][q], i = best_idx[hh][q];
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
            red_key[warp * R + hh * TB + 2 * t4 + q] = k;
            red_idx[warp * R + hh * TB + 2 * t4 + q] = i;
          }
        }
      __syncthreads();
      if (tid < R) {   // this block's best of each row, to every block
        int k = red_key[tid], i = red_idx[tid];
        for (int w = 1; w < NWARPS; ++w) {
          if (key_wins(red_key[w * R + tid], red_idx[w * R + tid], k, i)) {
            k = red_key[w * R + tid];
            i = red_idx[w * R + tid];
          }
        }
        for (int r = 0; r < C; ++r) {
          cluster.map_shared_rank(xch_key, r)[cr * R + tid] = k;
          cluster.map_shared_rank(xch_idx, r)[cr * R + tid] = i;
        }
      }
      cluster.sync();
      if (tid < R) {
        int k = xch_key[tid], i = xch_idx[tid];
        for (int r = 1; r < C; ++r) {
          if (key_wins(xch_key[r * R + tid], xch_idx[r * R + tid], k, i)) {
            k = xch_key[r * R + tid];
            i = xch_idx[r * R + tid];
          }
        }
        i = argmax_token<PROJ>(k, i);
        tok_s[tid] = i;
        if (cr == 0 && row0 + tid < B)
          tokens[(size_t)(row0 + tid) * n_steps + t] = i;
      }
    }
    __syncthreads();
    cur ^= 1;
  }

  // each block writes its units' h and c (under DUAL they are in h_out and
  // c_out already); block 0 the tokens
  if constexpr (!DUALV) {
    const float* h_fin = h_s + (size_t)cur * R * hld;
    const int u0 = ut_lo * 16, nu = (ut_hi - ut_lo) * 16;
    for (int i = tid; i < R * nu; i += THREADS) {
      const int b = i / nu, j = u0 + i % nu, row = row0 + b;
      if (row < B) {
        h_out[(size_t)row * H + j] = h_fin[b * hld + j];
        c_out[(size_t)row * H + j] = c_s[b * H + j];
      }
    }
  }
  if (cr == 0 && tid < R && row0 + tid < B) tok_out[row0 + tid] = tok_s[tid];
}

// the launch's operands, as the C entry points take them
struct Operands {
  const float *enc, *uv, *emb, *attn_W, *attn_w, *attn_b, *gates, *bias2,
      *out_w, *out_b, *h0, *c0;
  const int* tok0;
  int* tokens;
  float *h_out, *c_out;
  int* tok_out;
  int B, L, F, A, E, H, V, n_steps, cluster;
  float emb_scale;
};

template <int NG, int VAR>
int launch_tf32(const Operands& o, cudaStream_t stream) {
  constexpr int R = tf32_rows(VAR);
  const int C = o.cluster;
  if (o.H % 16 != 0 || C < 1 || C > MAX_CLUSTER || (C & (C - 1)) != 0
      || C > o.H / 16 || (size_t)o.gates % 16 != 0 || (size_t)o.out_w % 16 != 0
      || (size_t)o.attn_W % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tf32_smem(NG, VAR, o.L, o.A, o.E, o.E + o.F, o.H);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = tf32_decode_kernel<NG, VAR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_enc = o.F % 4 == 0 && (size_t)o.enc % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((o.B + R - 1) / R * C), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, o.enc, o.uv, o.emb, o.attn_W, o.attn_w, o.attn_b, o.gates,
      o.bias2, o.out_w, o.out_b, o.h0, o.c0, o.tok0, o.tokens, o.h_out,
      o.c_out, o.tok_out, o.B, o.L, o.F, o.A, o.E, o.H, o.V, o.n_steps,
      o.emb_scale, vec_enc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
