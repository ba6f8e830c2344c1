// The tensor-core body of the greedy whole decode (bf16), shared by
// whole_decode.cu (production K1/K2 and the early exit) and
// whole_decode_probes.cu (the K5 probes dual and ablate), with the
// variant bits, the argmax key and the launch operands that both sources
// use. whole_decode.cu's header says what the body computes and what
// bounds it.
//
// The body is one template, tc_decode_kernel<NG, VAR>; VAR carries the K5
// variant bits, and VAR = 0 is the production step:
// * EARLY_EXIT: the block stops once each of its real rows has token 0.
// * DUAL: the block takes 16 rows as two 8-row halves, the N = 8 of two
//   mma.sync m16n8k16 that share one A fragment: each weight tile is
//   copied into the warp's ring once, ldmatrix.trans'd once and multiplied
//   against half 0's and then half 1's B fragment, back to back, so one L2
//   read of a tile feeds 16 rows where the production step feeds 8. Each
//   row's arithmetic is the production step's (the same fresh partials
//   added in the same k order, the same ctx frame order), so its tokens
//   equal production K1's bit for bit.
// * ABL_*: the profiling stubs of the Pallas _make_step, one part at a
//   time, each dropping the work of its part from this body's phases:
//   emb (zero embedding rows: no gather), attn (ctx = 0: no W h, scores or
//   enc reads), score1 (score = tanh(W h + uv + b)[unit 0]: no attn_w
//   dot), fma (ctx = sum_f score_f over every feature: no enc reads, no
//   / L), proj (the token stays: no out_w stream, no argmax), nativeargmax
//   (the float order, -0 = +0, in place of the int key), argmax (token =
//   int(max logit), often outside [0, V)).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

#include "decode_common.cuh"
#include "hopper_mma.cuh"

namespace {

using recnet::from_f;
using recnet::sigmoid;
using recnet::to_f;

constexpr int TB = 8;          // batch rows of a block (of a half, DUAL)
// 16 warps keep enough L2 requests outstanding; the registers stay under
// the 128 a thread that 512 threads allow
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;

// variant bits (VAR); the wrapper builds the same code
constexpr int EARLY_EXIT = 1;
constexpr int DUAL = 2;
constexpr int ABL_EMB = 4;          // zero embedding
constexpr int ABL_ATTN_SHIFT = 3;   // 1 zero ctx, 2 score = act[0],
                                    // 3 ctx = sum_f score_f (no enc, no / L)
constexpr int ABL_PROJ_SHIFT = 5;   // 1 the token stays, 2 float first-max
                                    // argmax, 3 token = int(max logit)
constexpr int TENSOR_CORES = 256;   // the tensor-core body

// the shared memory a block can have on Hopper (227 KB)
constexpr size_t SMEM_LIMIT = 232448;

// order-preserving f32 -> int32 key (whole_decode.py:251-252); the map is
// its own inverse
__device__ __forceinline__ int order_key(float x) {
  int bits = __float_as_int(x);
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

using bf16 = __nv_bfloat16;
using recnet::cp_async16;
using recnet::ldmatrix_x2;
using recnet::ldmatrix_x4;
using recnet::mma_bf16;

constexpr int PT = 3;        // 16-column tiles of out_w per projection item
constexpr int TILE = 256;    // bf16 elements of a 16 x 16 weight tile

// Rows of a block: 8, or 16 under DUAL.
__host__ __device__ constexpr int tc_rows(int var) {
  return (var & DUAL) ? 2 * TB : TB;
}

// Slots of each warp's cp.async ring: 4 (3 items in flight; on the weight
// tiles deeper rings gained nothing for the GRU). An LSTM under DUAL takes
// 3: its 16 rows' buffers (128.6 KB at the flagship) and a 4-slot ring of
// 4 gate tiles (131 KB) would need 259.6 KB of the 227 KB a block has.
__host__ __device__ constexpr int tc_slots(int ng, int var) {
  return (var & DUAL) && ng == 4 ? 3 : 4;
}

// row stride (elements) of the rows' bf16 vectors in shared memory: whole
// k16 steps, then +8 so that the 8 rows' 16-byte ldmatrix reads fall in
// distinct banks (a stride of 16 bytes modulo 128)
__host__ __device__ inline int padded_ld(int n) {
  return (n + 63) / 64 * 64 + 8;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// byte offsets of the tensor-core body's shared arrays for R rows and a
// ring of `slots` slots a warp (ops/cuda/whole_decode.py tc_smem_bytes
// mirrors it, so the wrapper refuses a launch that cannot fit)
struct TcSmem {
  int xld, hld;
  size_t x, h, c, wh, att, sc, red, tok, ring, total;
  __host__ __device__ TcSmem(int L, int A, int K, int H, int NG, int R,
                             int slots) {
    xld = padded_ld(K);
    hld = padded_ld(H);
    size_t o = 0;
    x = o;   o = align16(o + sizeof(bf16) * R * xld);           // [R][xld]
    h = o;   o = align16(o + sizeof(bf16) * 2 * R * hld);       // [2][R][hld]
    c = o;   o = align16(o + sizeof(bf16) * R * H);             // [R][H]
    wh = o;  o = align16(o + sizeof(float) * R * A);            // [R][A]
    att = o; o = align16(o + sizeof(float) * 2 * A);            // w, b
    sc = o;  o = align16(o + sizeof(float) * R * L);            // [R][L]
    red = o; o = align16(o + sizeof(int) * 2 * NWARPS * R);
    tok = o; o = align16(o + sizeof(int) * R);
    ring = o;
    total = o + sizeof(bf16) * NWARPS * slots * NG * TILE;
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

template <int NG, int VAR>
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
  constexpr bool EARLY = (VAR & EARLY_EXIT) != 0;
  constexpr int NH = (VAR & DUAL) ? 2 : 1;   // 8-row halves of the block
  constexpr int R = NH * TB;                 // rows of the block
  constexpr int SLOTS = tc_slots(NG, VAR);
  constexpr bool NO_EMB = (VAR & ABL_EMB) != 0;
  constexpr int ATTN = (VAR >> ABL_ATTN_SHIFT) & 3;
  constexpr int PROJ = (VAR >> ABL_PROJ_SHIFT) & 3;

  extern __shared__ float4 smem_f4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_f4);
  const int K = E + F;
  const int G = NG * H;
  const TcSmem lay(L, A, K, H, NG, R, SLOTS);
  const int xld = lay.xld, hld = lay.hld;
  bf16* x_s = reinterpret_cast<bf16*>(sm + lay.x);
  bf16* h_s = reinterpret_cast<bf16*>(sm + lay.h);
  bf16* c_s = reinterpret_cast<bf16*>(sm + lay.c);      // bf16, as stored
  float* wh_s = reinterpret_cast<float*>(sm + lay.wh);
  float* sc_s = reinterpret_cast<float*>(sm + lay.sc);
  float* aw_s = reinterpret_cast<float*>(sm + lay.att);  // attn w, then b
  int* red_key = reinterpret_cast<int*>(sm + lay.red);  // [NWARPS][R]
  int* red_idx = red_key + NWARPS * R;
  int* tok_s = reinterpret_cast<int*>(sm + lay.tok);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * R;
  bf16* ring = reinterpret_cast<bf16*>(sm + lay.ring)
               + (size_t)warp * SLOTS * NG * TILE;

  // fragment coordinates of this lane. Accumulator element e holds unit
  // g + 8 (e / 2) of the tile and row 2 t4 + e % 2 of its half.
  const int g = lane >> 2, t4 = lane & 3;
  // ldmatrix.trans row of a swizzled [16 inputs][16 units] tile: lanes
  // 0-7 / 8-15 / 16-23 / 24-31 read inputs 0-7 / 0-7 / 8-15 / 8-15 at
  // units 0-7 / 8-15 / 0-7 / 8-15 (a[0..3])
  const int a_k = (lane & 7) + ((lane >> 4) << 3);
  const int a_off = a_k * 16 + ((((lane >> 3) & 1) ^ ((a_k >> 2) & 1)) << 3);
  // ldmatrix row of the rows' vectors: row lane % 8 of the half, inputs +8
  // for lanes 8-15
  const int b_row = lane & 7, b_k = ((lane >> 3) & 1) << 3;
  // this lane's 16-byte chunk of a tile (row-major [16 inputs][16 units]
  // in the weight tiles): input lane / 2, units +8 if odd, swizzled
  const int c_k = lane >> 1;
  const int c_off = c_k * 16 + (((lane & 1) ^ ((c_k >> 2) & 1)) << 3);

  for (int i = tid; i < R * xld; i += THREADS) x_s[i] = from_f<bf16>(0.f);
  for (int i = tid; i < R * H; i += THREADS) {
    const int b = i / H, j = i % H, row = row0 + b;
    const bool ok = row < B;
    h_s[b * hld + j] = ok ? h0[(size_t)row * H + j] : from_f<bf16>(0.f);
    c_s[i] = ok ? c0[(size_t)row * H + j] : from_f<bf16>(0.f);
  }
  if (tid < R) tok_s[tid] = row0 + tid < B ? tok0[row0 + tid] : 0;
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
      for (int b = 0; b < R; ++b) stop &= row0 + b >= B || tok_s[b] == 0;
      if (stop) break;
    }
    const bf16* hc = h_s + (size_t)cur * R * hld;
    bf16* hn = h_s + (size_t)(cur ^ 1) * R * hld;

    // 1. embedding rows (a zero row outside [0, V)), scaled, in bf16 (the
    //    emb stub leaves the zero rows of the start); and W h on tensor
    //    cores, one 16-unit tile of A a warp
    if constexpr (!NO_EMB) {
      for (int i = tid; i < R * E; i += THREADS) {
        const int b = i / E, k = i % E, tk = tok_s[b];
        float v = 0.f;
        if ((unsigned)tk < (unsigned)V)
          v = to_f(emb[(size_t)tk * E + k]) * emb_scale;
        x_s[b * xld + k] = from_f<bf16>(v);
      }
    }
    // the attn stub: ctx stays the zero of the start
    if constexpr (ATTN != 1) {
      {
        float acc[NH][4] = {};
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
          unsigned bfr[NH][2], af[4];
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
            ldmatrix_x2(bfr[hh],
                        hc + (hh * TB + b_row) * hld + cs * 16 + b_k);
          ldmatrix_x4<true>(af, ring + slot * (NG * TILE) + a_off);
#pragma unroll
          for (int hh = 0; hh < NH; ++hh) {
            float d[4];
            fresh_mma(d, af, bfr[hh]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[hh][e] += d[e];
          }
          if (++cs < nKh) return;
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int a = cu * 16 + g + (e >> 1) * 8;
              if (a < A) wh_s[(hh * TB + 2 * t4 + (e & 1)) * A + a] =
                  acc[hh][e];
              acc[hh][e] = 0.f;
            }
          cs = 0;
          cu += NWARPS;
        };
        warp_pipeline<SLOTS>(n_items, issue, consume);
      }
      __syncthreads();

      // 2. scores: one warp per (row, frame), two in flight
#pragma unroll 2
      for (int p = warp; p < R * L; p += NWARPS) {
        const int b = p / L, f = p % L, row = row0 + b;
        float s = 0.f;
        if (row < B) {
          const bf16* uvp = uv + ((size_t)row * L + f) * A;
          if constexpr (ATTN == 2) {   // score1: act[0], no attn_w dot
            if (lane == 0) s = tanhf(wh_s[b * A] + to_f(uvp[0]) + aw_s[A]);
          } else {
            for (int a = lane; a < A; a += 32)
              s += tanhf(wh_s[b * A + a] + to_f(uvp[a]) + aw_s[A + a])
                   * aw_s[a];
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) sc_s[b * L + f] = s;
      }
      __syncthreads();

      // 3. ctx = sum_f score_f enc_f / L in f32 (f in order), cast to bf16
      if constexpr (ATTN == 3) {   // fma: sum_f score_f, no enc, no / L
        for (int i = tid; i < R * F; i += THREADS) {
          const int b = i / F, e = i % F;
          float acc = 0.f;
          for (int f = 0; f < L; ++f) acc += sc_s[b * L + f];
          x_s[b * xld + E + e] = from_f<bf16>(acc);
        }
      } else if (vec_enc) {   // 8 features, 16 bytes, a load
        const int F8 = F / 8;
        for (int i = tid; i < R * F8; i += THREADS) {
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
        for (int i = tid; i < R * F; i += THREADS) {
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
    }
    __syncthreads();

    // 4. gates on tensor cores: the warp's unit tiles ut = warp, warp +
    //    NWARPS, ..., each nKx k16 steps of w_ih x, then nKh of w_hh h;
    //    under DUAL each A fragment meets both halves' B fragments
    {
      float ai[NH][NG][4] = {}, ah[NH][NG][4] = {};
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
        unsigned bfr[NH][2];
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {
          const int r = hh * TB + b_row;
          ldmatrix_x2(bfr[hh], hp ? hc + r * hld + (cs - nKx) * 16 + b_k
                                  : x_s + r * xld + cs * 16 + b_k);
        }
        const bf16* tile = ring + slot * (NG * TILE) + a_off;
#pragma unroll
        for (int gt = 0; gt < NG; ++gt) {
          unsigned af[4];
          ldmatrix_x4<true>(af, tile + gt * TILE);
#pragma unroll
          for (int hh = 0; hh < NH; ++hh) {
            float d[4];
            fresh_mma(d, af, bfr[hh]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (hp)
                ah[hh][gt][e] += d[e];
              else
                ai[hh][gt][e] += d[e];
            }
          }
        }
        if (++cs < nKg) return;
        // the cell of units cu * 16.., in registers
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = cu * 16 + g + (e >> 1) * 8;
            const int b = hh * TB + 2 * t4 + (e & 1);
            float gi[NG], gh[NG];
#pragma unroll
            for (int gt = 0; gt < NG; ++gt) {
              gi[gt] = ai[hh][gt][e] + to_f(bias2[gt * H + j]);
              gh[gt] = ah[hh][gt][e] + to_f(bias2[G + gt * H + j]);
              ai[hh][gt][e] = ah[hh][gt][e] = 0.f;
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
      warp_pipeline<SLOTS>(n_items, issue, consume);
    }
    __syncthreads();

    if constexpr (PROJ == 1) {   // the proj stub: the token stays
      if (tid < R && row0 + tid < B)
        tokens[(size_t)(row0 + tid) * n_steps + t] = tok_s[tid];
    } else {
      // 5. logits = h' @ out_w + out_b on tensor cores, PT column tiles an
      //    item, and a running (max key, first index) of the thread's two
      //    rows of each half over the accumulator fragments
      int best_key[NH][2], best_idx[NH][2];
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          best_key[hh][q] = INT_MIN;
          best_idx[hh][q] = INT_MAX;
        }
      {
        float acc[NH][PT][4] = {};
        const int n_items = (n_vg - warp + NWARPS - 1) / NWARPS * nKh;
        int is = 0, iv = warp;
        auto issue = [&](int slot) {
          const bf16* src =
              wo + (size_t)(iv * nKh + is) * PT * TILE + lane * 8;
          bf16* dst = ring + slot * (NG * TILE) + c_off;
#pragma unroll
          for (int p = 0; p < PT; ++p)
            cp_async16(dst + p * TILE, src + p * TILE);
          if (++is == nKh) {
            is = 0;
            iv += NWARPS;
          }
        };
        int cs = 0, cv = warp;
        auto consume = [&](int slot) {
          unsigned bfr[NH][2];
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
            ldmatrix_x2(bfr[hh],
                        hn + (hh * TB + b_row) * hld + cs * 16 + b_k);
          const bf16* tile = ring + slot * (NG * TILE) + a_off;
#pragma unroll
          for (int p = 0; p < PT; ++p) {
            unsigned af[4];
            ldmatrix_x4<true>(af, tile + p * TILE);
#pragma unroll
            for (int hh = 0; hh < NH; ++hh) {
              float d[4];
              fresh_mma(d, af, bfr[hh]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[hh][p][e] += d[e];
            }
          }
          if (++cs < nKh) return;
#pragma unroll
          for (int p = 0; p < PT; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int v = (cv * PT + p) * 16 + g + (e >> 1) * 8;
              const float bv = v < V ? to_f(out_b[v]) : 0.f;
#pragma unroll
              for (int hh = 0; hh < NH; ++hh) {
                if (v < V) {
                  const int key = argmax_key<PROJ>(acc[hh][p][e] + bv);
                  const int q = e & 1;
                  if (key_wins(key, v, best_key[hh][q], best_idx[hh][q])) {
                    best_key[hh][q] = key;
                    best_idx[hh][q] = v;
                  }
                }
                acc[hh][p][e] = 0.f;
              }
            }
          cs = 0;
          cv += NWARPS;
        };
        warp_pipeline<SLOTS>(n_items, issue, consume);
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
      if (tid < R) {
        int k = red_key[tid], i = red_idx[tid];
        for (int w = 1; w < NWARPS; ++w) {
          if (key_wins(red_key[w * R + tid], red_idx[w * R + tid], k, i)) {
            k = red_key[w * R + tid];
            i = red_idx[w * R + tid];
          }
        }
        i = argmax_token<PROJ>(k, i);
        tok_s[tid] = i;
        if (row0 + tid < B) tokens[(size_t)(row0 + tid) * n_steps + t] = i;
      }
    }
    __syncthreads();
    cur ^= 1;
  }

  const bf16* h_fin = h_s + (size_t)cur * R * hld;
  for (int i = tid; i < R * H; i += THREADS) {
    const int b = i / H, j = i % H, row = row0 + b;
    if (row < B) {
      h_out[(size_t)row * H + j] = h_fin[b * hld + j];
      c_out[(size_t)row * H + j] = c_s[i];
    }
  }
  if (tid < R && row0 + tid < B) tok_out[row0 + tid] = tok_s[tid];
}

// the launch's operands, as the C entry points take them
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

// the tensor-core body's shared memory for a variant, in bytes
inline size_t tc_smem(int NG, int var, int L, int A, int K, int H) {
  return TcSmem(L, A, K, H, NG, tc_rows(var), tc_slots(NG, var)).total;
}

template <int NG, int VAR>
int launch_tc(const Operands& o, cudaStream_t stream) {
  constexpr int R = tc_rows(VAR);
  if (o.H % 16 != 0 || (size_t)o.w_ih % 16 != 0 || (size_t)o.out_w % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc_smem(NG, VAR, o.L, o.A, o.E + o.F, o.H);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = tc_decode_kernel<NG, VAR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_enc = o.F % 8 == 0 && (size_t)o.enc % 16 == 0;
  const dim3 grid((o.B + R - 1) / R);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const bf16*)o.enc, (const bf16*)o.uv, (const bf16*)o.emb,
      (const bf16*)o.attn_W, (const bf16*)o.attn_w, (const bf16*)o.attn_b,
      (const bf16*)o.w_ih, (const bf16*)o.bias2, (const bf16*)o.out_w,
      (const bf16*)o.out_b, (const bf16*)o.h0, (const bf16*)o.c0, o.tok0,
      o.tokens, (bf16*)o.h_out, (bf16*)o.c_out, o.tok_out, o.B, o.L, o.F,
      o.A, o.E, o.H, o.V, o.n_steps, o.emb_scale, vec_enc);
  return (int)cudaGetLastError();
}

}  // namespace
