// Whole-rollout kernels of the training rollouts' LSTM / GRU cell, for
// NVIDIA Hopper (sm_90a): one persistent launch runs all T steps of
// lstm_rollout_pre / gru_rollout_pre forward, one runs all of its backward.
//
// What they replace: the JAX package's custom-VJP rollouts
// (recnet_tpu/ops/rnn.py:207-282, on rollout_cell_fwd :153 and
// rollout_cell_bwd :181), which XLA fuses; no Pallas kernel is on this
// path. rollout.cu's per-step kernels (cell_fwd_kernel, cell_bwd_kernel)
// ran one launch a step beside one cuBLAS product a step, and each launch
// cost more host time than the card spent on it.
//
// What the kernels compute, in the order and with the rounding of that
// per-step route (ops/rnn.py before; ops/cuda/rollout.py's
// cell_rollout_*_reference is the plain version):
//   forward, step t: P = h_{t-1} W_hh (f32 sums), then LSTM gates =
//     round(gi_t + P) + b_hh -> i, f, g, o, c_t, h_t; GRU gh = round(P),
//     h_n = round(gh_n + b_hn), r, z, n, h_t. Writes hs, cs (LSTM) and
//     acts [i, f, g, o] / [r, z, n, h_n] (T, B, 4H).
//   backward, t = T-1 .. 0: the cell's cotangents from the carried dh
//     (+ dhs[t]) and dc -> dgates[t] (LSTM) or dgi[t], dgh[t] (GRU), dc
//     (round(dc f)) or GRU's round(dh z); then dh = round(P) (LSTM) or
//     round(round(dh z) + P) (GRU), P = dgates_t W_hh^T. dh and dc after
//     step 0 are dh0 and dc0. d W_hh and d b_hh stay outside (one product
//     and one sum over all T B rows, as the JAX package leaves them to
//     XLA).
// Operands float32 or bfloat16, sums in f32, stores in the operand type.
//
// What bounds them on the H100 (flagship reconstructor: LSTM, B = 100,
// H = 1536, G = 6144, T = 31): bf16, the operations, 2 B H G T = 58.5
// GFLOP a direction, 0.059 ms at 989 TFLOP/s (bytes 0.03-0.04 ms); f32 on
// the CUDA cores (TF32 stays off), 1.1 ms at 51.5 TFLOP/s. What a step
// needs of other blocks is what paces it: every block needs every other
// block's h_t (forward) or dgates_t (backward) before the next product.
//
// The design:
// * Persistent and co-resident: one block an SM (about 128), launched
//   cooperatively (the runtime refuses a grid the card cannot hold at
//   once), one grid barrier a step: a sense-reversing barrier on a
//   counter and a generation word in global memory (release on arrival,
//   acquire on the wait, as cooperative groups' grid sync does).
// * The recurrent weight held on chip (bf16): each block copies its slice
//   of W_hh (H G / blocks: 147 KB at the flagship) into shared memory at
//   entry, laid out [row][k] with k contiguous, and reads it from there
//   for all T steps. In f32 (295 KB a block) the slice does not fit: it
//   streams from L2 a chunk at a time beside the activations.
// * The product on the tensor cores (bf16): mma.sync m16n8k16 with f32
//   accumulators, the weight as the A operand (16 of the block's rows),
//   the batch as N (8 rows a tile; B = 100 takes 13 tiles, 104 rows), so
//   that the activations' natural row-major layout is the B operand. The
//   activations are staged into shared memory in chunks of 64 k by 16-byte
//   cp.async (cg: L2 only, since other SMs wrote them), three chunks in
//   flight. Sixteen warps: 2 (weight rows) x 4 (batch) x 2 (k halves of a
//   chunk); the k halves are summed through shared memory. f32: the same
//   pipeline with the weight chunk staged too, and 8 x 4 register tiles of
//   FMAs.
// * Split K inside a cluster: a cluster of C blocks shares a group of
//   units. In the forward (C = 2) block r takes the k slice r of h
//   (H / C) against all of the cluster's gate columns; in the backward
//   (C = 8) the slice r of dgates (G / C) against the cluster's units'
//   rows of W_hh. Each block writes its partial sums to shared memory;
//   after a cluster barrier each block sums the C partials of its own
//   units through distributed shared memory, rank by rank. So a block
//   reads 1/C of the exchanged activations a step: 154 KB of h (forward),
//   154 KB of dgates (backward) at the flagship, in place of 307 KB and
//   1.2 MB.
// * The cell where its gates are: the block that sums a unit's gates runs
//   that unit's cell and writes its outputs; the carries (the LSTM's c,
//   the backward's dc and GRU's dh z) are the block's own rows of
//   global buffers (cs, dc0, dh0), read and written by no other block.
//   Only h_t (forward) or dgates_t (backward) crosses blocks.
// * Sums in a fixed order, no atomics on values: a rerun repeats its
//   numbers. dh_steps / dc_steps, where given, receive the backward's
//   carries into each step, so that a test can hold each step against the
//   plain step from the kernel's own carries.
//
// What the split showed (chip_smoke.py [train] (d), the flagship's
// reconstructor in bf16 on an H100, device time): forward 0.79 ms, of
// which the product 0.44 (its MMAs 0.29, the staging the rest) and the
// exchange 0.17; backward 0.95 ms, product 0.46 (MMAs 0.34), exchange
// 0.29. About 6 us a step is neither: the cells' dependent loads and the
// block's barriers. Each part is latency at a block an SM, so the kernels
// sit at 13-16x their bound; cuDNN's LSTM takes 0.39 and 0.45 ms of device
// time at these shapes. f32 took 3.4 and 3.3 ms, above the per-step
// route's cuBLAS products, so ops/rnn.py keeps f32 on that route.
//
// Split probes (probe bits; 0 is the kernel the rollouts launch):
// kNoProduct drops the staging and the products (P = 0); kNoMma keeps the
// staging and drops the MMAs (P = 0); kNoExchange drops the grid barrier
// and the cluster's sum (each block adds only its own partial) and reads
// the product's activations from an input of the same width (h0 forward,
// acts[t] backward), so that its outputs are defined. The probes are timed
// by chip_smoke.py and count no launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "decode_common.cuh"
#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using recnet::cp_async16;
using recnet::cp_async_commit;
using recnet::cp_async_wait;
using recnet::from_f;
using recnet::ldmatrix_x2;
using recnet::ldmatrix_x4;
using recnet::mma_bf16;
using recnet::round_to;
using recnet::sigmoid;
using recnet::to_f;

constexpr int kThreads = 512;
constexpr int kKC = 64;          // k of a staged chunk
constexpr int kStages = 3;       // chunks in flight
constexpr int kMaxRows = 128;    // padded product rows a block (8 m-tiles)
constexpr int kPassRows = 112;   // batch rows a pass (14 n-tiles of 8)
constexpr int kMW = 4, kNW = 4;  // m- and n-tiles a warp, at most (bf16)
constexpr int kFT = 1;           // 8 x 4 register tiles a thread (f32)
constexpr int kNoProduct = 1, kNoExchange = 2, kNoMma = 4;
constexpr int kMaxPairs = 4;     // (unit, row) pairs a thread in a pass
constexpr int kFwdCluster = 2, kBwdCluster = 8;
// which product sources may be copied in 16-byte pieces
constexpr int kVecH0 = 1, kVecHs = 2, kVecDg = 4, kVecActs = 8, kVecW = 16;

template <typename T>
struct RollArgs {
  int steps, B, H, G;          // T, batch, hidden, gate width (nG H)
  int C, ub, Mpad, kc, Bp;     // cluster size, units a block, padded rows,
                               // k slice width, batch rows a pass
  int probe, vec;
  const T* gi;                 // forward: (T, B, G)
  const T* w;                  // (H, G)
  const T* bias;               // (G)
  const T* h0;
  const T* c0;
  T* hs;                       // forward out; backward in (GRU)
  T* cs;                       // forward out; backward in (LSTM)
  T* acts;                     // forward out; backward in
  const T* dhs;                // backward in
  T* dgi;                      // backward out: LSTM's dgates, GRU's dgi
  T* dgh;                      // backward out: GRU
  T* dh0;                      // backward out; GRU's dh z carry
  T* dc0;                      // backward out; LSTM's dc carry
  T* dh_steps;                 // backward out, or null: the carried dh
  T* dc_steps;                 // and dc (LSTM) into each step (T, B, H)
  unsigned* bar;               // grid barrier: count, generation
};

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ constexpr int round_up(int a, int b) {
  return ceil_div(a, b) * b;
}

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float ldcg_f(const float* p) { return __ldcg(p); }

__device__ __forceinline__ float ldcg_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// 4 bytes global -> shared (L1 allowed: only read-only operands), or 4 zero
// bytes when !ok
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   recnet::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// cycles a block waits at the grid barrier before it gives up (about 10 s:
// a launch whose blocks are not all resident faults instead of hanging)
constexpr long long kBarrierTimeout = 20000000000LL;

// Every block of the grid waits here until all have arrived. bar[0]
// counts arrivals and is back at 0 when the barrier opens; bar[1] is the
// generation, advanced by the last block to arrive. Needs every block
// resident at once (the cooperative launch).
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);
    __threadfence();
    if (atom_add_acq_rel(bar, 1u) == gridDim.x - 1) {
      *reinterpret_cast<volatile unsigned*>(bar) = 0u;
      st_release(bar + 1, gen + 1u);
    } else {
      const long long start = clock64();
      while (ld_acquire(bar + 1) == gen) {
        __nanosleep(32);
        if (clock64() - start > kBarrierTimeout) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T zero_t() {
  return from_f<T>(0.0f);
}

// The block's weight element at product row m, slice column k (the k
// slice starts at kbeg), as an index into W_hh (H, G); -1 outside it.
// Forward rows: gate g of the cluster's unit cu at m = g (C ub) + cu, k
// along H. Backward rows: the cluster's unit m, k along G.
template <bool FWD>
__device__ __forceinline__ long w_index(int m, int k, int M, int cu0,
                                        int Cub, int kbeg, int kend, int H,
                                        int G) {
  const int kk = kbeg + k;
  if (m >= M || kk >= kend) return -1;
  if (FWD) {
    const int g = m / Cub, unit = cu0 + m % Cub;
    return unit < H ? (long)kk * G + (long)g * H + unit : -1;
  }
  const int unit = cu0 + m;
  return unit < H ? (long)unit * G + kk : -1;
}

// Block-wide: activations X[b][k0 .. k0 + kKC) of rows b_lo .. b_lo +
// rows into dst [rows][XP], zero past B and past kend. Whole 16-byte
// pieces by cp.async (cg) where vec allows it; the rest by L2 loads.
template <typename T>
__device__ __forceinline__ void stage_x(T* dst, const T* X, int ldx, bool vec,
                                        int B, int b_lo, int rows, int k0,
                                        int kend) {
  constexpr int E = 16 / (int)sizeof(T), PER_ROW = kKC / E, XP = kKC + E;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * E;
    T* d = dst + r * XP + c;
    const int b = b_lo + r, k = k0 + c;
    if (b >= B || k >= kend) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const T* s = X + (long)b * ldx + k;
    if (vec && k + E <= kend) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        d[e] = k + e < kend ? from_f<T>(ldcg_f(s + e)) : zero_t<T>();
    }
  }
}

// Block-wide (f32): the weight chunk [Mpad][k0 .. k0 + kKC) of the block's
// slice into dst [Mpad][XP] by 4-byte cp.async (W_hh is read-only).
template <bool FWD>
__device__ __forceinline__ void stage_w(float* dst, const float* w, int Mpad,
                                        int k0, int M, int cu0, int Cub,
                                        int kbeg, int kend, int H, int G) {
  constexpr int XP = kKC + 4;
  for (int i = threadIdx.x; i < Mpad * kKC; i += kThreads) {
    int m, k;
    if (FWD) {            // along the gate columns: contiguous in W_hh
      m = i % Mpad;
      k = i / Mpad;
    } else {              // along k: contiguous in W_hh
      k = i % kKC;
      m = i / kKC;
    }
    const long idx = w_index<FWD>(m, k0 + k, M, cu0, Cub, kbeg, kend, H, G);
    cp_async4_zfill(dst + m * XP + k, idx >= 0 ? w + idx : w, idx >= 0);
  }
}

// The inputs of the backward cell of unit j, batch row b at step t (the
// carried dh and, unless `first`, dc aside): dhs, the four activations,
// and the LSTM's c_t and c_prev or the GRU's h_prev.
template <typename T, bool LSTM>
__device__ __forceinline__ void bwd_cell_load(const RollArgs<T>& a, int t,
                                              int j, int b, float in[7]) {
  const int H = a.H;
  const long row = (long)t * a.B + b, bj = (long)b * H + j;
  const T* act = a.acts + row * 4 * H + j;
  in[0] = to_f(a.dhs[row * H + j]);
#pragma unroll
  for (int g = 0; g < 4; ++g) in[1 + g] = to_f(act[g * H]);
  if constexpr (LSTM) {
    in[5] = to_f(a.cs[row * H + j]);
    in[6] = to_f(t == 0 ? a.c0[bj] : a.cs[(row - a.B) * H + j]);
  } else {
    in[5] = to_f(t == 0 ? a.h0[bj] : a.hs[(row - a.B) * H + j]);
  }
}

// The backward cell of unit j, batch row b at step t from its inputs, the
// carried dh (a stored value) and the LSTM's carried dc: writes the step's
// gate cotangents, the carries into the step (where asked) and the
// carries out (dc0: round(dc f); GRU's dh0: round(dh z)).
template <typename T, bool LSTM>
__device__ __forceinline__ void bwd_cell_store(const RollArgs<T>& a, int t,
                                               int j, int b, const float in[7],
                                               float dh_next, float dcn) {
  const int H = a.H;
  const long row = (long)t * a.B + b, bj = (long)b * H + j;
  const float dh = dh_next + in[0];
  if (a.dh_steps) a.dh_steps[row * H + j] = from_f<T>(dh_next);
  if constexpr (LSTM) {
    const float i = in[1], f = in[2], g = in[3], o = in[4];
    const float tc = tanhf(in[5]), cp = in[6];
    const float dc = dcn + dh * o * (1.0f - tc * tc);
    if (a.dc_steps) a.dc_steps[row * H + j] = from_f<T>(dcn);
    T* d = a.dgi + row * a.G + j;
    d[0] = from_f<T>(dc * g * i * (1.0f - i));
    d[H] = from_f<T>(dc * cp * f * (1.0f - f));
    d[2 * H] = from_f<T>(dc * i * (1.0f - g * g));
    d[3 * H] = from_f<T>(dh * tc * o * (1.0f - o));
    a.dc0[bj] = from_f<T>(dc * f);
  } else {
    const float r = in[1], z = in[2], nn = in[3], hn = in[4], hp = in[5];
    const float dn = dh * (1.0f - z) * (1.0f - nn * nn);
    const float dr = dn * hn * r * (1.0f - r);
    const float dz = dh * (hp - nn) * z * (1.0f - z);
    T* di = a.dgi + row * a.G + j;
    T* dg = a.dgh + row * a.G + j;
    di[0] = dg[0] = from_f<T>(dr);
    di[H] = dg[H] = from_f<T>(dz);
    di[2 * H] = from_f<T>(dn);
    dg[2 * H] = from_f<T>(dn * r);
    a.dh0[bj] = from_f<T>(dh * z);
  }
}

// Block-wide (bf16): the block's slice of W_hh into Ws [Mpad][WP], zero
// outside it. Backward rows lie along k in W_hh: 16-byte cp.async pieces
// (committed as one group, waited on with the first chunk). Forward rows
// are W_hh's columns: 16-byte loads of 8 units of a gate, four a thread in
// flight, each scattered down a column of Ws. Pieces that `vec` or the
// edges rule out go element by element.
template <bool FWD>
__device__ __forceinline__ void load_w(__nv_bfloat16* Ws, int WP,
                                       const __nv_bfloat16* w, bool vec,
                                       int Mpad, int kc, int M, int cu0,
                                       int Cub, int kbeg, int kend, int H,
                                       int G, int nG) {
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  if (FWD) {
    const int per_gate = vec && Cub % 8 == 0 ? Cub / 8 : 0;
    const int nvec = kc * nG * per_gate;
    for (int i0 = threadIdx.x; i0 < nvec; i0 += 4 * kThreads) {
      uint4 v[4];
      int mk[4][2];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = i0 + s * kThreads;
        mk[s][0] = -1;
        if (i < nvec) {
          const int p = i % per_gate, g = (i / per_gate) % nG;
          const int k = i / (per_gate * nG), unit = cu0 + 8 * p;
          mk[s][0] = g * Cub + 8 * p;
          mk[s][1] = k;
          if (kbeg + k < kend && unit + 8 <= H)
            v[s] = __ldg(reinterpret_cast<const uint4*>(
                w + (long)(kbeg + k) * G + (long)g * H + unit));
          else
            mk[s][0] = -2 - mk[s][0];   // by elements
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (mk[s][0] == -1) continue;
        const int k = mk[s][1];
        if (mk[s][0] >= 0) {
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[s]);
#pragma unroll
          for (int q = 0; q < 8; ++q) Ws[(mk[s][0] + q) * WP + k] = e[q];
        } else {
          const int m0 = -2 - mk[s][0];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const long idx = w_index<true>(m0 + q, k, M, cu0, Cub, kbeg, kend,
                                           H, G);
            Ws[(m0 + q) * WP + k] = idx >= 0 ? w[idx] : zero;
          }
        }
      }
    }
    if (per_gate == 0) {
      for (int i = threadIdx.x; i < Mpad * kc; i += kThreads) {
        const int m = i % Mpad, k = i / Mpad;
        const long idx = w_index<true>(m, k, M, cu0, Cub, kbeg, kend, H, G);
        Ws[m * WP + k] = idx >= 0 ? w[idx] : zero;
      }
    } else {          // the padded rows
      for (int i = threadIdx.x; i < (Mpad - nG * Cub) * kc; i += kThreads)
        Ws[(nG * Cub + i / kc) * WP + i % kc] = zero;
    }
  } else {
    const int per_row = kc / 8;
    for (int i = threadIdx.x; i < Mpad * per_row; i += kThreads) {
      const int m = i / per_row, k = (i - m * per_row) * 8;
      __nv_bfloat16* d = Ws + m * WP + k;
      const int unit = cu0 + m;
      if (vec && m < M && unit < H && kbeg + k + 8 <= kend) {
        cp_async16(d, w + (long)unit * G + kbeg + k);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const long idx = w_index<false>(m, k + q, M, cu0, Cub, kbeg, kend,
                                          H, G);
          d[q] = idx >= 0 ? w[idx] : zero;
        }
      }
    }
    cp_async_commit();
  }
}

template <typename T, bool LSTM, bool FWD>
__global__ void __launch_bounds__(kThreads, 1)
cell_rollout_kernel(const RollArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int nG = LSTM ? 4 : 3;
  constexpr int E = 16 / (int)sizeof(T), XP = kKC + E;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, G = a.G, B = a.B, C = a.C, ub = a.ub, Mpad = a.Mpad;
  const int rank = (int)(blockIdx.x % C), q = (int)(blockIdx.x / C);
  const int Cub = C * ub, cu0 = q * Cub;        // the cluster's units
  const int M = FWD ? nG * Cub : Cub;           // product rows
  const int K = FWD ? H : G;
  const int kbeg = rank * a.kc, kend = min(K, kbeg + a.kc);
  const int nchunks = a.kc / kKC;
  const int u_lo = cu0 + rank * ub;             // the block's own units
  const bool exchange = !(a.probe & kNoExchange);
  const bool cluster_sum = exchange && C > 1;
  const bool product = !(a.probe & kNoProduct);
  const bool mma = !(a.probe & kNoMma);
  const int WP = a.kc + 8;                      // the held slice's pitch
  const int PP = a.Bp + 4;                      // partial sums' pitch
  T* Ws = reinterpret_cast<T*>(smem);
  unsigned char* region =
      smem + (kBf16 ? round_up(Mpad * WP * (int)sizeof(T), 16) : 0);
  T* Xs = reinterpret_cast<T*>(region);         // [kStages][Bp][XP]
  float* Wst = reinterpret_cast<float*>(Xs + kStages * a.Bp * XP);
  float* Ps = reinterpret_cast<float*>(region); // [Mpad][PP], over the stages

  if constexpr (kBf16)        // the block's slice of W_hh, held for all T
    load_w<FWD>(Ws, WP, a.w, a.vec & kVecW, Mpad, a.kc, M, cu0, Cub, kbeg,
                kend, H, G, nG);

  // One pass of step t over batch rows b_lo .. b_lo + bp: P = W_blk X^T
  // over the block's k slice into Ps[m][b - b_lo] (all Mpad rows, bp
  // rounded up to 8 columns); the cluster's sum; then each of the block's
  // own (unit, row) pairs: its P summed over the cluster's ranks in order
  // and its inputs read for all of a thread's pairs first, then its cell.
  // Unless a grid barrier follows (`barrier_next`: every block has then
  // read its peers' partials before any block overwrites its own), a
  // barrier of the cluster (or the block) ends the pass.
  auto pass = [&](const T* X, int ldx, bool xvec, int b_lo, int bp, int t,
                  bool barrier_next) {
    const int bp8 = round_up(bp, 8);
    if constexpr (kBf16) {
      const int wk = warp & 1, wn = (warp >> 1) & 3, wm = warp >> 3;
      const int mtiles = Mpad / 16, ntiles = bp8 / 8;
      float acc[kMW][kNW][4];
#pragma unroll
      for (int i = 0; i < kMW; ++i)
#pragma unroll
        for (int j = 0; j < kNW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
      if (product) {
#pragma unroll 1
        for (int s = 0; s < kStages - 1; ++s) {
          if (s < nchunks)
            stage_x(Xs + s * a.Bp * XP, X, ldx, xvec, B, b_lo, bp8,
                    kbeg + s * kKC, kend);
          cp_async_commit();
        }
#pragma unroll 1
        for (int c = 0; c < nchunks; ++c) {
          cp_async_wait<kStages - 2>();
          __syncthreads();
          const int nx = c + kStages - 1;
          if (nx < nchunks)
            stage_x(Xs + (nx % kStages) * a.Bp * XP, X, ldx, xvec, B, b_lo,
                    bp8, kbeg + nx * kKC, kend);
          cp_async_commit();
          const T* xs = Xs + (c % kStages) * a.Bp * XP;
          if (!mma) continue;
#pragma unroll
          for (int kk = 0; kk < kKC / 16; kk += 2) {
            const int ks = kk + wk;
            unsigned af[kMW][4], bf[kNW][2];
#pragma unroll
            for (int i = 0; i < kMW; ++i) {
              const int mt = wm + 2 * i;
              if (mt < mtiles)
                ldmatrix_x4<false>(af[i],
                                   Ws + (mt * 16 + (lane & 15)) * WP +
                                       c * kKC + ks * 16 + ((lane >> 4) << 3));
            }
#pragma unroll
            for (int j = 0; j < kNW; ++j) {
              const int nt = wn + 4 * j;
              if (nt < ntiles)
                ldmatrix_x2(bf[j], xs + (nt * 8 + (lane & 7)) * XP +
                                       ks * 16 + ((lane >> 3) & 1) * 8);
            }
#pragma unroll
            for (int i = 0; i < kMW; ++i)
#pragma unroll
              for (int j = 0; j < kNW; ++j)
                if (wm + 2 * i < mtiles && wn + 4 * j < ntiles)
                  mma_bf16(acc[i][j], af[i], bf[j]);
          }
        }
      }
      cp_async_wait<0>();     // (the held slice's copies, without a product)
      __syncthreads();        // the stages are free: Ps lies over them
      const int g = lane >> 2, t4 = lane & 3;
      // the k halves: the second warp of each pair stores, the first adds
#pragma unroll
      for (int half = 1; half >= 0; --half) {
        if (wk == half) {
#pragma unroll
          for (int i = 0; i < kMW; ++i)
#pragma unroll
            for (int j = 0; j < kNW; ++j) {
              const int mt = wm + 2 * i, nt = wn + 4 * j;
              if (mt < mtiles && nt < ntiles) {
                float* p0 = Ps + (mt * 16 + g) * PP + nt * 8 + 2 * t4;
                float* p1 = p0 + 8 * PP;
                float2 v0 = make_float2(acc[i][j][0], acc[i][j][1]);
                float2 v1 = make_float2(acc[i][j][2], acc[i][j][3]);
                if (half == 0) {
                  const float2 o0 = *reinterpret_cast<float2*>(p0);
                  const float2 o1 = *reinterpret_cast<float2*>(p1);
                  v0.x += o0.x; v0.y += o0.y;
                  v1.x += o1.x; v1.y += o1.y;
                }
                *reinterpret_cast<float2*>(p0) = v0;
                *reinterpret_cast<float2*>(p1) = v1;
              }
            }
        }
        __syncthreads();
      }
    } else {
      // f32: 8 x 4 tiles a thread, rows m = tm + i tmn, batch rows b = tb +
      // j tbn, from the staged weight and activation chunks
      const int tmn = Mpad / 8, tbn = bp8 / 4, tiles = tmn * tbn;
      float acc[kFT][8][4];
#pragma unroll
      for (int s = 0; s < kFT; ++s)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[s][i][j] = 0.0f;
      if (product) {
        const float* wf = reinterpret_cast<const float*>(a.w);
#pragma unroll 1
        for (int s = 0; s < kStages - 1; ++s) {
          if (s < nchunks) {
            stage_x(Xs + s * a.Bp * XP, X, ldx, xvec, B, b_lo, bp8,
                    kbeg + s * kKC, kend);
            stage_w<FWD>(Wst + s * Mpad * XP, wf, Mpad, s * kKC, M, cu0, Cub,
                         kbeg, kend, H, G);
          }
          cp_async_commit();
        }
#pragma unroll 1
        for (int c = 0; c < nchunks; ++c) {
          cp_async_wait<kStages - 2>();
          __syncthreads();
          const int nx = c + kStages - 1;
          if (nx < nchunks) {
            stage_x(Xs + (nx % kStages) * a.Bp * XP, X, ldx, xvec, B, b_lo,
                    bp8, kbeg + nx * kKC, kend);
            stage_w<FWD>(Wst + (nx % kStages) * Mpad * XP, wf, Mpad,
                         nx * kKC, M, cu0, Cub, kbeg, kend, H, G);
          }
          cp_async_commit();
          if (!mma) continue;
          const float* xs =
              reinterpret_cast<const float*>(Xs + (c % kStages) * a.Bp * XP);
          const float* ws = Wst + (c % kStages) * Mpad * XP;
#pragma unroll
          for (int s = 0; s < kFT; ++s) {
            const int tau = tid + s * kThreads;
            if (tau < tiles) {
              const int tm = tau % tmn, tb = tau / tmn;
#pragma unroll 2
              for (int k = 0; k < kKC; k += 4) {
                float4 wv[8], xv[4];
#pragma unroll
                for (int i = 0; i < 8; ++i)
                  wv[i] = *reinterpret_cast<const float4*>(
                      ws + (tm + i * tmn) * XP + k);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  xv[j] = *reinterpret_cast<const float4*>(
                      xs + (tb + j * tbn) * XP + k);
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    float v = acc[s][i][j];
                    v = fmaf(wv[i].x, xv[j].x, v);
                    v = fmaf(wv[i].y, xv[j].y, v);
                    v = fmaf(wv[i].z, xv[j].z, v);
                    v = fmaf(wv[i].w, xv[j].w, v);
                    acc[s][i][j] = v;
                  }
              }
            }
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();        // the stages are free: Ps lies over them
#pragma unroll
      for (int s = 0; s < kFT; ++s) {
        const int tau = tid + s * kThreads;
        if (tau < tiles) {
          const int tm = tau % tmn, tb = tau / tmn;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              Ps[(tm + i * tmn) * PP + tb + j * tbn] = acc[s][i][j];
        }
      }
      __syncthreads();
    }
    if (cluster_sum) cg::this_cluster().sync();   // the partials are out
    const int npairs = ub * bp;
    constexpr int kIn = FWD ? 3 * nG + 1 : 9;
    float in[kMaxPairs][kIn];
    // first every input of the thread's pairs (a thread past its pairs or
    // a unit past H reads a valid pair's, and stores nothing)
#pragma unroll
    for (int s = 0; s < kMaxPairs; ++s) {
      const int i = min(tid + s * kThreads, npairs - 1);
      const int u = i % ub, j = min(u_lo + u, H - 1), b = b_lo + i / ub;
      const long bj = (long)b * H + j;
      float* v = in[s];
      float P[nG];
#pragma unroll
      for (int g = 0; g < nG; ++g) P[g] = 0.0f;
      for (int r = 0; r < (cluster_sum ? C : 1); ++r) {
        const float* src =
            cluster_sum ? cg::this_cluster().map_shared_rank(Ps, r) : Ps;
        if (FWD) {
#pragma unroll
          for (int g = 0; g < nG; ++g)
            P[g] += src[(g * Cub + rank * ub + u) * PP + i / ub];
        } else {
          P[0] += src[(rank * ub + u) * PP + i / ub];
        }
      }
      if constexpr (FWD) {
        const long row = (long)t * B + b;
        const T* gi = a.gi + row * G + j;
#pragma unroll
        for (int g = 0; g < nG; ++g) {
          v[g] = P[g];
          v[nG + g] = to_f(gi[g * H]);
          v[2 * nG + 1 + g] = to_f(a.bias[g * H + j]);
        }
        if constexpr (LSTM)
          v[2 * nG] = t == 0 ? to_f(a.c0[bj])
                             : ldcg_f(a.cs + (row - B) * H + j);
        else
          v[2 * nG] = t == 0 ? to_f(a.h0[bj])
                             : ldcg_f(a.hs + (row - B) * H + j);
      } else {
        v[7] = P[0];
        v[8] = ldcg_f((LSTM ? a.dc0 : a.dh0) + bj);   // dc, or GRU's dh z
        if (t > 0) bwd_cell_load<T, LSTM>(a, t - 1, j, b, v);
      }
    }
    // then each pair's cell
#pragma unroll
    for (int s = 0; s < kMaxPairs; ++s) {
      const int i = tid + s * kThreads;
      const int j = u_lo + i % ub, b = b_lo + i / ub;
      if (i >= npairs || j >= H) continue;
      const float* v = in[s];
      const long row = (long)t * B + b, bj = (long)b * H + j;
      if constexpr (FWD) {
        T* act = a.acts + row * 4 * H + j;
        if constexpr (LSTM) {
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) pre[g] = round_to<T>(v[4 + g] + v[g]);
          const float ig = sigmoid(pre[0] + v[9]);
          const float f = sigmoid(pre[1] + v[10]);
          const float gg = tanhf(pre[2] + v[11]);
          const float o = sigmoid(pre[3] + v[12]);
          const float c = f * v[8] + ig * gg;
          a.cs[row * H + j] = from_f<T>(c);
          a.hs[row * H + j] = from_f<T>(o * tanhf(c));
          act[0] = from_f<T>(ig);
          act[H] = from_f<T>(f);
          act[2 * H] = from_f<T>(gg);
          act[3 * H] = from_f<T>(o);
        } else {
          const float gh0 = round_to<T>(v[0]), gh1 = round_to<T>(v[1]);
          const float hn = round_to<T>(round_to<T>(v[2]) + v[9]);
          const float r = sigmoid(v[3] + gh0 + v[7]);
          const float z = sigmoid(v[4] + gh1 + v[8]);
          const float nn = tanhf(v[5] + r * hn);
          a.hs[row * H + j] = from_f<T>((1.0f - z) * nn + z * v[6]);
          act[0] = from_f<T>(r);
          act[H] = from_f<T>(z);
          act[2 * H] = from_f<T>(nn);
          act[3 * H] = from_f<T>(hn);
        }
      } else {
        const float dh = LSTM ? round_to<T>(v[7]) : round_to<T>(v[8] + v[7]);
        if (t > 0)
          bwd_cell_store<T, LSTM>(a, t - 1, j, b, v, dh, LSTM ? v[8] : 0.0f);
        else
          a.dh0[bj] = from_f<T>(dh);
      }
    }
    if (barrier_next) return;
    if (cluster_sum)
      cg::this_cluster().sync();   // every block has read the partials
    else
      __syncthreads();
  };

  const bool vec_h0 = a.vec & kVecH0, vec_hs = a.vec & kVecHs;
  const bool vec_dg = a.vec & kVecDg, vec_acts = a.vec & kVecActs;
  if constexpr (FWD) {
#pragma unroll 1
    for (int t = 0; t < a.steps; ++t) {
      const bool first = t == 0 || !exchange;
      const T* X = first ? a.h0 : a.hs + (long)(t - 1) * B * H;
      const bool barrier = t + 1 < a.steps && exchange;
#pragma unroll 1
      for (int b_lo = 0; b_lo < B; b_lo += a.Bp)
        pass(X, H, first ? vec_h0 : vec_hs, b_lo, min(a.Bp, B - b_lo), t,
             barrier && b_lo + a.Bp >= B);
      if (barrier) grid_barrier(a.bar);
    }
  } else {
    // step T - 1's cell from zero carries
    for (int i = tid; i < ub * B; i += kThreads) {
      const int j = u_lo + i % ub, b = i / ub;
      if (j < H) {
        float v[7];
        bwd_cell_load<T, LSTM>(a, a.steps - 1, j, b, v);
        bwd_cell_store<T, LSTM>(a, a.steps - 1, j, b, v, 0.0f, 0.0f);
      }
    }
#pragma unroll 1
    for (int t = a.steps - 1; t >= 0; --t) {
      if (exchange) grid_barrier(a.bar);     // dgates[t] is complete
      const T* X = exchange ? (LSTM ? a.dgi : a.dgh) + (long)t * B * G
                            : a.acts + (long)t * B * 4 * H;
#pragma unroll 1
      for (int b_lo = 0; b_lo < B; b_lo += a.Bp)
        pass(X, exchange ? G : 4 * H, exchange ? vec_dg : vec_acts, b_lo,
             min(a.Bp, B - b_lo), t,
             t > 0 && exchange && b_lo + a.Bp >= B);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// plan fields (recnet_cell_rollout_plan's out)
enum { kPlanC, kPlanNB, kPlanUb, kPlanMpad, kPlanKc, kPlanBp, kPlanSmem,
       kPlanCap, kPlanLimit, kPlanFields };

template <typename T>
int smem_bytes(int Mpad, int kc, int Bp) {
  constexpr bool bf = sizeof(T) == 2;
  constexpr int XP = kKC + 16 / (int)sizeof(T);
  const int w = bf ? round_up(Mpad * (kc + 8) * 2, 16) : 0;
  const int stages = kStages * (Bp + (bf ? 0 : Mpad)) * XP * (int)sizeof(T);
  const int ps = Mpad * (Bp + 4) * (int)sizeof(float);
  return w + (stages > ps ? stages : ps);
}

#define RECNET_TRY(x)                              \
  do {                                             \
    const cudaError_t e_ = (x);                    \
    if (e_ != cudaSuccess) return (int)e_;         \
  } while (0)

// clusters of C blocks (blocks, for C = 1) that the card holds at once
// with `smem` bytes a block
template <typename T, bool LSTM, bool FWD>
int capacity(int C, int smem, int sms, int* cap) {
  auto kern = cell_rollout_kernel<T, LSTM, FWD>;
  if (C == 1) {
    int per = 0;
    RECNET_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, kern, kThreads, smem));
    *cap = per * sms;
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  RECNET_TRY(cudaOccupancyMaxActiveClusters(cap, kern, &cfg));
  return 0;
}

// The launch's shape for B rows of H units: the direction's cluster size
// C, the units a block (spread over the clusters the card holds at once),
// the clusters (NB_req, or as many as the units need), padded product
// rows, k slice, batch rows a pass, shared memory, the card's capacity in
// clusters at that shared memory and its limit.
template <typename T, bool LSTM, bool FWD>
int plan(int B, int H, int NB_req, int* out) {
  const int nG = LSTM ? 4 : 3, K = FWD ? H : nG * H;
  const int C = FWD ? kFwdCluster : kBwdCluster;
  int dev = 0, sms = 0, limit = 0;
  RECNET_TRY(cudaGetDevice(&dev));
  RECNET_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev));
  RECNET_TRY(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  RECNET_TRY(cudaFuncSetAttribute(cell_rollout_kernel<T, LSTM, FWD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  limit));
  const int kc = round_up(ceil_div(K, C), kKC);
  const int Bp = imin(round_up(B, 8), kPassRows);
  int ub = 0, NB = 0, Mpad = 0, smem = 0, cap = 0;
  auto fill = [&](int nb) {
    ub = ceil_div(H, C * nb);
    NB = NB_req > 0 ? NB_req : ceil_div(H, C * ub);
    Mpad = round_up(FWD ? nG * C * ub : C * ub, 16);
    smem = smem_bytes<T>(Mpad, kc, Bp);
  };
  auto held = [&]() {          // the clusters the card holds at once
    cap = 0;
    return smem <= limit ? capacity<T, LSTM, FWD>(C, smem, sms, &cap) : 0;
  };
  fill(NB_req > 0 ? NB_req : (sms / C > 0 ? sms / C : 1));
  int err = held();
  if (err == 0 && NB_req <= 0 && cap > 0 && NB > cap) {
    fill(cap);                  // fewer clusters, more units a block
    err = held();
  }
  if (err != 0) return err;
  out[kPlanC] = C;
  out[kPlanNB] = NB;
  out[kPlanUb] = ub;
  out[kPlanMpad] = Mpad;
  out[kPlanKc] = kc;
  out[kPlanBp] = Bp;
  out[kPlanSmem] = smem;
  out[kPlanCap] = cap;
  out[kPlanLimit] = limit;
  return 0;
}

template <typename T, bool LSTM, bool FWD>
int launch(const int* p, RollArgs<T> a, cudaStream_t s) {
  a.C = p[kPlanC];
  a.ub = p[kPlanUb];
  a.Mpad = p[kPlanMpad];
  a.kc = p[kPlanKc];
  a.Bp = p[kPlanBp];
  if (a.steps < 1 || a.B < 1 || a.H < 1 || a.Mpad > kMaxRows ||
      a.Bp > kPassRows || a.Bp % 8 || a.kc % kKC || a.Mpad % 16 ||
      a.C < 1 ||
      a.ub * a.Bp > kMaxPairs * kThreads)
    return (int)cudaErrorInvalidValue;
  if (p[kPlanNB] > p[kPlanCap]) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.C * p[kPlanNB], 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p[kPlanSmem];
  cfg.stream = s;
  cudaLaunchAttribute attrs[2];
  int n = 0;
  attrs[n].id = cudaLaunchAttributeCooperative;
  attrs[n].val.cooperative = 1;
  ++n;
  if (a.C > 1) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = a.C;
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  RECNET_TRY(cudaLaunchKernelEx(&cfg, cell_rollout_kernel<T, LSTM, FWD>, a));
  return (int)cudaGetLastError();
}

template <typename T, bool LSTM>
int forward(const int* p, int steps, int B, int H, int probe, int vec,
            const void* gi, const void* w, const void* bias, const void* h0,
            const void* c0, void* hs, void* cs, void* acts, void* bar,
            cudaStream_t s) {
  RollArgs<T> a = {};
  a.steps = steps;
  a.B = B;
  a.H = H;
  a.G = (LSTM ? 4 : 3) * H;
  a.probe = probe;
  a.vec = vec;
  a.gi = (const T*)gi;
  a.w = (const T*)w;
  a.bias = (const T*)bias;
  a.h0 = (const T*)h0;
  a.c0 = (const T*)c0;
  a.hs = (T*)hs;
  a.cs = (T*)cs;
  a.acts = (T*)acts;
  a.bar = (unsigned*)bar;
  return launch<T, LSTM, true>(p, a, s);
}

template <typename T, bool LSTM>
int backward(const int* p, int steps, int B, int H, int probe, int vec,
             const void* dhs, const void* acts, const void* w,
             const void* h0, const void* hs, const void* c0, const void* cs,
             void* dgi, void* dgh, void* dh0, void* dc0, void* dh_steps,
             void* dc_steps, void* bar, cudaStream_t s) {
  RollArgs<T> a = {};
  a.steps = steps;
  a.B = B;
  a.H = H;
  a.G = (LSTM ? 4 : 3) * H;
  a.probe = probe;
  a.vec = vec;
  a.w = (const T*)w;
  a.h0 = (const T*)h0;
  a.c0 = (const T*)c0;
  a.hs = (T*)hs;
  a.cs = (T*)cs;
  a.acts = (T*)acts;
  a.dhs = (const T*)dhs;
  a.dgi = (T*)dgi;
  a.dgh = (T*)dgh;
  a.dh0 = (T*)dh0;
  a.dc0 = (T*)dc0;
  a.dh_steps = (T*)dh_steps;
  a.dc_steps = (T*)dc_steps;
  a.bar = (unsigned*)bar;
  return launch<T, LSTM, false>(p, a, s);
}

}  // namespace

extern "C" {

const char* recnet_cell_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16; lstm: 1 = LSTM, 0 = GRU; fwd: 1 =
// the forward kernel, 0 = the backward. NB: the clusters to launch, 0 for
// as many as H needs. out: kPlanFields ints (C, NB,
// units a block, padded rows, k slice, batch rows a pass, shared memory
// bytes, the clusters the card holds at once with them, the card's
// shared-memory limit a block). Returns a CUDA error code.
int recnet_cell_rollout_plan(int dtype, int lstm, int fwd, int B, int H,
                             int NB, int* out) {
  if (B < 1 || H < 1 || NB < 0) return (int)cudaErrorInvalidValue;
#define RECNET_PLAN(T_, L_, F_)                                      \
  if (dtype == (std::is_same<T_, float>::value ? 0 : 1) &&          \
      lstm == (L_ ? 1 : 0) && fwd == (F_ ? 1 : 0))                  \
    return plan<T_, L_, F_>(B, H, NB, out);
  RECNET_PLAN(float, true, true)
  RECNET_PLAN(float, true, false)
  RECNET_PLAN(float, false, true)
  RECNET_PLAN(float, false, false)
  RECNET_PLAN(__nv_bfloat16, true, true)
  RECNET_PLAN(__nv_bfloat16, true, false)
  RECNET_PLAN(__nv_bfloat16, false, true)
  RECNET_PLAN(__nv_bfloat16, false, false)
#undef RECNET_PLAN
  return (int)cudaErrorInvalidValue;
}

// The forward of a T-step rollout on `plan` (recnet_cell_rollout_plan's
// out): gi (T, B, G), w (H, G), bias (G), h0, c0 (LSTM) (B, H) -> hs, cs
// (LSTM) (T, B, H), acts (T, B, 4H). vec: kVecH0 | kVecHs where h0 / hs
// rows may be copied in 16-byte pieces. bar: two zeroed unsigned ints,
// left zeroed on return, not shared with a launch that may run at the
// same time. probe: 0, or the split probes' bits. Launches on `stream`.
int recnet_cell_rollout_fwd(int dtype, int lstm, const int* plan, int T,
                            int B, int H, int probe, int vec, const void* gi,
                            const void* w, const void* bias, const void* h0,
                            const void* c0, void* hs, void* cs, void* acts,
                            void* bar, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return lstm ? forward<float, true>(plan, T, B, H, probe, vec, gi, w,
                                       bias, h0, c0, hs, cs, acts, bar, s)
                : forward<float, false>(plan, T, B, H, probe, vec, gi, w,
                                        bias, h0, c0, hs, cs, acts, bar, s);
  if (dtype == 1)
    return lstm ? forward<__nv_bfloat16, true>(plan, T, B, H, probe, vec, gi,
                                               w, bias, h0, c0, hs, cs, acts,
                                               bar, s)
                : forward<__nv_bfloat16, false>(plan, T, B, H, probe, vec, gi,
                                                w, bias, h0, c0, hs, cs, acts,
                                                bar, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: dhs (T, B, H), acts (T, B, 4H), w (H, G), h0 and hs
// (GRU), c0 and cs (LSTM) -> dgi (T, B, G; LSTM's dgates), dgh (GRU),
// dh0, dc0 (LSTM) (B, H); dh_steps and dc_steps (LSTM) (T, B, H), or null:
// the carries into each step. vec: kVecDg where dgi's (LSTM) or dgh's
// (GRU) rows may be copied in 16-byte pieces, kVecActs for acts.
int recnet_cell_rollout_bwd(int dtype, int lstm, const int* plan, int T,
                            int B, int H, int probe, int vec, const void* dhs,
                            const void* acts, const void* w, const void* h0,
                            const void* hs, const void* c0, const void* cs,
                            void* dgi, void* dgh, void* dh0, void* dc0,
                            void* dh_steps, void* dc_steps, void* bar,
                            void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define RECNET_BWD(T_, L_)                                                 \
  return backward<T_, L_>(plan, T, B, H, probe, vec, dhs, acts, w, h0, hs, \
                          c0, cs, dgi, dgh, dh0, dc0, dh_steps, dc_steps,  \
                          bar, s)
  if (dtype == 0 && lstm) RECNET_BWD(float, true);
  if (dtype == 0) RECNET_BWD(float, false);
  if (dtype == 1 && lstm) RECNET_BWD(__nv_bfloat16, true);
  if (dtype == 1) RECNET_BWD(__nv_bfloat16, false);
#undef RECNET_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
