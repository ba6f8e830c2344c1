// Per-step kernels of the training rollouts' custom backward, for NVIDIA
// Hopper (sm_90a).
//
// The JAX package trains its one-layer recurrences through three
// jax.custom_vjp rollouts: lstm_rollout_pre and gru_rollout_pre
// (recnet_tpu/ops/rnn.py:207-282, on rollout_cell_fwd :153 and
// rollout_cell_bwd :181) and the decoder's _tf_attn_rollout
// (recnet_tpu/models/decoder.py:241-340). No Pallas kernel is on that path:
// XLA fuses each step's elementwise work into a few kernels. Eager PyTorch
// would launch every elementwise op of a step on its own, about 30 us of
// host time each, so each elementwise stage of a step is one kernel here
// and the products stay with cuBLAS (torch.addmm / mm in
// ops/cuda/rollout.py's callers), as the JAX package leaves them to XLA.
//
// Four kernels. Each takes float32 or bfloat16 operands, computes in f32
// and stores in the operand type; the wrappers and their plain versions are
// in ops/cuda/rollout.py. The operands that a caller lays beside another
// product's columns (the gate products, wh, dwh) are read or written with
// a row stride (ld, in elements); every other operand is contiguous.
//
// * cell_fwd_kernel: rollout_cell_fwd's elementwise part. LSTM: gates =
//   gx + b_hh, where gx = gi + h W_hh; i, f, g, o; c' and h'. GRU: r, z, n
//   from gi and gh + b_hh, where gh = h W_hh, kept apart from gi (r scales
//   gh's n part, b_hh's n part included); h' = (1 - z) n + z h. The bias
//   is added here, so that each product is one cuBLAS launch (addmm with a
//   matrix or a vector to add may be a copy and a GEMM). Writes h', c'
//   (LSTM) and the activations the backward reads, [i, f, g, o] or
//   [r, z, n, h_n], straight into the rollout's (T, B, .) buffers.
// * cell_bwd_kernel: rollout_cell_bwd's elementwise part, from the carried
//   cotangent plus the step's output cotangent: dgi, dgh (GRU: dgh's n
//   part is dgi's times r), GRU's dh z and LSTM's dc f.
//   What bounds the two: device memory. A reconstructor step (LSTM, B =
//   100, H = 1536, f32) reads and writes about 6.8 MB forward and 8.6 MB
//   backward, 2-3 us at 3.35 TB/s; the arithmetic is a few flops a byte.
//   What the design does: one thread a (row, unit), the unit's gates read
//   at their four (three) column offsets, so a warp reads 128 contiguous
//   bytes of each gate; a grid-stride loop over B H.
// * attn_fwd_kernel: _tf_rollout_fwd's attention for one step, from wh =
//   h W: scores = w . tanh(wh + uv + b), ctx = sum_f scores_f enc_f / F.
//   ctx sums the scores as stored (rounded to the operand type), the values
//   the backward's d(enc) contraction reads.
// * attn_bwd_kernel: _tf_rollout_bwd's attention for one step: dscores =
//   dctx . enc / F and dwh = w * sum_f dscores_f (1 - ACT_f^2) from the
//   rollout's ACT = tanh(wh + uv + b) (made once for all T before the
//   backward loop, as the JAX backward makes U2, since the out-of-loop
//   contractions for d_uv, db and dw read it too).
//   The attention's two products with W, wh = h W and dh += dwh W^T, are
//   cuBLAS's, folded into products each step runs anyway on the same
//   operands: the caller lays out [w_hh | W] as one (H, G + A) weight, so
//   h [w_hh | W] gives gh and wh, and [dgh | dwh] [w_hh | W]^T gives dh.
//   The JAX package leaves both to XLA as well.
//   What bounds the two: at the flagship (B = 100, F = 28, E = 1536, A =
//   128) each reads enc (17.2 MB f32), which stays in L2 across the steps
//   of a rollout; at the HBM rate that alone takes 5.1 us.
//   What the split showed (chip_smoke.py [train] (d), f32 on an H100): in
//   the earlier design, with h W and dwh W^T inside the kernels, the
//   forward took 16.3 us, of which wh 4.3 (W's reads 2.0) and ctx 4.2;
//   the backward 24.1 us, of which dscores 12.5 and dh += dwh W^T 9.6
//   (W's reads 2.7). So W's bytes were not the main cost: each phase
//   waited on the one before it behind a cluster barrier, and the enc
//   reads, a few floats a thread with a frame a warp, ran at about 1.4
//   TB/s. This design takes 10.0-10.4 and 10.8-11.4 us (bound 5.8): of
//   that the scores 3.4-3.9 and ctx 3.1-3.3, dscores 3.2-3.4 and dwh 1.8-1.9;
//   the rest is the launch, the cluster barrier and dependent loads.
//   What the design does: a cluster of 8 blocks a row (800 blocks). Each
//   block first puts its slice of enc (F x E/8, 21.5 KB f32), and in the
//   backward its slice of ACT's columns, in flight to shared memory with
//   16-byte cp.async copies, so that the whole slice is read at once while
//   the rest of the kernel runs; then its share of the frames' scores
//   (forward, lanes along A) or its slice's partial dscores (backward, from
//   shared memory); one cluster barrier, after which every block reads the
//   row's F scores or partials through distributed shared memory in a fixed
//   order and arrives on a second barrier that it waits on only at its
//   exit; ctx over its slice of E (forward) or dwh over its slice of A
//   (backward) from shared memory. The sums keep a fixed order and use no
//   atomics, so a rerun repeats its numbers.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "decode_common.cuh"
#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using recnet::cp_async16;
using recnet::cp_async_commit;
using recnet::cp_async_wait;
using recnet::from_f;
using recnet::round_to;
using recnet::sigmoid;
using recnet::to_f;

constexpr int kThreads = 256;
constexpr int kSplit = 8;     // blocks a batch row in the attention kernels
// the attention kernels' split probes (template bits; 0 is the kernel the
// rollouts launch): the forward without its scores (written as zeros, so
// ctx sums zeros) or without ctx (no enc copy; ctx written as zeros); the
// backward without dscores (no enc copy; dscores, and so dwh, zeros) or
// without dwh (no ACT copy; dwh written as zeros)
constexpr int kFwdNoScores = 1, kFwdNoCtx = 2, kBwdNoDsc = 1, kBwdNoDwh = 2;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the two halves of a cluster barrier: arrive (this block's reads of the
// others' shared memory are done) and wait (every block has arrived)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// items of the operand type in a 16-byte copy
template <typename T>
__host__ __device__ constexpr int chunk_of() { return 16 / (int)sizeof(T); }

// Width of the slices that a cluster's blocks take of n items: whole
// 16-byte chunks of `chunk` items, so that every slice starts aligned.
__host__ __device__ __forceinline__ int slice_width(int n, int chunk) {
  return ((n + chunk - 1) / chunk + kSplit - 1) / kSplit * chunk;
}

__host__ __device__ __forceinline__ int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// The row's slice [lo, hi) of n items that block `r` of its cluster takes.
__device__ __forceinline__ void slice_of(int n, int r, int chunk, int& lo,
                                         int& hi) {
  const int per = slice_width(n, chunk);
  lo = min(n, r * per);
  hi = min(n, lo + per);
}

// Block-wide: columns [lo, hi) of `rows` rows of the row-major matrix at
// src (row stride n) into dst (row pitch `pitch`, 16-byte aligned rows).
// With `vec` (n whole chunks, src 16-byte aligned) by 16-byte cp.async
// copies, in flight until the group committed here is waited on; else by
// plain loads, done on return. Commits one group either way.
template <typename T>
__device__ __forceinline__ void copy_slice(T* dst, int pitch, const T* src,
                                           long n, int rows, int lo, int hi,
                                           bool vec) {
  constexpr int kChunk = chunk_of<T>();
  const int w = hi - lo;
  if (vec) {
    const int per_row = w / kChunk;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row, c = (i - r * per_row) * kChunk;
      cp_async16(dst + r * pitch + c, src + r * n + lo + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
      const int r = i / w, c = i - r * w;
      dst[r * pitch + c] = src[r * n + lo + c];
    }
  }
  cp_async_commit();
}

template <typename T, bool LSTM>
__global__ void __launch_bounds__(kThreads)
cell_fwd_kernel(int B, int H, long ldx, long ldh, const T* __restrict__ gx,
                const T* __restrict__ gh, const T* __restrict__ bias,
                const T* __restrict__ h_prev, const T* __restrict__ c_prev,
                T* __restrict__ h_out, T* __restrict__ c_out,
                T* __restrict__ acts) {
  const long n = (long)B * H;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long)gridDim.x * blockDim.x) {
    const long b = idx / H;
    const int j = (int)(idx - b * H);
    T* act = acts + b * 4 * H + j;
    if constexpr (LSTM) {
      const T* g = gx + b * ldx + j;
      const float i = sigmoid(to_f(g[0]) + to_f(bias[j]));
      const float f = sigmoid(to_f(g[H]) + to_f(bias[H + j]));
      const float gg = tanhf(to_f(g[2 * H]) + to_f(bias[2 * H + j]));
      const float o = sigmoid(to_f(g[3 * H]) + to_f(bias[3 * H + j]));
      const float c = f * to_f(c_prev[idx]) + i * gg;
      c_out[idx] = from_f<T>(c);
      h_out[idx] = from_f<T>(o * tanhf(c));
      act[0] = from_f<T>(i);
      act[H] = from_f<T>(f);
      act[2 * H] = from_f<T>(gg);
      act[3 * H] = from_f<T>(o);
    } else {
      const T* gi = gx + b * ldx + j;
      const T* gr = gh + b * ldh + j;
      const float hn = round_to<T>(to_f(gr[2 * H]) + to_f(bias[2 * H + j]));
      const float r = sigmoid(to_f(gi[0]) + to_f(gr[0]) + to_f(bias[j]));
      const float z = sigmoid(to_f(gi[H]) + to_f(gr[H]) + to_f(bias[H + j]));
      const float nn = tanhf(to_f(gi[2 * H]) + r * hn);
      h_out[idx] = from_f<T>((1.0f - z) * nn + z * to_f(h_prev[idx]));
      act[0] = from_f<T>(r);
      act[H] = from_f<T>(z);
      act[2 * H] = from_f<T>(nn);
      act[3 * H] = from_f<T>(hn);
    }
  }
}

template <typename T, bool LSTM>
__global__ void __launch_bounds__(kThreads)
cell_bwd_kernel(int B, int H, long ldi, long ldg, const T* dh_next,
                const T* __restrict__ dh_out, const T* dc_next,
                const T* __restrict__ acts, const T* __restrict__ h_prev,
                const T* __restrict__ c_prev, const T* __restrict__ c_t,
                T* __restrict__ dgi, T* __restrict__ dgh, T* dh_cell,
                T* dc_prev) {
  const long n = (long)B * H;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long)gridDim.x * blockDim.x) {
    const long b = idx / H;
    const int j = (int)(idx - b * H);
    const float dh = to_f(dh_next[idx]) + (dh_out ? to_f(dh_out[idx]) : 0.f);
    const T* act = acts + b * 4 * H + j;
    if constexpr (LSTM) {
      const float i = to_f(act[0]), f = to_f(act[H]);
      const float g = to_f(act[2 * H]), o = to_f(act[3 * H]);
      const float tc = tanhf(to_f(c_t[idx]));
      const float dc = to_f(dc_next[idx]) + dh * o * (1.0f - tc * tc);
      T* d = dgi + b * ldi + j;
      d[0] = from_f<T>(dc * g * i * (1.0f - i));
      d[H] = from_f<T>(dc * to_f(c_prev[idx]) * f * (1.0f - f));
      d[2 * H] = from_f<T>(dc * i * (1.0f - g * g));
      d[3 * H] = from_f<T>(dh * tc * o * (1.0f - o));
      dc_prev[idx] = from_f<T>(dc * f);
    } else {
      const float r = to_f(act[0]), z = to_f(act[H]);
      const float nn = to_f(act[2 * H]), hn = to_f(act[3 * H]);
      const float dn = dh * (1.0f - z) * (1.0f - nn * nn);
      const float dr = dn * hn * r * (1.0f - r);
      const float dz = dh * (to_f(h_prev[idx]) - nn) * z * (1.0f - z);
      T* di = dgi + b * ldi + j;
      T* dg = dgh + b * ldg + j;
      di[0] = dg[0] = from_f<T>(dr);
      di[H] = dg[H] = from_f<T>(dz);
      di[2 * H] = from_f<T>(dn);
      dg[2 * H] = from_f<T>(dn * r);
      dh_cell[idx] = from_f<T>(dh * z);
    }
  }
}

// One cluster of kSplit blocks a batch row. Block r: its slice of enc's
// features (F x E/kSplit) copied to shared memory at entry; the scores of
// the frames f = r (mod kSplit), one warp a frame (into sc_own, and to
// `scores`); after a cluster barrier every block gathers the row's F
// scores; ctx over its slice of E from shared memory.
// shared memory: enc's slice (F x slice_width(E), operand type), sc_own
// (F), sc (F)
template <typename T, int P>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
attn_fwd_kernel(int F, int A, int E, long ldw, bool vec,
                const T* __restrict__ wh, const T* __restrict__ uv,
                const T* __restrict__ bias, const T* __restrict__ w,
                const T* __restrict__ enc, T* __restrict__ scores,
                T* __restrict__ ctx) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const long b = blockIdx.x / kSplit;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int pitch = slice_width(E, chunk_of<T>());
  T* enc_s = reinterpret_cast<T*>(smem);
  float* sc_own = reinterpret_cast<float*>(
      smem + align16(F * pitch * (int)sizeof(T)));
  float* sc = sc_own + F;
  int e0, e1;
  slice_of(E, r, chunk_of<T>(), e0, e1);
  copy_slice(enc_s, pitch, enc + b * F * E, E, (P & kFwdNoCtx) ? 0 : F, e0,
             e1, vec);
  // this block's frames: one warp a frame, lanes along A
  const T* q = wh + b * ldw;
  for (int f = r + warp * kSplit; f < F; f += warps * kSplit) {
    float acc = 0.f;
    if constexpr (!(P & kFwdNoScores)) {
      const T* u = uv + (b * F + f) * A;
      for (int a = lane; a < A; a += 32)
        acc = fmaf(to_f(w[a]),
                   tanhf(to_f(q[a]) + to_f(u[a]) + to_f(bias[a])), acc);
      acc = warp_sum(acc);
    }
    if (lane == 0) {
      sc_own[f] = round_to<T>(acc);
      scores[b * F + f] = from_f<T>(acc);
    }
  }
  cluster.sync();
  for (int f = tid; f < F; f += blockDim.x)
    sc[f] = cluster.map_shared_rank(sc_own, f % kSplit)[f];
  cluster_arrive();
  cp_async_wait<0>();
  __syncthreads();
  // ctx over this block's slice of E: one thread a feature, frames in order
  for (int e = tid; e < e1 - e0; e += blockDim.x) {
    float acc = 0.f;
    if constexpr (!(P & kFwdNoCtx)) {
#pragma unroll 4
      for (int f = 0; f < F; ++f)
        acc = fmaf(sc[f], to_f(enc_s[f * pitch + e]), acc);
    }
    ctx[b * E + e0 + e] = from_f<T>(acc / (float)F);
  }
  cluster_wait();   // sc_own stays until every block has read it
}

// One cluster of kSplit blocks a batch row. Block r: its slices of enc's
// features and of ACT's columns (F x A/kSplit) copied to shared memory at
// entry; dscores' partial sums over its slice of E, one warp a frame (into
// dp); after a cluster barrier every block sums the kSplit partials in
// order into dscores; dwh over its slice of A from shared memory.
// shared memory: enc's slice (F x slice_width(E)) and ACT's (F x
// slice_width(A)), both in the operand type; dctx's slice (slice_width(E)),
// dp (F), dsc (F), the frame groups' partial dwh (max(kThreads,
// slice_width(A)))
template <typename T, int P>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
attn_bwd_kernel(int F, int A, int E, long ldd, bool enc_vec, bool act_vec,
                const T* __restrict__ dctx, const T* __restrict__ enc,
                const T* __restrict__ act, const T* __restrict__ w,
                T* __restrict__ dscores, T* __restrict__ dwh) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const long b = blockIdx.x / kSplit;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  constexpr int kChunk = chunk_of<T>();
  const int pe = slice_width(E, kChunk), pa = slice_width(A, kChunk);
  const int enc_bytes = align16(F * pe * (int)sizeof(T));
  T* enc_s = reinterpret_cast<T*>(smem);
  T* act_s = reinterpret_cast<T*>(smem + enc_bytes);
  float* dctx_s = reinterpret_cast<float*>(
      smem + enc_bytes + align16(F * pa * (int)sizeof(T)));
  float* dp = dctx_s + pe;
  float* dsc = dp + F;
  float* part = dsc + F;
  int e0, e1, a0, a1;
  slice_of(E, r, kChunk, e0, e1);
  slice_of(A, r, kChunk, a0, a1);
  copy_slice(enc_s, pe, enc + b * F * E, E, (P & kBwdNoDsc) ? 0 : F, e0, e1,
             enc_vec);
  copy_slice(act_s, pa, act + b * F * A, A, (P & kBwdNoDwh) ? 0 : F, a0, a1,
             act_vec);
  const int ne = e1 - e0;
  for (int e = tid; e < ne; e += blockDim.x)
    dctx_s[e] = to_f(dctx[b * E + e0 + e]);
  cp_async_wait<1>();   // enc's slice; ACT's may still be in flight
  __syncthreads();
  // dscores' partial sums over the slice: one warp a frame, lanes along E
  for (int f = warp; f < F; f += warps) {
    float acc = 0.f;
    if constexpr (!(P & kBwdNoDsc)) {
      const T* en = enc_s + f * pe;
      for (int e = lane; e < ne; e += 32)
        acc = fmaf(dctx_s[e], to_f(en[e]), acc);
      acc = warp_sum(acc);
    }
    if (lane == 0) dp[f] = acc;
  }
  cluster.sync();
  for (int f = tid; f < F; f += blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < kSplit; ++q) acc += cluster.map_shared_rank(dp, q)[f];
    acc /= (float)F;
    dsc[f] = round_to<T>(acc);
    if (r == 0) dscores[b * F + f] = from_f<T>(acc);
  }
  cluster_arrive();
  cp_async_wait<0>();
  __syncthreads();
  // dwh = w * sum_f dscores_f (1 - ACT_f^2) over this block's columns:
  // thread (a, g) sums the frames f = g (mod groups), then one thread a
  // column sums the groups in order
  const int na = a1 - a0;
  if (na > 0) {
    const int groups = max(1, min(F, (int)blockDim.x / na));
    for (int o = tid; o < groups * na; o += blockDim.x) {
      const int j = o % na, g = o / na;
      float acc = 0.f;
      if constexpr (!(P & kBwdNoDwh)) {
        for (int f = g; f < F; f += groups) {
          const float x = to_f(act_s[f * pa + j]);
          acc = fmaf(dsc[f], 1.0f - x * x, acc);
        }
      }
      part[o] = acc;
    }
    __syncthreads();
    for (int j = tid; j < na; j += blockDim.x) {
      float acc = 0.f;
      for (int g = 0; g < groups; ++g) acc += part[g * na + j];
      dwh[b * ldd + a0 + j] = from_f<T>(acc * to_f(w[a0 + j]));
    }
  }
  cluster_wait();   // dp stays until every block has read it
}

int grid_for(long n) {
  const long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 65535 ? blocks : 65535);
}

template <typename T>
int cell_fwd(int lstm, int B, int H, long ldx, long ldh, const void* gx,
             const void* gh, const void* bias, const void* h_prev,
             const void* c_prev, void* h_out, void* c_out, void* acts,
             cudaStream_t s) {
  const int grid = grid_for((long)B * H);
  if (lstm)
    cell_fwd_kernel<T, true><<<grid, kThreads, 0, s>>>(
        B, H, ldx, 0, (const T*)gx, nullptr, (const T*)bias, nullptr,
        (const T*)c_prev, (T*)h_out, (T*)c_out, (T*)acts);
  else
    cell_fwd_kernel<T, false><<<grid, kThreads, 0, s>>>(
        B, H, ldx, ldh, (const T*)gx, (const T*)gh, (const T*)bias,
        (const T*)h_prev, nullptr, (T*)h_out, nullptr, (T*)acts);
  return (int)cudaGetLastError();
}

template <typename T>
int cell_bwd(int lstm, int B, int H, long ldi, long ldg, const void* dh_next,
             const void* dh_out, const void* dc_next, const void* acts,
             const void* h_prev, const void* c_prev, const void* c_t,
             void* dgi, void* dgh, void* dh_cell, void* dc_prev,
             cudaStream_t s) {
  const int grid = grid_for((long)B * H);
  if (lstm)
    cell_bwd_kernel<T, true><<<grid, kThreads, 0, s>>>(
        B, H, ldi, 0, (const T*)dh_next, (const T*)dh_out,
        (const T*)dc_next, (const T*)acts, nullptr, (const T*)c_prev,
        (const T*)c_t, (T*)dgi, nullptr, nullptr, (T*)dc_prev);
  else
    cell_bwd_kernel<T, false><<<grid, kThreads, 0, s>>>(
        B, H, ldi, ldg, (const T*)dh_next, (const T*)dh_out, nullptr,
        (const T*)acts, (const T*)h_prev, nullptr, nullptr, (T*)dgi,
        (T*)dgh, (T*)dh_cell, nullptr);
  return (int)cudaGetLastError();
}

int chunk_for(int dtype) { return dtype == 0 ? 4 : 8; }

int size_for(int dtype) { return dtype == 0 ? 4 : 2; }

// whether rows of n items from p can be copied in 16-byte chunks
bool vec_ok(const void* p, int n, int dtype) {
  return n % chunk_for(dtype) == 0 && (uintptr_t)p % 16 == 0;
}

int attn_fwd_smem(int dtype, int F, int E) {
  const int pitch = slice_width(E, chunk_for(dtype));
  return align16(F * pitch * size_for(dtype)) + 2 * F * (int)sizeof(float);
}

int attn_bwd_smem(int dtype, int F, int A, int E) {
  const int pe = slice_width(E, chunk_for(dtype));
  const int pa = slice_width(A, chunk_for(dtype));
  return align16(F * pe * size_for(dtype)) + align16(F * pa * size_for(dtype))
         + (int)sizeof(float) * (pe + 2 * F + (pa > kThreads ? pa : kThreads));
}

template <int P>
int attn_fwd(int dtype, int B, int F, int A, int E, long ldw, const void* wh,
             const void* uv, const void* bias, const void* w, const void* enc,
             void* scores, void* ctx, cudaStream_t s) {
  if (B < 1 || F < 1 || A < 1 || E < 1 || ldw < A)
    return (int)cudaErrorInvalidValue;
  const size_t smem = attn_fwd_smem(dtype, F, E);
  const bool vec = vec_ok(enc, E, dtype);
  if (dtype == 0)
    attn_fwd_kernel<float, P><<<B * kSplit, kThreads, smem, s>>>(
        F, A, E, ldw, vec, (const float*)wh, (const float*)uv,
        (const float*)bias, (const float*)w, (const float*)enc,
        (float*)scores, (float*)ctx);
  else if (dtype == 1)
    attn_fwd_kernel<__nv_bfloat16, P><<<B * kSplit, kThreads, smem, s>>>(
        F, A, E, ldw, vec, (const __nv_bfloat16*)wh,
        (const __nv_bfloat16*)uv, (const __nv_bfloat16*)bias,
        (const __nv_bfloat16*)w, (const __nv_bfloat16*)enc,
        (__nv_bfloat16*)scores, (__nv_bfloat16*)ctx);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <int P>
int attn_bwd(int dtype, int B, int F, int A, int E, long ldd,
             const void* dctx, const void* enc, const void* act,
             const void* w, void* dscores, void* dwh, cudaStream_t s) {
  if (B < 1 || F < 1 || A < 1 || E < 1 || ldd < A)
    return (int)cudaErrorInvalidValue;
  const size_t smem = attn_bwd_smem(dtype, F, A, E);
  const bool enc_vec = vec_ok(enc, E, dtype), act_vec = vec_ok(act, A, dtype);
  if (dtype == 0)
    attn_bwd_kernel<float, P><<<B * kSplit, kThreads, smem, s>>>(
        F, A, E, ldd, enc_vec, act_vec, (const float*)dctx,
        (const float*)enc, (const float*)act, (const float*)w,
        (float*)dscores, (float*)dwh);
  else if (dtype == 1)
    attn_bwd_kernel<__nv_bfloat16, P><<<B * kSplit, kThreads, smem, s>>>(
        F, A, E, ldd, enc_vec, act_vec, (const __nv_bfloat16*)dctx,
        (const __nv_bfloat16*)enc, (const __nv_bfloat16*)act,
        (const __nv_bfloat16*)w, (__nv_bfloat16*)dscores,
        (__nv_bfloat16*)dwh);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* recnet_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared memory (bytes) each attention kernel needs for these widths and
// dtype (0 = float32, 1 = bfloat16); the wrapper refuses widths above the
// default 48 KB.
int recnet_attn_fwd_smem(int dtype, int F, int E) {
  return attn_fwd_smem(dtype, F, E);
}

int recnet_attn_bwd_smem(int dtype, int F, int A, int E) {
  return attn_bwd_smem(dtype, F, A, E);
}

// dtype: 0 = float32, 1 = bfloat16. bias = b_hh. lstm: 1 = LSTM (gx = gi
// + h W_hh (B, 4H), row stride ldx, c_prev; gh and h_prev unused), 0 = GRU
// (gx = gi (B, 3H), row stride ldx, gh = h W_hh (B, 3H), row stride ldh,
// h_prev; c_prev and c_out unused). acts (B, 4H). Launches on `stream`;
// returns cudaGetLastError().
int recnet_cell_fwd(int dtype, int lstm, int B, int H, long long ldx,
                    long long ldh, const void* gx, const void* gh,
                    const void* bias, const void* h_prev, const void* c_prev,
                    void* h_out, void* c_out, void* acts, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return cell_fwd<float>(lstm, B, H, ldx, ldh, gx, gh, bias, h_prev,
                           c_prev, h_out, c_out, acts, s);
  if (dtype == 1)
    return cell_fwd<__nv_bfloat16>(lstm, B, H, ldx, ldh, gx, gh, bias,
                                   h_prev, c_prev, h_out, c_out, acts, s);
  return (int)cudaErrorInvalidValue;
}

// dh_out may be null (no output cotangent). LSTM: dc_next, c_prev, c_t in;
// dgi (B, 4H), row stride ldi, and dc_prev out (dgh, dh_cell, h_prev
// unused). GRU: h_prev in; dgi and dgh (B, 3H), row strides ldi and ldg,
// and dh_cell out (dc_next, c_prev, c_t, dc_prev unused). dh_cell may be
// dh_next and dc_prev dc_next (the rollouts' carries, updated in place:
// each thread reads its element before it writes it).
int recnet_cell_bwd(int dtype, int lstm, int B, int H, long long ldi,
                    long long ldg, const void* dh_next, const void* dh_out,
                    const void* dc_next, const void* acts, const void* h_prev,
                    const void* c_prev, const void* c_t, void* dgi, void* dgh,
                    void* dh_cell, void* dc_prev, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return cell_bwd<float>(lstm, B, H, ldi, ldg, dh_next, dh_out, dc_next,
                           acts, h_prev, c_prev, c_t, dgi, dgh, dh_cell,
                           dc_prev, s);
  if (dtype == 1)
    return cell_bwd<__nv_bfloat16>(lstm, B, H, ldi, ldg, dh_next, dh_out,
                                   dc_next, acts, h_prev, c_prev, c_t, dgi,
                                   dgh, dh_cell, dc_prev, s);
  return (int)cudaErrorInvalidValue;
}

// wh (B, A), row stride ldw; uv (B, F, A), bias (A), w (A), enc (B, F, E)
// -> scores (B, F), ctx (B, E).
int recnet_attn_fwd(int dtype, int B, int F, int A, int E, long long ldw,
                    const void* wh, const void* uv, const void* bias,
                    const void* w, const void* enc, void* scores, void* ctx,
                    void* stream) {
  return attn_fwd<0>(dtype, B, F, A, E, ldw, wh, uv, bias, w, enc, scores,
                     ctx, (cudaStream_t)stream);
}

// dctx (B, E), enc (B, F, E), act (B, F, A), w (A) -> dscores (B, F), dwh
// (B, A), row stride ldd.
int recnet_attn_bwd(int dtype, int B, int F, int A, int E, long long ldd,
                    const void* dctx, const void* enc, const void* act,
                    const void* w, void* dscores, void* dwh, void* stream) {
  return attn_bwd<0>(dtype, B, F, A, E, ldd, dctx, enc, act, w, dscores, dwh,
                     (cudaStream_t)stream);
}

// The split probes (probe: kFwdNoScores or kFwdNoCtx; kBwdNoDsc or
// kBwdNoDwh), with the operands of recnet_attn_fwd / recnet_attn_bwd.
int recnet_attn_fwd_probe(int probe, int dtype, int B, int F, int A, int E,
                          long long ldw, const void* wh, const void* uv,
                          const void* bias, const void* w, const void* enc,
                          void* scores, void* ctx, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (probe == kFwdNoScores)
    return attn_fwd<kFwdNoScores>(dtype, B, F, A, E, ldw, wh, uv, bias, w,
                                  enc, scores, ctx, s);
  if (probe == kFwdNoCtx)
    return attn_fwd<kFwdNoCtx>(dtype, B, F, A, E, ldw, wh, uv, bias, w, enc,
                               scores, ctx, s);
  return (int)cudaErrorInvalidValue;
}

int recnet_attn_bwd_probe(int probe, int dtype, int B, int F, int A, int E,
                          long long ldd, const void* dctx, const void* enc,
                          const void* act, const void* w, void* dscores,
                          void* dwh, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (probe == kBwdNoDsc)
    return attn_bwd<kBwdNoDsc>(dtype, B, F, A, E, ldd, dctx, enc, act, w,
                               dscores, dwh, s);
  if (probe == kBwdNoDwh)
    return attn_bwd<kBwdNoDwh>(dtype, B, F, A, E, ldd, dctx, enc, act, w,
                               dscores, dwh, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
