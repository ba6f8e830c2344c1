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
//   A decoder step (GRU, H = 512) moves 2.5 MB forward, 0.74 us, and 2.9
//   MB backward. At these sizes a launch is mostly latency: an empty
//   kernel at the first design's grid takes 0.9-1.2 us of device time on
//   an H100, and the copy of a step's bytes from and to device memory
//   1.6 (GRU 512) to 3.1 us (LSTM 1536) more, 1.5-2.2 TB/s: a wave of
//   short threads keeps too few loads in flight for the HBM rate
//   (chip_smoke.py [train] (d), the probes below).
//   What the design does: each thread owns a run of kCellRun = 2
//   consecutive units of one row and starts every load of the run (each
//   gate's run, b_hh's, the state's, the cotangents') as one 8-byte (f32)
//   or 4-byte (bf16) load before the first use, then stores each output's
//   run as one store; blocks of kCellThreads = 128, as many as one wave of
//   the card holds at most, over the B x ceil(H / 2) runs. Where a width,
//   a row stride or a pointer does not allow whole-run accesses, a kernel
//   of its own on the same body ("tail", so that a profile names the
//   route) reads and writes the run element by element, the row's last
//   run cut at H. Runs of 16 bytes (4 f32 or 8 bf16 units) took longer on
//   an H100, in bf16 longer than the first design: with a quarter or an
//   eighth of the threads, each thread's chain of exp, tanh and division
//   paced the SMs. At the flagship (B = 100, f32, each step's operands in
//   device memory as in a rollout) the forward takes 3.0 us (GRU 512) and
//   3.9 us (LSTM 1536) of device time, the kernels' earlier version 3.6
//   and 4.8; with one step's operands in L2, 1.8 and 2.5 (2.0 and 3.2).
//   Each unit's arithmetic is one of four per-unit functions, every
//   product and sum in them one rounded operation written out, so that
//   the compiler fuses nothing of its own; the kernels and the first
//   design all call them, so f32 results agree bit for bit by
//   construction (tests/test_torch_cuda.py, chip_smoke.py [train] (d)),
//   and the functions fuse the products that nvcc fused in the kernels'
//   earlier version, to which they are bit-equal too (chip_smoke.py
//   --compare). The first design (one thread a (row, unit), scalar loads
//   at the gates' four (three) column offsets, 256-thread blocks over B
//   H) stays as each kernel's "scalar" probe. The forward's probes
//   "empty" (an empty kernel at the first design's grid) and "copy" (the
//   forward's loads and stores with sums in place of the gates) split a
//   launch's time into its floor, its bytes and its arithmetic.
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
#include <initializer_list>

#include "decode_common.cuh"
#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using recnet::cp_async16;
using recnet::cp_async_commit;
using recnet::cp_async_wait;
using recnet::from_f;
using recnet::round_to;
using recnet::to_f;

constexpr int kThreads = 256;
// the cell kernels: units a thread (one 8-byte f32 or 4-byte bf16 load a
// gate), threads a block
constexpr int kCellRun = 2, kCellThreads = 128;
constexpr int kSplit = 8;     // blocks a batch row in the attention kernels
// the cell forward's probes (recnet_cell_fwd_probe): the first design, an
// empty kernel at its grid, the loads and stores without the gates
constexpr int kCellScalar = 1, kCellEmpty = 2, kCellCopy = 3;
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

// The cells' arithmetic for one unit in f32, every product and sum written
// as one rounded operation (__fmaf_rn, __fmul_rn, __fadd_rn, __fdiv_rn), so
// that the compiler fuses nothing on its own: the kernels and their first
// designs, which all call these, agree bit for bit whatever it chooses. The
// fused products are those nvcc -O3 made of the first design's expressions
// for sm_90a (f32 results bit-equal to them on an H100).

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// 1 - x^2
__device__ __forceinline__ float one_minus_sq(float x) {
  return __fmaf_rn(-x, x, 1.0f);
}

// LSTM: the gates' pre-activations p = gx + b_hh ([i, f, g, o]) and c ->
// a = [i, f, g, o], c' = f c + i g, h' = o tanh(c').
__device__ __forceinline__ void lstm_fwd_unit(const float p[4], float c,
                                              float a[4], float& c_new,
                                              float& h_new) {
  a[0] = sigmoid_rn(p[0]);
  a[1] = sigmoid_rn(p[1]);
  a[2] = tanhf(p[2]);
  a[3] = sigmoid_rn(p[3]);
  c_new = __fmaf_rn(a[0], a[2], __fmul_rn(a[1], c));
  h_new = __fmul_rn(a[3], tanhf(c_new));
}

// GRU: gi's gates x, gh's gates y and b_hh's bb ([r, z, n]), h, with T's
// rounding of h_n = y_n + b_n -> a = [r, z, n, h_n], h' = (1 - z) n + z h.
template <typename T>
__device__ __forceinline__ void gru_fwd_unit(const float x[3],
                                             const float y[3],
                                             const float bb[3], float h,
                                             float a[4], float& h_new) {
  const float hn = round_to<T>(__fadd_rn(y[2], bb[2]));
  const float r = sigmoid_rn(__fadd_rn(__fadd_rn(x[0], y[0]), bb[0]));
  const float z = sigmoid_rn(__fadd_rn(__fadd_rn(x[1], y[1]), bb[1]));
  const float nn = tanhf(__fmaf_rn(r, hn, x[2]));
  h_new = __fmaf_rn(__fsub_rn(1.0f, z), nn, __fmul_rn(z, h));
  a[0] = r;
  a[1] = z;
  a[2] = nn;
  a[3] = hn;
}

// LSTM backward: dh, the carried dc, a = [i, f, g, o], c_prev and c_t ->
// d = the gates' cotangents [di, df, dg, do], e = dc f.
__device__ __forceinline__ void lstm_bwd_unit(float dh, float dc_next,
                                              const float a[4], float c,
                                              float c_t, float d[4],
                                              float& e) {
  const float ig = a[0], f = a[1], g = a[2], o = a[3];
  const float tc = tanhf(c_t);
  const float dc = __fmaf_rn(__fmul_rn(dh, o), one_minus_sq(tc), dc_next);
  d[0] = __fmul_rn(__fmul_rn(__fmul_rn(dc, g), ig), __fsub_rn(1.0f, ig));
  d[1] = __fmul_rn(__fmul_rn(__fmul_rn(dc, c), f), __fsub_rn(1.0f, f));
  d[2] = __fmul_rn(__fmul_rn(dc, ig), one_minus_sq(g));
  d[3] = __fmul_rn(__fmul_rn(__fmul_rn(dh, tc), o), __fsub_rn(1.0f, o));
  e = __fmul_rn(dc, f);
}

// GRU backward: dh, a = [r, z, n, h_n], h_prev -> d = [dr, dz, dn, dn r]
// (gi's cotangents, then gh's n part), e = dh z.
__device__ __forceinline__ void gru_bwd_unit(float dh, const float a[4],
                                             float h, float d[4], float& e) {
  const float r = a[0], z = a[1], nn = a[2], hn = a[3];
  const float dn = __fmul_rn(__fmul_rn(dh, __fsub_rn(1.0f, z)),
                             one_minus_sq(nn));
  d[0] = __fmul_rn(__fmul_rn(__fmul_rn(dn, hn), r), __fsub_rn(1.0f, r));
  d[1] = __fmul_rn(__fmul_rn(__fmul_rn(dh, __fsub_rn(h, nn)), z),
                   __fsub_rn(1.0f, z));
  d[2] = dn;
  d[3] = __fmul_rn(dn, r);
  e = __fmul_rn(dh, z);
}

// The cell forward's first design (the "scalar" probe): one thread a (row,
// unit), scalar loads.
template <typename T, bool LSTM>
__global__ void __launch_bounds__(kThreads)
cell_fwd_scalar_kernel(int B, int H, long ldx, long ldh,
                       const T* __restrict__ gx, const T* __restrict__ gh,
                       const T* __restrict__ bias,
                       const T* __restrict__ h_prev,
                       const T* __restrict__ c_prev, T* __restrict__ h_out,
                       T* __restrict__ c_out, T* __restrict__ acts) {
  const long n = (long)B * H;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long)gridDim.x * blockDim.x) {
    const long b = idx / H;
    const int j = (int)(idx - b * H);
    T* act = acts + b * 4 * H + j;
    float a[4], h;
    if constexpr (LSTM) {
      const T* g = gx + b * ldx + j;
      float p[4], c;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        p[k] = __fadd_rn(to_f(g[k * H]), to_f(bias[k * H + j]));
      lstm_fwd_unit(p, to_f(c_prev[idx]), a, c, h);
      c_out[idx] = from_f<T>(c);
    } else {
      const T* gi = gx + b * ldx + j;
      const T* gr = gh + b * ldh + j;
      float x[3], y[3], bb[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        x[k] = to_f(gi[k * H]);
        y[k] = to_f(gr[k * H]);
        bb[k] = to_f(bias[k * H + j]);
      }
      gru_fwd_unit<T>(x, y, bb, to_f(h_prev[idx]), a, h);
    }
    h_out[idx] = from_f<T>(h);
#pragma unroll
    for (int k = 0; k < 4; ++k) act[k * H] = from_f<T>(a[k]);
  }
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

// an unsigned type of BYTES bytes: one load or store of a run
template <int BYTES> struct Bits;
template <> struct Bits<8> { using type = uint2; };
template <> struct Bits<4> { using type = unsigned int; };

// The n (<= kCellRun) values of a run at p into x, the rest 0: one load of
// the run with VEC (p aligned to it, n = kCellRun), else one by one.
template <typename T, bool VEC>
__device__ __forceinline__ void load_run(const T* __restrict__ p, int n,
                                         float* x) {
  constexpr int kRun = kCellRun;
  if constexpr (VEC) {
    using V = typename Bits<kRun * sizeof(T)>::type;
    const V u = *reinterpret_cast<const V*>(p);
    const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < kRun; ++i) x[i] = to_f(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) x[i] = i < n ? to_f(p[i]) : 0.f;
  }
}

// x's first n values, rounded to T, to p: one store with VEC.
template <typename T, bool VEC>
__device__ __forceinline__ void store_run(T* __restrict__ p, int n,
                                          const float* x) {
  constexpr int kRun = kCellRun;
  if constexpr (VEC) {
    using V = typename Bits<kRun * sizeof(T)>::type;
    V u;
    T* v = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < kRun; ++i) v[i] = from_f<T>(x[i]);
    *reinterpret_cast<V*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      if (i < n) p[i] = from_f<T>(x[i]);
  }
}

// The cell forward: one thread a run of kRun consecutive units of one row
// (item = b * runs + q, units [q kRun, q kRun + n)), every load of the run
// started before the first use. The arithmetic is cell_fwd_scalar_kernel's,
// expression for expression. COPY (the "copy" probe) keeps the loads and
// stores and puts sums in place of the gates: LSTM acts_k = gx_k + b_k, c'
// = h' = c; GRU acts_k = gi_k + gh_k + b_k (k < 3), acts_3 = gh_2 + b_2,
// h' = h; it is launched as its own kernel, cell_fwd_copy_kernel, so that
// a profile tells the two apart by name.
template <typename T, bool LSTM, bool VEC, bool COPY>
__device__ __forceinline__ void cell_fwd_body(
    int B, int H, long ldx, long ldh, const T* __restrict__ gx,
    const T* __restrict__ gh, const T* __restrict__ bias,
    const T* __restrict__ h_prev, const T* __restrict__ c_prev,
    T* __restrict__ h_out, T* __restrict__ c_out, T* __restrict__ acts) {
  constexpr int kRun = kCellRun;
  constexpr int kGates = LSTM ? 4 : 3;
  const int runs = (H + kRun - 1) / kRun;
  const int items = B * runs;
  for (int item = blockIdx.x * blockDim.x + threadIdx.x; item < items;
       item += gridDim.x * blockDim.x) {
    const int b = item / runs;
    const int j = (item - b * runs) * kRun;
    const int n = min(kRun, H - j);
    const long s = (long)b * H + j;            // the run in (B, H)
    float x[kGates][kRun], y[3][kRun], bb[kGates][kRun], st[kRun];
#pragma unroll
    for (int k = 0; k < kGates; ++k) {
      load_run<T, VEC>(gx + b * ldx + k * H + j, n, x[k]);
      if constexpr (!LSTM) load_run<T, VEC>(gh + b * ldh + k * H + j, n, y[k]);
      load_run<T, VEC>(bias + k * H + j, n, bb[k]);
    }
    load_run<T, VEC>(LSTM ? c_prev + s : h_prev + s, n, st);
    float a[4][kRun], h[kRun], c[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if constexpr (COPY) {
#pragma unroll
        for (int k = 0; k < kGates; ++k)
          a[k][i] = LSTM ? x[k][i] + bb[k][i] : x[k][i] + y[k][i] + bb[k][i];
        if constexpr (!LSTM) a[3][i] = y[2][i] + bb[2][i];
        h[i] = c[i] = st[i];
      } else {
        float ua[4];
        if constexpr (LSTM) {
          float u[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) u[k] = __fadd_rn(x[k][i], bb[k][i]);
          lstm_fwd_unit(u, st[i], ua, c[i], h[i]);
        } else {
          const float ux[3] = {x[0][i], x[1][i], x[2][i]};
          const float uy[3] = {y[0][i], y[1][i], y[2][i]};
          const float ub[3] = {bb[0][i], bb[1][i], bb[2][i]};
          gru_fwd_unit<T>(ux, uy, ub, st[i], ua, h[i]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) a[k][i] = ua[k];
      }
    }
    if constexpr (LSTM) store_run<T, VEC>(c_out + s, n, c);
    store_run<T, VEC>(h_out + s, n, h);
    T* act = acts + (long)b * 4 * H + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) store_run<T, VEC>(act + k * H, n, a[k]);
  }
}

// The cell forward on whole runs, and element by element (the "tail"
// route, its own kernel so that a profile tells the two apart by name).
template <typename T, bool LSTM>
__global__ void __launch_bounds__(kCellThreads)
cell_fwd_kernel(int B, int H, long ldx, long ldh, const T* __restrict__ gx,
                const T* __restrict__ gh, const T* __restrict__ bias,
                const T* __restrict__ h_prev, const T* __restrict__ c_prev,
                T* __restrict__ h_out, T* __restrict__ c_out,
                T* __restrict__ acts) {
  cell_fwd_body<T, LSTM, true, false>(B, H, ldx, ldh, gx, gh, bias, h_prev,
                                      c_prev, h_out, c_out, acts);
}

template <typename T, bool LSTM>
__global__ void __launch_bounds__(kCellThreads)
cell_fwd_tail_kernel(int B, int H, long ldx, long ldh,
                     const T* __restrict__ gx, const T* __restrict__ gh,
                     const T* __restrict__ bias,
                     const T* __restrict__ h_prev,
                     const T* __restrict__ c_prev, T* __restrict__ h_out,
                     T* __restrict__ c_out, T* __restrict__ acts) {
  cell_fwd_body<T, LSTM, false, false>(B, H, ldx, ldh, gx, gh, bias, h_prev,
                                       c_prev, h_out, c_out, acts);
}

template <typename T, bool LSTM, bool VEC>
__global__ void __launch_bounds__(kCellThreads)
cell_fwd_copy_kernel(int B, int H, long ldx, long ldh,
                     const T* __restrict__ gx, const T* __restrict__ gh,
                     const T* __restrict__ bias,
                     const T* __restrict__ h_prev,
                     const T* __restrict__ c_prev, T* __restrict__ h_out,
                     T* __restrict__ c_out, T* __restrict__ acts) {
  cell_fwd_body<T, LSTM, VEC, true>(B, H, ldx, ldh, gx, gh, bias, h_prev,
                                    c_prev, h_out, c_out, acts);
}

// The cell backward: one thread a run of kRun consecutive units of one row,
// as cell_fwd_body; every load of the run started before the first use,
// the per-unit functions cell_bwd_scalar_kernel calls. dh_cell may be
// dh_next and dc_prev dc_next (the rollouts' carries, updated in place): a
// thread reads its run of each before it writes it, and no other thread
// touches it.
template <typename T, bool LSTM, bool VEC>
__device__ __forceinline__ void cell_bwd_body(
    int B, int H, long ldi, long ldg, const T* dh_next,
    const T* __restrict__ dh_out, const T* dc_next,
    const T* __restrict__ acts, const T* __restrict__ h_prev,
    const T* __restrict__ c_prev, const T* __restrict__ c_t,
    T* __restrict__ dgi, T* __restrict__ dgh, T* dh_cell, T* dc_prev) {
  constexpr int kRun = kCellRun;
  const int runs = (H + kRun - 1) / kRun;
  const int items = B * runs;
  for (int item = blockIdx.x * blockDim.x + threadIdx.x; item < items;
       item += gridDim.x * blockDim.x) {
    const int b = item / runs;
    const int j = (item - b * runs) * kRun;
    const int n = min(kRun, H - j);
    const long s = (long)b * H + j;            // the run in (B, H)
    float dn[kRun], dout[kRun], a[4][kRun], st[kRun], ct[kRun], dcn[kRun];
    load_run<T, VEC>(dh_next + s, n, dn);
    if (dh_out)
      load_run<T, VEC>(dh_out + s, n, dout);
    else
#pragma unroll
      for (int i = 0; i < kRun; ++i) dout[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      load_run<T, VEC>(acts + (long)b * 4 * H + k * H + j, n, a[k]);
    load_run<T, VEC>(LSTM ? c_prev + s : h_prev + s, n, st);
    if constexpr (LSTM) {
      load_run<T, VEC>(c_t + s, n, ct);
      load_run<T, VEC>(dc_next + s, n, dcn);
    }
    float d[4][kRun], e[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const float dh = __fadd_rn(dn[i], dout[i]);
      const float ua[4] = {a[0][i], a[1][i], a[2][i], a[3][i]};
      float ud[4];
      if constexpr (LSTM)
        lstm_bwd_unit(dh, dcn[i], ua, st[i], ct[i], ud, e[i]);
      else
        gru_bwd_unit(dh, ua, st[i], ud, e[i]);
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k][i] = ud[k];
    }
    T* di = dgi + b * ldi + j;
    if constexpr (LSTM) {
#pragma unroll
      for (int k = 0; k < 4; ++k) store_run<T, VEC>(di + k * H, n, d[k]);
      store_run<T, VEC>(dc_prev + s, n, e);
    } else {
      T* dg = dgh + b * ldg + j;
#pragma unroll
      for (int k = 0; k < 3; ++k) store_run<T, VEC>(di + k * H, n, d[k]);
      store_run<T, VEC>(dg, n, d[0]);
      store_run<T, VEC>(dg + H, n, d[1]);
      store_run<T, VEC>(dg + 2 * H, n, d[3]);
      store_run<T, VEC>(dh_cell + s, n, e);
    }
  }
}

// The cell backward on whole runs, and element by element (the "tail"
// route), as the forward's two kernels.
template <typename T, bool LSTM>
__global__ void __launch_bounds__(kCellThreads)
cell_bwd_kernel(int B, int H, long ldi, long ldg, const T* dh_next,
                const T* __restrict__ dh_out, const T* dc_next,
                const T* __restrict__ acts, const T* __restrict__ h_prev,
                const T* __restrict__ c_prev, const T* __restrict__ c_t,
                T* __restrict__ dgi, T* __restrict__ dgh, T* dh_cell,
                T* dc_prev) {
  cell_bwd_body<T, LSTM, true>(B, H, ldi, ldg, dh_next, dh_out, dc_next,
                               acts, h_prev, c_prev, c_t, dgi, dgh, dh_cell,
                               dc_prev);
}

template <typename T, bool LSTM>
__global__ void __launch_bounds__(kCellThreads)
cell_bwd_tail_kernel(int B, int H, long ldi, long ldg, const T* dh_next,
                     const T* __restrict__ dh_out, const T* dc_next,
                     const T* __restrict__ acts,
                     const T* __restrict__ h_prev,
                     const T* __restrict__ c_prev,
                     const T* __restrict__ c_t, T* __restrict__ dgi,
                     T* __restrict__ dgh, T* dh_cell, T* dc_prev) {
  cell_bwd_body<T, LSTM, false>(B, H, ldi, ldg, dh_next, dh_out, dc_next,
                                acts, h_prev, c_prev, c_t, dgi, dgh,
                                dh_cell, dc_prev);
}

// The cell backward's first design (the "scalar" probe): one thread a
// (row, unit), scalar loads.
template <typename T, bool LSTM>
__global__ void __launch_bounds__(kThreads)
cell_bwd_scalar_kernel(int B, int H, long ldi, long ldg, const T* dh_next,
                       const T* __restrict__ dh_out, const T* dc_next,
                       const T* __restrict__ acts,
                       const T* __restrict__ h_prev,
                       const T* __restrict__ c_prev,
                       const T* __restrict__ c_t, T* __restrict__ dgi,
                       T* __restrict__ dgh, T* dh_cell, T* dc_prev) {
  const long n = (long)B * H;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long)gridDim.x * blockDim.x) {
    const long b = idx / H;
    const int j = (int)(idx - b * H);
    const float dh = __fadd_rn(to_f(dh_next[idx]),
                               dh_out ? to_f(dh_out[idx]) : 0.f);
    const T* act = acts + b * 4 * H + j;
    float a[4], d[4], e;
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = to_f(act[k * H]);
    T* di = dgi + b * ldi + j;
    if constexpr (LSTM) {
      lstm_bwd_unit(dh, to_f(dc_next[idx]), a, to_f(c_prev[idx]),
                    to_f(c_t[idx]), d, e);
#pragma unroll
      for (int k = 0; k < 4; ++k) di[k * H] = from_f<T>(d[k]);
      dc_prev[idx] = from_f<T>(e);
    } else {
      gru_bwd_unit(dh, a, to_f(h_prev[idx]), d, e);
      T* dg = dgh + b * ldg + j;
      di[0] = dg[0] = from_f<T>(d[0]);
      di[H] = dg[H] = from_f<T>(d[1]);
      di[2 * H] = from_f<T>(d[2]);
      dg[2 * H] = from_f<T>(d[3]);
      dh_cell[idx] = from_f<T>(e);
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

int chunk_for(int dtype) { return dtype == 0 ? 4 : 8; }

int size_for(int dtype) { return dtype == 0 ? 4 : 2; }

// whether rows of n items from p can be copied in 16-byte chunks
bool vec_ok(const void* p, int n, int dtype) {
  return n % chunk_for(dtype) == 0 && (uintptr_t)p % 16 == 0;
}

// The cell forward's operands, as recnet_cell_fwd takes them.
struct CellFwdArgs {
  int lstm, B, H;
  long ldx, ldh;
  const void *gx, *gh, *bias, *h_prev, *c_prev;
  void *h_out, *c_out, *acts;
};

// Whether pointer p and row stride ld (elements) allow whole-run loads of
// values of `size` bytes.
bool run_ok(const void* p, long ld, int size) {
  return ld % kCellRun == 0 && (uintptr_t)p % (kCellRun * size) == 0;
}

// Whether the operands the cell forward reads and writes allow whole-run
// loads and stores: H whole runs, every row stride and pointer aligned.
bool cell_vec(int dtype, const CellFwdArgs& a) {
  const int size = size_for(dtype);
  if (a.H % kCellRun) return false;
  const void* state = a.lstm ? a.c_prev : a.h_prev;
  const void* more = a.lstm ? (const void*)a.c_out : a.gh;
  for (const void* p : {a.bias, state, more, (const void*)a.h_out,
                        (const void*)a.acts})
    if (!run_ok(p, 0, size)) return false;
  return run_ok(a.gx, a.ldx, size) && (a.lstm || run_ok(a.gh, a.ldh, size));
}

template <typename T, bool LSTM, bool COPY>
void cell_fwd_launch(const CellFwdArgs& a, bool vec, int grid,
                     cudaStream_t s) {
  const auto kernel =
      COPY ? (vec ? cell_fwd_copy_kernel<T, LSTM, true>
                  : cell_fwd_copy_kernel<T, LSTM, false>)
           : (vec ? cell_fwd_kernel<T, LSTM> : cell_fwd_tail_kernel<T, LSTM>);
  kernel<<<grid, kCellThreads, 0, s>>>(
      a.B, a.H, a.ldx, a.ldh, (const T*)a.gx, (const T*)a.gh,
      (const T*)a.bias, (const T*)a.h_prev, (const T*)a.c_prev,
      (T*)a.h_out, (T*)a.c_out, (T*)a.acts);
}

// The SMs of the card current at the first call, read once (0 when the
// query failed; the next launch then reports its error). Any grid gives
// the cell kernels' results (their loops stride over it), so one count
// serves every card.
int card_sms() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  return sms;
}

// The cell kernels' grid: a block of kCellThreads a kCellThreads runs of B
// rows of H units, at most as many blocks as the card's SMs hold at once
// (one wave).
int cell_grid(int B, int H) {
  const long runs = (long)B * ((H + kCellRun - 1) / kCellRun);
  const long blocks = (runs + kCellThreads - 1) / kCellThreads;
  const long wave = (long)card_sms() * (2048 / kCellThreads);
  return (int)(wave == 0 || blocks < wave ? blocks : wave);
}

// probe 0: the cell forward; kCellScalar, kCellEmpty, kCellCopy: its
// probes.
template <typename T>
int cell_fwd(int probe, int dtype, const CellFwdArgs& a, cudaStream_t s) {
  if (probe == kCellScalar) {
    const int grid = grid_for((long)a.B * a.H);
    if (a.lstm)
      cell_fwd_scalar_kernel<T, true><<<grid, kThreads, 0, s>>>(
          a.B, a.H, a.ldx, 0, (const T*)a.gx, nullptr, (const T*)a.bias,
          nullptr, (const T*)a.c_prev, (T*)a.h_out, (T*)a.c_out,
          (T*)a.acts);
    else
      cell_fwd_scalar_kernel<T, false><<<grid, kThreads, 0, s>>>(
          a.B, a.H, a.ldx, a.ldh, (const T*)a.gx, (const T*)a.gh,
          (const T*)a.bias, (const T*)a.h_prev, nullptr, (T*)a.h_out,
          nullptr, (T*)a.acts);
    return (int)cudaGetLastError();
  }
  if (probe == kCellEmpty) {
    empty_kernel<<<grid_for((long)a.B * a.H), kThreads, 0, s>>>();
    return (int)cudaGetLastError();
  }
  const int grid = cell_grid(a.B, a.H);
  const bool vec = cell_vec(dtype, a);
  if (probe == kCellCopy) {
    if (a.lstm) cell_fwd_launch<T, true, true>(a, vec, grid, s);
    else cell_fwd_launch<T, false, true>(a, vec, grid, s);
  } else {
    if (a.lstm) cell_fwd_launch<T, true, false>(a, vec, grid, s);
    else cell_fwd_launch<T, false, false>(a, vec, grid, s);
  }
  return (int)cudaGetLastError();
}

int cell_fwd_entry(int probe, int dtype, const CellFwdArgs& a,
                   cudaStream_t s) {
  if (a.B < 1 || a.H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return cell_fwd<float>(probe, dtype, a, s);
  if (dtype == 1) return cell_fwd<__nv_bfloat16>(probe, dtype, a, s);
  return (int)cudaErrorInvalidValue;
}

// The cell backward's operands, as recnet_cell_bwd takes them.
struct CellBwdArgs {
  int lstm, B, H;
  long ldi, ldg;
  const void *dh_next, *dh_out, *dc_next, *acts, *h_prev, *c_prev, *c_t;
  void *dgi, *dgh, *dh_cell, *dc_prev;
};

// Whether the operands the cell backward reads and writes allow
// whole-run loads and stores (as cell_vec).
bool cell_bwd_vec(int dtype, const CellBwdArgs& a) {
  const int size = size_for(dtype);
  if (a.H % kCellRun) return false;
  const void* lstm_only[] = {a.dc_next, a.c_prev, a.c_t, a.dc_prev};
  const void* gru_only[] = {a.h_prev, a.dh_cell, a.dh_cell, a.dh_cell};
  for (const void* p : {a.dh_next, a.dh_out, a.acts})
    if (!run_ok(p, 0, size)) return false;
  const void* const* more = a.lstm ? lstm_only : gru_only;
  for (int i = 0; i < 4; ++i)
    if (!run_ok(more[i], 0, size)) return false;
  return run_ok(a.dgi, a.ldi, size) && (a.lstm || run_ok(a.dgh, a.ldg, size));
}

template <typename T, bool LSTM>
void cell_bwd_launch(const CellBwdArgs& a, bool vec, int grid,
                     cudaStream_t s) {
  const auto kernel =
      vec ? cell_bwd_kernel<T, LSTM> : cell_bwd_tail_kernel<T, LSTM>;
  kernel<<<grid, kCellThreads, 0, s>>>(
      a.B, a.H, a.ldi, a.ldg, (const T*)a.dh_next, (const T*)a.dh_out,
      (const T*)a.dc_next, (const T*)a.acts, (const T*)a.h_prev,
      (const T*)a.c_prev, (const T*)a.c_t, (T*)a.dgi, (T*)a.dgh,
      (T*)a.dh_cell, (T*)a.dc_prev);
}

// probe 0: the cell backward; kCellScalar: its first design.
template <typename T>
int cell_bwd(int probe, int dtype, const CellBwdArgs& a, cudaStream_t s) {
  if (probe == kCellScalar) {
    const int grid = grid_for((long)a.B * a.H);
    if (a.lstm)
      cell_bwd_scalar_kernel<T, true><<<grid, kThreads, 0, s>>>(
          a.B, a.H, a.ldi, 0, (const T*)a.dh_next, (const T*)a.dh_out,
          (const T*)a.dc_next, (const T*)a.acts, nullptr,
          (const T*)a.c_prev, (const T*)a.c_t, (T*)a.dgi, nullptr, nullptr,
          (T*)a.dc_prev);
    else
      cell_bwd_scalar_kernel<T, false><<<grid, kThreads, 0, s>>>(
          a.B, a.H, a.ldi, a.ldg, (const T*)a.dh_next, (const T*)a.dh_out,
          nullptr, (const T*)a.acts, (const T*)a.h_prev, nullptr, nullptr,
          (T*)a.dgi, (T*)a.dgh, (T*)a.dh_cell, nullptr);
    return (int)cudaGetLastError();
  }
  const int grid = cell_grid(a.B, a.H);
  const bool vec = cell_bwd_vec(dtype, a);
  if (a.lstm) cell_bwd_launch<T, true>(a, vec, grid, s);
  else cell_bwd_launch<T, false>(a, vec, grid, s);
  return (int)cudaGetLastError();
}

int cell_bwd_entry(int probe, int dtype, const CellBwdArgs& a,
                   cudaStream_t s) {
  if (a.B < 1 || a.H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return cell_bwd<float>(probe, dtype, a, s);
  if (dtype == 1) return cell_bwd<__nv_bfloat16>(probe, dtype, a, s);
  return (int)cudaErrorInvalidValue;
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
  return cell_fwd_entry(0, dtype, {lstm, B, H, (long)ldx, (long)ldh, gx, gh,
                                   bias, h_prev, c_prev, h_out, c_out, acts},
                        (cudaStream_t)stream);
}

// The cell forward's probes (probe: kCellScalar, kCellEmpty or kCellCopy),
// with recnet_cell_fwd's operands; the empty kernel writes nothing.
int recnet_cell_fwd_probe(int probe, int dtype, int lstm, int B, int H,
                          long long ldx, long long ldh, const void* gx,
                          const void* gh, const void* bias,
                          const void* h_prev, const void* c_prev,
                          void* h_out, void* c_out, void* acts,
                          void* stream) {
  if (probe != kCellScalar && probe != kCellEmpty && probe != kCellCopy)
    return (int)cudaErrorInvalidValue;
  return cell_fwd_entry(probe, dtype,
                        {lstm, B, H, (long)ldx, (long)ldh, gx, gh, bias,
                         h_prev, c_prev, h_out, c_out, acts},
                        (cudaStream_t)stream);
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
  return cell_bwd_entry(0, dtype,
                        {lstm, B, H, (long)ldi, (long)ldg, dh_next, dh_out,
                         dc_next, acts, h_prev, c_prev, c_t, dgi, dgh,
                         dh_cell, dc_prev},
                        (cudaStream_t)stream);
}

// The cell backward's probe (probe: kCellScalar), with recnet_cell_bwd's
// operands.
int recnet_cell_bwd_probe(int probe, int dtype, int lstm, int B, int H,
                          long long ldi, long long ldg, const void* dh_next,
                          const void* dh_out, const void* dc_next,
                          const void* acts, const void* h_prev,
                          const void* c_prev, const void* c_t, void* dgi,
                          void* dgh, void* dh_cell, void* dc_prev,
                          void* stream) {
  if (probe != kCellScalar) return (int)cudaErrorInvalidValue;
  return cell_bwd_entry(probe, dtype,
                        {lstm, B, H, (long)ldi, (long)ldg, dh_next, dh_out,
                         dc_next, acts, h_prev, c_prev, c_t, dgi, dgh,
                         dh_cell, dc_prev},
                        (cudaStream_t)stream);
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
