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
// Four kernels. Each takes float32 or bfloat16 operands (the bf16 train
// step runs under autocast), computes in f32 and stores in the operand
// type; the wrappers and their plain versions are in ops/cuda/rollout.py.
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
// * attn_fwd_kernel: _tf_rollout_fwd's attention for one step: wh = h W,
//   scores = w . tanh(wh + uv + b), ctx = sum_f scores_f enc_f / F. ctx
//   sums the scores as stored (rounded to the operand type), the values
//   the backward's d(enc) contraction reads.
// * attn_bwd_kernel: _tf_rollout_bwd's attention for one step: dscores =
//   dctx . enc / F, dwh = w * sum_f dscores_f (1 - ACT_f^2) from the
//   rollout's ACT = tanh(h_prev W + uv + b) (made once for all T before
//   the backward loop, as the JAX backward makes U2, since the out-of-loop
//   contractions for d_uv, db and dw read it too), and dh_prev += dwh W^T
//   in place.
//   What bounds the two: at the flagship (B = 100, F = 28, E = 1536, H =
//   512, A = 128) a step reads enc (17.2 MB f32), which stays in L2 across
//   the steps of a rollout; at the HBM rate enc alone takes 5 us. With one
//   256-thread block a row (100 blocks on 132 SMs) they took 16.8 and 46
//   us of device time on an H100 (f32), with a cluster of 8 blocks a row
//   14.8 and 23.1. What holds them at 2.5x and 3.9x the bound is not
//   measured; every row's cluster reading all of W from L2 (25.6 MB a
//   step) is one candidate.
//   What the design does: a cluster of 8 blocks a row (800 blocks). Each
//   block takes an eighth of the row's reductions (of H for wh and dh, of
//   E for ctx and dscores, of the frames for the scores, of A for dwh) and
//   reads only its eighth of W; the few values a later stage needs whole
//   (wh's and dscores' partial sums, the scores, dwh: at most A floats)
//   pass between the blocks through distributed shared memory, behind a
//   cluster barrier. Within a block: one warp a frame for the scores and
//   dscores (lanes along contiguous A or E), one thread a feature for ctx,
//   one warp a unit of h for dwh W^T (lanes along a contiguous row of W).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

using recnet::from_f;
using recnet::round_to;
using recnet::sigmoid;
using recnet::to_f;

constexpr int kThreads = 256;
constexpr int kSplit = 8;     // blocks a batch row in the attention kernels

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, bool LSTM>
__global__ void __launch_bounds__(kThreads)
cell_fwd_kernel(int B, int H, const T* __restrict__ gx,
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
      const T* g = gx + b * 4 * H + j;
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
      const T* gi = gx + b * 3 * H + j;
      const T* gr = gh + b * 3 * H + j;
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
cell_bwd_kernel(int B, int H, const T* dh_next,
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
      T* d = dgi + b * 4 * H + j;
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
      T* di = dgi + b * 3 * H + j;
      T* dg = dgh + b * 3 * H + j;
      di[0] = dg[0] = from_f<T>(dr);
      di[H] = dg[H] = from_f<T>(dz);
      di[2 * H] = from_f<T>(dn);
      dg[2 * H] = from_f<T>(dn * r);
      dh_cell[idx] = from_f<T>(dh * z);
    }
  }
}

// The row's slice [lo, hi) of n items that block `r` of its cluster takes.
__device__ __forceinline__ void slice_of(int n, int r, int& lo, int& hi) {
  const int per = (n + kSplit - 1) / kSplit;
  lo = min(n, r * per);
  hi = min(n, lo + per);
}

// One cluster of kSplit blocks a batch row. Block r: wh's partial sum over
// its slice of H (into whp); after a cluster barrier every block sums the
// kSplit partials (DSMEM) into wh; the scores of the frames f = r (mod
// kSplit) (into sc_own, and to `scores`); after a barrier every block
// gathers the row's F scores; ctx over its slice of E.
// shared memory: h's slice (ceil(H / kSplit)), the k-sub-slices' partial
// wh (ks A), whp (A), wh (A), sc_own (F), sc (F)
template <typename T>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
attn_fwd_kernel(int F, int A, int H, int E, int ks,
                const T* __restrict__ h, const T* __restrict__ W,
                const T* __restrict__ uv, const T* __restrict__ bias,
                const T* __restrict__ w, const T* __restrict__ enc,
                T* __restrict__ scores, T* __restrict__ ctx) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const long b = blockIdx.x / kSplit;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  float* h_s = smem;
  float* part = h_s + (H + kSplit - 1) / kSplit;
  float* whp = part + ks * A;
  float* wh = whp + A;
  float* sc_own = wh + A;
  float* sc = sc_own + F;
  int k0, k1;
  slice_of(H, r, k0, k1);
  const int nk = k1 - k0;
  for (int k = tid; k < nk; k += blockDim.x) h_s[k] = to_f(h[b * H + k0 + k]);
  __syncthreads();
  // the slice's partial wh: thread (a, s) sums the s-th sub-slice for a
  const int sub = (nk + ks - 1) / ks;
  for (int o = tid; o < ks * A; o += blockDim.x) {
    const int a = o % A, s = o / A;
    const int j1 = min(nk, (s + 1) * sub);
    float acc = 0.f;
#pragma unroll 8
    for (int j = s * sub; j < j1; ++j)
      acc = fmaf(h_s[j], to_f(W[(long)(k0 + j) * A + a]), acc);
    part[o] = acc;
  }
  __syncthreads();
  for (int a = tid; a < A; a += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < ks; ++s) acc += part[s * A + a];
    whp[a] = acc;
  }
  cluster.sync();
  for (int a = tid; a < A; a += blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < kSplit; ++q) acc += cluster.map_shared_rank(whp, q)[a];
    wh[a] = acc;
  }
  __syncthreads();
  // this block's frames: one warp a frame, lanes along A
  for (int f = r + warp * kSplit; f < F; f += warps * kSplit) {
    const T* u = uv + (b * F + f) * A;
    float acc = 0.f;
    for (int a = lane; a < A; a += 32)
      acc = fmaf(to_f(w[a]), tanhf(wh[a] + to_f(u[a]) + to_f(bias[a])), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      sc_own[f] = round_to<T>(acc);
      scores[b * F + f] = from_f<T>(acc);
    }
  }
  cluster.sync();
  for (int f = tid; f < F; f += blockDim.x)
    sc[f] = cluster.map_shared_rank(sc_own, f % kSplit)[f];
  __syncthreads();
  // ctx over this block's slice of E: one thread a feature, frames in order
  int e0, e1;
  slice_of(E, r, e0, e1);
  const T* en = enc + b * F * E;
  for (int e = e0 + tid; e < e1; e += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int f = 0; f < F; ++f)
      acc = fmaf(sc[f], to_f(en[(long)f * E + e]), acc);
    ctx[b * E + e] = from_f<T>(acc / (float)F);
  }
  cluster.sync();   // sc_own stays until every block has read it
}

// One cluster of kSplit blocks a batch row. Block r: dscores' partial sums
// over its slice of E (into dp); after a barrier every block sums the
// kSplit partials into dscores; dwh over its slice of A (into dwh_own, and
// to `dwh`); after a barrier every block gathers the row's dwh; dh += dwh
// W^T over its slice of H.
// shared memory: dctx's slice (ceil(E / kSplit)), dp (F), dsc (F), the
// frame groups' partial dwh (max(kThreads, ceil(A / kSplit))), dwh_own
// (A), dwh (A)
template <typename T>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
attn_bwd_kernel(int F, int A, int H, int E, const T* __restrict__ dctx,
                const T* __restrict__ enc, const T* __restrict__ act,
                const T* __restrict__ w, const T* __restrict__ W,
                T* __restrict__ dh, T* __restrict__ dscores,
                T* __restrict__ dwh) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const long b = blockIdx.x / kSplit;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int per_a = (A + kSplit - 1) / kSplit;
  float* dctx_s = smem;
  float* dp = dctx_s + (E + kSplit - 1) / kSplit;
  float* dsc = dp + F;
  float* part = dsc + F;
  float* dwh_own = part + max(kThreads, per_a);
  float* dwh_s = dwh_own + A;
  int e0, e1;
  slice_of(E, r, e0, e1);
  const int ne = e1 - e0;
  for (int e = tid; e < ne; e += blockDim.x)
    dctx_s[e] = to_f(dctx[b * E + e0 + e]);
  __syncthreads();
  // dscores' partial sums over the slice: one warp a frame, lanes along E
  for (int f = warp; f < F; f += warps) {
    const T* en = enc + (b * F + f) * E + e0;
    float acc = 0.f;
#pragma unroll 4
    for (int e = lane; e < ne; e += 32) acc = fmaf(dctx_s[e], to_f(en[e]), acc);
    acc = warp_sum(acc);
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
  __syncthreads();
  // dwh = w * sum_f dscores_f (1 - ACT_f^2) over this block's columns:
  // thread (a, g) sums the frames f = g (mod groups), then one thread a
  // column sums the groups in order
  int a0, a1;
  slice_of(A, r, a0, a1);
  const int na = a1 - a0;
  if (na > 0) {
    const int groups = max(1, min(F, (int)blockDim.x / na));
    for (int o = tid; o < groups * na; o += blockDim.x) {
      const int a = a0 + o % na, g = o / na;
      float acc = 0.f;
      for (int f = g; f < F; f += groups) {
        const float x = to_f(act[(b * F + f) * A + a]);
        acc = fmaf(dsc[f], 1.0f - x * x, acc);
      }
      part[o] = acc;
    }
    __syncthreads();
    for (int j = tid; j < na; j += blockDim.x) {
      float acc = 0.f;
      for (int g = 0; g < groups; ++g) acc += part[g * na + j];
      acc *= to_f(w[a0 + j]);
      dwh_own[a0 + j] = round_to<T>(acc);
      dwh[b * A + a0 + j] = from_f<T>(acc);
    }
  }
  cluster.sync();
  for (int a = tid; a < A; a += blockDim.x)
    dwh_s[a] = cluster.map_shared_rank(dwh_own, a / per_a)[a];
  __syncthreads();
  // dh += dwh W^T over this block's slice of H: one warp a unit, lanes
  // along the unit's row of W
  int k0, k1;
  slice_of(H, r, k0, k1);
  for (int k = k0 + warp; k < k1; k += warps) {
    const T* wr = W + (long)k * A;
    float acc = 0.f;
    for (int a = lane; a < A; a += 32) acc = fmaf(dwh_s[a], to_f(wr[a]), acc);
    acc = warp_sum(acc);
    if (lane == 0) dh[b * H + k] = from_f<T>(to_f(dh[b * H + k]) + acc);
  }
  cluster.sync();   // dp and dwh_own stay until every block has read them
}

int grid_for(long n) {
  const long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 65535 ? blocks : 65535);
}

template <typename T>
int cell_fwd(int lstm, int B, int H, const void* gx, const void* gh,
             const void* bias, const void* h_prev, const void* c_prev,
             void* h_out, void* c_out, void* acts, cudaStream_t s) {
  const int grid = grid_for((long)B * H);
  if (lstm)
    cell_fwd_kernel<T, true><<<grid, kThreads, 0, s>>>(
        B, H, (const T*)gx, nullptr, (const T*)bias, nullptr,
        (const T*)c_prev, (T*)h_out, (T*)c_out, (T*)acts);
  else
    cell_fwd_kernel<T, false><<<grid, kThreads, 0, s>>>(
        B, H, (const T*)gx, (const T*)gh, (const T*)bias, (const T*)h_prev,
        nullptr, (T*)h_out, nullptr, (T*)acts);
  return (int)cudaGetLastError();
}

template <typename T>
int cell_bwd(int lstm, int B, int H, const void* dh_next, const void* dh_out,
             const void* dc_next, const void* acts, const void* h_prev,
             const void* c_prev, const void* c_t, void* dgi, void* dgh,
             void* dh_cell, void* dc_prev, cudaStream_t s) {
  const int grid = grid_for((long)B * H);
  if (lstm)
    cell_bwd_kernel<T, true><<<grid, kThreads, 0, s>>>(
        B, H, (const T*)dh_next, (const T*)dh_out, (const T*)dc_next,
        (const T*)acts, nullptr, (const T*)c_prev, (const T*)c_t, (T*)dgi,
        nullptr, nullptr, (T*)dc_prev);
  else
    cell_bwd_kernel<T, false><<<grid, kThreads, 0, s>>>(
        B, H, (const T*)dh_next, (const T*)dh_out, nullptr, (const T*)acts,
        (const T*)h_prev, nullptr, nullptr, (T*)dgi, (T*)dgh, (T*)dh_cell,
        nullptr);
  return (int)cudaGetLastError();
}

// the k-sub-slices of wh: as many as fill the block's threads over A columns
int wh_slices(int A) { return A >= kThreads ? 1 : kThreads / A; }

}  // namespace

extern "C" {

const char* recnet_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared memory (bytes) each attention kernel needs for these widths; the
// wrapper refuses widths above the default 48 KB.
int recnet_attn_fwd_smem(int F, int A, int H) {
  const int per_h = (H + kSplit - 1) / kSplit;
  return (int)sizeof(float) * (per_h + wh_slices(A) * A + 2 * A + 2 * F);
}

int recnet_attn_bwd_smem(int F, int A, int E) {
  const int per_e = (E + kSplit - 1) / kSplit;
  const int per_a = (A + kSplit - 1) / kSplit;
  return (int)sizeof(float) *
         (per_e + 2 * F + (per_a > kThreads ? per_a : kThreads) + 2 * A);
}

// dtype: 0 = float32, 1 = bfloat16. bias = b_hh. lstm: 1 = LSTM (gx = gi
// + h W_hh (B, 4H), c_prev; gh and h_prev unused), 0 = GRU (gx = gi
// (B, 3H), gh = h W_hh (B, 3H), h_prev; c_prev and c_out unused). acts
// (B, 4H). Launches on `stream`; returns cudaGetLastError().
int recnet_cell_fwd(int dtype, int lstm, int B, int H, const void* gx,
                    const void* gh, const void* bias, const void* h_prev,
                    const void* c_prev, void* h_out, void* c_out, void* acts,
                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return cell_fwd<float>(lstm, B, H, gx, gh, bias, h_prev, c_prev, h_out,
                           c_out, acts, s);
  if (dtype == 1)
    return cell_fwd<__nv_bfloat16>(lstm, B, H, gx, gh, bias, h_prev, c_prev,
                                   h_out, c_out, acts, s);
  return (int)cudaErrorInvalidValue;
}

// dh_out may be null (no output cotangent). LSTM: dc_next, c_prev, c_t in;
// dgi (B, 4H) and dc_prev out (dgh, dh_cell, h_prev unused). GRU: h_prev
// in; dgi, dgh (B, 3H) and dh_cell out (dc_next, c_prev, c_t, dc_prev
// unused). dh_cell may be dh_next and dc_prev dc_next (the rollouts' carries,
// updated in place: each thread reads its element before it writes it).
int recnet_cell_bwd(int dtype, int lstm, int B, int H, const void* dh_next,
                    const void* dh_out, const void* dc_next,
                    const void* acts, const void* h_prev, const void* c_prev,
                    const void* c_t, void* dgi, void* dgh, void* dh_cell,
                    void* dc_prev, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return cell_bwd<float>(lstm, B, H, dh_next, dh_out, dc_next, acts, h_prev,
                           c_prev, c_t, dgi, dgh, dh_cell, dc_prev, s);
  if (dtype == 1)
    return cell_bwd<__nv_bfloat16>(lstm, B, H, dh_next, dh_out, dc_next,
                                   acts, h_prev, c_prev, c_t, dgi, dgh,
                                   dh_cell, dc_prev, s);
  return (int)cudaErrorInvalidValue;
}

// h (B, H), W (H, A), uv (B, F, A), bias (A), w (A), enc (B, F, E) ->
// scores (B, F), ctx (B, E).
int recnet_attn_fwd(int dtype, int B, int F, int A, int H, int E,
                    const void* h, const void* W, const void* uv,
                    const void* bias, const void* w, const void* enc,
                    void* scores, void* ctx, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || F < 1 || A < 1 || H < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  const int ks = wh_slices(A);
  const size_t smem = recnet_attn_fwd_smem(F, A, H);
  if (dtype == 0)
    attn_fwd_kernel<float><<<B * kSplit, kThreads, smem, s>>>(
        F, A, H, E, ks, (const float*)h, (const float*)W, (const float*)uv,
        (const float*)bias, (const float*)w, (const float*)enc,
        (float*)scores, (float*)ctx);
  else if (dtype == 1)
    attn_fwd_kernel<__nv_bfloat16><<<B * kSplit, kThreads, smem, s>>>(
        F, A, H, E, ks, (const __nv_bfloat16*)h, (const __nv_bfloat16*)W,
        (const __nv_bfloat16*)uv, (const __nv_bfloat16*)bias,
        (const __nv_bfloat16*)w, (const __nv_bfloat16*)enc,
        (__nv_bfloat16*)scores, (__nv_bfloat16*)ctx);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dctx (B, E), enc (B, F, E), act (B, F, A), w (A), W (H, A); dh (B, H)
// updated in place; -> dscores (B, F), dwh (B, A).
int recnet_attn_bwd(int dtype, int B, int F, int A, int H, int E,
                    const void* dctx, const void* enc, const void* act,
                    const void* w, const void* W, void* dh, void* dscores,
                    void* dwh, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || F < 1 || A < 1 || H < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = recnet_attn_bwd_smem(F, A, E);
  if (dtype == 0)
    attn_bwd_kernel<float><<<B * kSplit, kThreads, smem, s>>>(
        F, A, H, E, (const float*)dctx, (const float*)enc, (const float*)act,
        (const float*)w, (const float*)W, (float*)dh, (float*)dscores,
        (float*)dwh);
  else if (dtype == 1)
    attn_bwd_kernel<__nv_bfloat16><<<B * kSplit, kThreads, smem, s>>>(
        F, A, H, E, (const __nv_bfloat16*)dctx, (const __nv_bfloat16*)enc,
        (const __nv_bfloat16*)act, (const __nv_bfloat16*)w,
        (const __nv_bfloat16*)W, (__nv_bfloat16*)dh,
        (__nv_bfloat16*)dscores, (__nv_bfloat16*)dwh);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
