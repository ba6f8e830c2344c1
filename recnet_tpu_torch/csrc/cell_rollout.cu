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
// Sums keep a fixed order and no value is added atomically, so a rerun
// repeats its numbers bit for bit.
//
// What bounds them on the H100 (flagship reconstructor: LSTM, B = 100,
// H = 1536, G = 6144, T = 31): the operations, 2 B H G T = 58.5 GFLOP a
// direction; bf16 0.059 ms at 989 TFLOP/s (bytes 0.03-0.04 ms); f32 as
// three TF32 products (TF32 stays off for the libraries) 0.355 ms at 494.7
// TFLOP/s (on the CUDA cores, 0.873 ms at 67 TFLOP/s). What a step needs of
// other blocks is what paces it: every block needs every other block's h_t
// (forward) or dgates_t (backward) before the next product.
//
// Both bodies: persistent and co-resident, one block an SM (bf16: two
// warpgroups; f32: three), launched cooperatively (the runtime refuses a
// grid the card cannot hold at once) in clusters of C blocks that split k: a
// cluster owns U = C ub units, block rank r takes the k slice r of the
// product's activations (h: C = 2 forward; dgates: C = 8 backward) against
// all of the cluster's product rows (forward: the U units' gate columns of
// W_hh, 4U or 3U; backward: the U units' rows), and runs the cells of its
// own ub units. The C partial sums of a unit cross the cluster through
// distributed shared memory and are added rank by rank. Only h_t (forward)
// or dgates_t (backward) crosses clusters, through global memory (L2).
// Shared by both:
// * The product P (batch rows x NW) = X W_blk^T with the batch as M
//   (warpgroup w takes rows 64 w .. 64 w + 63 of a pass) and the block's
//   product rows as N (NW = 32, 64, 96 or 104, the wgmma widths built: 96
//   forward, 104 backward at the flagship), f32 accumulators in registers;
//   one warpgroup walks the whole k slice, so no k halves are summed.
// * The activations staged by 16-byte cp.async (cg: L2 only) into a ring,
//   chunks ahead of the MMAs that read them.
// * Readiness words in place of a grid barrier: after a block has written
//   its units' h_t (dgates_t) it publishes its step count (st.release.gpu)
//   in its own word of the launch's scratch. At the start of a pass the
//   block looks once at the word of every block that writes a column of
//   its k slice (ld.acquire.gpu, one lane a writer: one L2 round trip) and
//   stages at once every chunk whose writers have all published; a chunk
//   found short is staged after further looks at all of them (trapping
//   after about 10 s). Each step writes fresh rows (hs[t], dgates[t]), so
//   no write-after-read crosses steps. The words hold counts from `base`,
//   which the wrapper advances a launch: they are never reset within a
//   launch, nor zeroed between launches.
// * The exchange: each block's partials (its rows < B of the pass x NW,
//   f32, its k slice's sum) go over the activations' ring, whose stages are
//   free after the product; a cluster barrier (arrive.release,
//   wait.acquire) makes them visible; each block sums its own units'
//   partials from the C ranks in order. The barrier's next phase is
//   arrived at once a block has read its peers' partials and waited for
//   only before the next pass stages into the ring.
// * The cells: each thread's (unit, row) pairs are fixed for the whole
//   launch; their carries (c: cs[t - 1]; dc: dc0; GRU's h: hs[t - 1]; its
//   dh z: dh0) are the same thread's stores of a step before; b_hh of the
//   block's units is held in shared memory (every acquire of a step
//   invalidates L1, so a read of it through L1 would go to L2 in each cell).
//
// The bf16 body (cell_rollout_wgmma_kernel):
// * The recurrent weight held on chip: the block's slice (NW product rows
//   x the k slice: 96 x 768 forward, 104 x 768 backward at the flagship,
//   147 and 160 KB) is laid out once at entry as K-major tiles of 64 k in
//   the 128-byte swizzle that wgmma's matrix descriptors name (wgmma.cuh);
//   m64nNWk16 reads both operands from shared memory. The ring: S stages
//   of 64 k (6 forward, 5 backward at the flagship), S - 2 chunks ahead;
//   one wgmma group kept in flight, each tile fenced to the async proxy
//   before the wgmma that reads it.
// * The cells' inputs (gi_t, the backward's dhs, acts, cs / hs, and the
//   carries) are loaded as stored bf16 at the start of the pass and
//   converted where the cells use them, so that they land while the product
//   runs.
// What the split showed (chip_smoke.py [train] (d), the flagship's
// reconstructor in bf16 on an H100 80GB HBM3 at 700 W, device time a step
// of 31): forward 21.4 us, of which the product 13.0 (staging, waits and
// MMAs; the MMAs 3.4) and the exchange 4.0; without the product 8.5 (the
// cells, the pulls of the partials and the hand-offs); backward 20.3 us,
// product 11.2 (MMAs 3.6), exchange 5.3. cuDNN's LSTM takes 12.7 and 14.5
// us a step at these shapes: the kernels lose to it by the per-step costs
// a persistent grid pays on this card (the stagings' L2 reads and the
// hand-offs), no longer by their MMAs.
//
// The f32 body (cell_rollout_tf32_kernel): products accurate to f32 on the
// tensor cores, as three TF32 terms a k8 step: a_lo b_hi + a_hi b_lo + a_hi
// b_hi (hi = tf32(x), lo = tf32(x - hi), rounded as hopper_mma.cuh's
// split_tf32), wgmma m64nNWk8 from a zero accumulator, added to the f32
// sums in IEEE f32 on the CUDA cores, so that the tensor cores' own
// accumulation never sums more than one k8 step.
// * The split: the activations are A, read from the staged rows (padded
//   to 36 floats: no bank conflict) into the m64nNk8 A fragment and split
//   in registers. The weight is B, which wgmma reads from shared memory
//   only, K-major, as a hi and a lo tile a 32-k chunk (NW rows of 128
//   bytes in the swizzle).
// * The weight split once a launch, streamed every step: the f32 slice
//   (295 KB a block at the flagship; its hi and lo tiles 590 KB) does not
//   fit on chip beside the rest. At entry each block writes its slice's
//   tiles, chunk by chunk in the slots' byte layout, to its part of a
//   device buffer (wsplit: 75.5 MB forward, 76.7 MB backward at the
//   flagship; generic writes fenced to the async proxy); every step then
//   takes each chunk's two tiles by one 26.6 KB bulk copy (TMA). W_hh is
//   read once a launch and split once; a split in shared memory a chunk
//   cost the producer more than the stream of the doubled bytes.
// * Warp-specialised: warpgroup 2 is the producer, warpgroups 0 and 1 the
//   consumers (the batch's 64-row M tiles). The producer fills a ring of 5
//   slots (a chunk's tiles and its rows): it waits for a slot's consumers
//   (a named barrier), waits for the chunk's writers (the readiness
//   words), stages the rows by cp.async (each thread's arrival on the
//   slot's mbarrier follows its copies' landing) and issues the tiles' bulk
//   copy, whose bytes the same mbarrier counts; it waits for no data. The
//   consumers wait on the slot's mbarrier, run the chunk's 4 k8 steps (a
//   wait a step: the registers hold one k8 accumulator beside the sums)
//   and free the slot.
// * The cells' inputs are read once the product is done, beside the
//   cluster barrier; the consumers store the partials over the rows.
//
// Split probes (probe bits; 0 is the kernel the rollouts launch):
// kNoProduct drops the staging (with its waits for readiness; f32: the
// weight's split and stream too) and the products (P = 0); kNoMma keeps
// the staging (f32: and the weight's stream) and drops the MMAs (P = 0);
// kNoExchange drops the waits for other blocks (the readiness words) and
// the cluster's sum (each block adds only its own partial) and reads the
// product's activations from an input of the same width (h0 forward,
// acts[t] backward), so that its outputs are defined. The probes are timed by chip_smoke.py and count no launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "decode_common.cuh"
#include "hopper_mma.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using recnet::cp_async16;
using recnet::cp_async_commit;
using recnet::cp_async_wait;
using recnet::from_f;
using recnet::round_to;
using recnet::sigmoid;
using recnet::to_f;

constexpr int kKC = 64;          // k of a staged chunk (bf16)
constexpr int kNoProduct = 1, kNoExchange = 2, kNoMma = 4;
constexpr int kMaxBlocks = 1024; // readiness words in the scratch
// which product sources may be copied in 16-byte pieces
constexpr int kVecH0 = 1, kVecHs = 2, kVecDg = 4, kVecActs = 8, kVecW = 16;

// both bodies
constexpr int kWThreads = 256;   // two warpgroups
constexpr int kWPassRows = 104;  // batch rows a pass: a stage's rows
constexpr int kWMaxPairs = 6;    // (unit, row) pairs a thread in a pass
constexpr int kWAlign = 1024;    // the swizzled tiles' alignment
constexpr int kWReady = 128;     // the readiness scan's bytes

// the bf16 body
constexpr int kWMinStages = 3, kWMaxStages = 8;

// the f32 body: two consumer warpgroups (the MMAs) and a producer
// warpgroup (the copies)
constexpr int kFConsumers = 256, kFProducer = 128;
constexpr int kFThreads = kFConsumers + kFProducer;
constexpr int kFMaxPairs = 4;        // (unit, row) pairs a thread in a pass
constexpr int kFKC = 32;             // k of a chunk: a 128-byte f32 row
constexpr int kFPitch = kFKC + 4;    // floats a staged row (144 bytes)
constexpr int kFSlots = 5;           // chunks in the slots' ring
// named barriers: the producer's own, a slot is free (the consumers
// arrive, the producer waits), the consumers' own
constexpr int kBarProducer = 1, kBarEmpty = 2, kBarConsumers = 2 + kFSlots;

template <typename T>
struct RollArgs {
  int steps, B, H, G;          // T, batch, hidden, gate width (nG H)
  int C, ub, Mpad, kc, Bp;     // cluster size, units a block, product
                               // rows (NW), k slice, batch rows a pass
  int stages;                  // the activations' ring's stages
  int probe, vec;
  unsigned base;               // the readiness count before the launch
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
  unsigned* flags;             // a readiness word a block
  float* wsplit;               // f32: the weight slices' tile images
};

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ constexpr int round_up(int a, int b) {
  return ceil_div(a, b) * b;
}

// 4 bytes global -> shared, or 4 zero bytes when !ok (src is not read;
// through L1: after an acquire of this step, or of operands no block
// writes)
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

// cycles a block waits for other blocks before it gives up (about 10 s: a
// launch whose blocks are not all resident faults instead of hanging)
constexpr long long kBarrierTimeout = 20000000000LL;

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

// The forward LSTM cell of unit j at (T B) row `row` from its gates before
// the bias (round(gi + P)), b_hh's four values and c_{t-1}: writes cs, hs
// and acts [i, f, g, o].
template <typename T>
__device__ __forceinline__ void fwd_lstm_store(const RollArgs<T>& a, long row,
                                               int j, const float pre[4],
                                               const float bias[4],
                                               float cp) {
  const int H = a.H;
  const float ig = sigmoid(pre[0] + bias[0]);
  const float f = sigmoid(pre[1] + bias[1]);
  const float gg = tanhf(pre[2] + bias[2]);
  const float o = sigmoid(pre[3] + bias[3]);
  const float c = f * cp + ig * gg;
  a.cs[row * H + j] = from_f<T>(c);
  a.hs[row * H + j] = from_f<T>(o * tanhf(c));
  T* act = a.acts + row * 4 * H + j;
  act[0] = from_f<T>(ig);
  act[H] = from_f<T>(f);
  act[2 * H] = from_f<T>(gg);
  act[3 * H] = from_f<T>(o);
}

// The forward GRU cell of unit j at row `row` from P (f32 sums), gi_t,
// b_hh and h_{t-1}: writes hs and acts [r, z, n, h_n].
template <typename T>
__device__ __forceinline__ void fwd_gru_store(const RollArgs<T>& a, long row,
                                              int j, const float P[3],
                                              const float gi[3],
                                              const float bias[3],
                                              float hp) {
  const int H = a.H;
  const float gh0 = round_to<T>(P[0]), gh1 = round_to<T>(P[1]);
  const float hn = round_to<T>(round_to<T>(P[2]) + bias[2]);
  const float r = sigmoid(gi[0] + gh0 + bias[0]);
  const float z = sigmoid(gi[1] + gh1 + bias[1]);
  const float nn = tanhf(gi[2] + r * hn);
  a.hs[row * H + j] = from_f<T>((1.0f - z) * nn + z * hp);
  T* act = a.acts + row * 4 * H + j;
  act[0] = from_f<T>(r);
  act[H] = from_f<T>(z);
  act[2 * H] = from_f<T>(nn);
  act[3 * H] = from_f<T>(hn);
}

// ---------------------------------------------------------------------------
// the bf16 body
// ---------------------------------------------------------------------------

// the block that runs unit j's cell and writes its h_t or dgates_t
__device__ __forceinline__ int owner(int j, int U, int ub, int C) {
  return (j / U) * C + (j % U) / ub;
}

// a bf16's bits: read-only operands (through L1), and values this launch
// wrote (from L2)
__device__ __forceinline__ unsigned short ld_bits(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ unsigned short ldcg_bits(const bf16* p) {
  return __ldcg(reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ float bits_f(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}

// Over threads t of nthreads (whole warps): one look at the readiness word
// of every block that writes a column of the k slice [kbeg, kbeg + kc) below kend (unit k forward, k
// mod H backward): ready[c / 32] = whether every writer of the columns c
// .. c + 31 of the slice has published `need`. In each warp only the lane
// whose column starts a new writer reads that writer's word (acquire), so
// a look costs one round trip to L2; the caller's __syncthreads orders
// the block's reads of the ready columns after it.
__device__ __forceinline__ void scan_ready(unsigned char* ready,
                                           const unsigned* flags,
                                           unsigned need, int kbeg, int kc,
                                           int kend, int H, int U, int ub,
                                           int C, int t = threadIdx.x,
                                           int nthreads = kWThreads) {
  const int lane = t & 31;
  for (int c0 = 0; c0 < kc; c0 += nthreads) {
    const int c = c0 + t, k = kbeg + c;
    const int p = c < kc && k < kend ? owner(k % H, U, ub, C) : -1;
    const int before = __shfl_up_sync(0xffffffffu, p, 1);
    const bool polled = p >= 0 && !(lane > 0 && p == before);
    const bool ok = !polled || ld_acquire(flags + p) >= need;
    const bool all = __all_sync(0xffffffffu, ok);
    if (lane == 0 && c < kc) ready[c >> 5] = all;
  }
}

// Block-wide: rows b_lo .. b_lo + bp of X's columns [k0, k0 + 64) into the
// swizzled tile `dst` (zero past kend): whole 16-byte pieces by cp.async
// (cg: L2 only, since other SMs wrote them) where vec allows, the rest by
// L2 loads and a 16-byte shared store.
__device__ __forceinline__ void stage_tile(unsigned char* dst, const bf16* X,
                                           int ldx, bool vec, int b_lo,
                                           int bp, int k0, int kend) {
  for (int i = threadIdx.x; i < bp * 8; i += kWThreads) {
    const int r = i >> 3, j = i & 7, k = k0 + 8 * j;
    unsigned char* d = dst + recnet::sw128(r, j);
    const bf16* s = X + (long)(b_lo + r) * ldx + k;
    if (vec && k + 8 <= kend) {
      cp_async16(d, s);
    } else {
      unsigned w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned lo =
            k + 2 * e < kend ? __ldcg(reinterpret_cast<const unsigned short*>(
                                   s + 2 * e))
                             : 0u;
        const unsigned hi =
            k + 2 * e + 1 < kend
                ? __ldcg(reinterpret_cast<const unsigned short*>(s + 2 * e +
                                                                 1))
                : 0u;
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// byte offset of element (n, k) of the held slice: kc / 64 tiles of NW
// swizzled rows, one after another
__device__ __forceinline__ int w_offset(int n, int k, int NW) {
  return (k >> 6) * NW * 128 + recnet::sw128(n, (k & 63) >> 3) +
         (k & 7) * 2;
}

// Block-wide: the block's slice of W_hh into Ws (product rows n < NW, the
// k slice kbeg .. kbeg + kc), zero outside it. Forward rows are W_hh's
// columns (gate g of the cluster's unit cu at n = g U + cu): 16-byte
// loads of 8 units of a gate, 8 a thread in flight, each scattered down 8
// rows. Backward rows are W_hh's rows (the cluster's unit n), contiguous
// along k: 16-byte cp.async pieces, committed as one group (waited on with
// the first chunk). Pieces that `vec` or the edges rule out go element by
// element.
template <bool FWD>
__device__ void load_w_tiles(unsigned char* Ws, int NW, const bf16* w,
                             bool vec, int kc, int nG, int cu0, int U,
                             int kbeg, int kend, int H, int G) {
  const int rows = FWD ? nG * U : U;
  // element (n, k) of the slice, zero outside it
  auto elem = [&](int n, int k) -> unsigned short {
    const int kk = kbeg + k;
    if (n >= rows || kk >= kend) return 0;
    const int unit = cu0 + (FWD ? n % U : n);
    if (unit >= H) return 0;
    const long idx = FWD ? (long)kk * G + (long)(n / U) * H + unit
                         : (long)unit * G + kk;
    return __ldg(reinterpret_cast<const unsigned short*>(w) + idx);
  };
  if (FWD) {
    const int per_gate = vec && U % 8 == 0 ? U / 8 : 0;
    const int nvec = kc * nG * per_gate;
    for (int i0 = threadIdx.x; i0 < nvec; i0 += 8 * kWThreads) {
      uint4 v[8];
      bool whole[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int i = i0 + s * kWThreads;
        const int p = i % per_gate, g = (i / per_gate) % nG;
        const int k = i / (per_gate * nG), unit = cu0 + 8 * p;
        whole[s] = i < nvec && kbeg + k < kend && unit + 8 <= H;
        if (whole[s])
          v[s] = __ldg(reinterpret_cast<const uint4*>(
              w + (long)(kbeg + k) * G + (long)g * H + unit));
      }
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int i = i0 + s * kWThreads;
        if (i >= nvec) continue;
        const int p = i % per_gate, g = (i / per_gate) % nG;
        const int k = i / (per_gate * nG), n0 = g * U + 8 * p;
        const unsigned short* e =
            reinterpret_cast<const unsigned short*>(&v[s]);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          *reinterpret_cast<unsigned short*>(Ws + w_offset(n0 + q, k, NW)) =
              whole[s] ? e[q] : elem(n0 + q, k);
      }
    }
    // the rest: every element where no vector went, the padded rows
    const int n_lo = per_gate ? rows : 0;
    for (int i = threadIdx.x; i < (NW - n_lo) * kc; i += kWThreads) {
      const int n = n_lo + i % (NW - n_lo), k = i / (NW - n_lo);
      *reinterpret_cast<unsigned short*>(Ws + w_offset(n, k, NW)) =
          elem(n, k);
    }
  } else {
    for (int i = threadIdx.x; i < NW * (kc / 8); i += kWThreads) {
      const int n = i / (kc / 8), k = (i % (kc / 8)) * 8;
      unsigned char* d = Ws + w_offset(n, k, NW);
      const int unit = cu0 + n;
      if (vec && n < U && unit < H && kbeg + k + 8 <= kend) {
        cp_async16(d, w + (long)unit * G + kbeg + k);
      } else {
        unsigned v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = elem(n, k + 2 * e) | ((unsigned)elem(n, k + 2 * e + 1) << 16);
        *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  cp_async_commit();
}

// wait until at most n (0 .. kWMaxStages - 2) of this thread's committed
// cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// float2 a row of the partials' area: NW / 2 rounded up to 16
__host__ __device__ constexpr int ps_pitch(int NW) {
  return round_up(NW / 2, 16);
}

// float offset of the partial sum (row b, product row n) in the partials'
// area: rows of ps_pitch float2, the float2 index XORed with 2 (b % 8), so
// that the warpgroups' stores of their accumulators fill every bank
__device__ __forceinline__ int ps_offset(int b, int n, int NW) {
  return 2 * (b * ps_pitch(NW) + ((n >> 1) ^ ((b & 7) << 1))) + (n & 1);
}

template <bool LSTM, bool FWD, int NW>
__global__ void __launch_bounds__(kWThreads, 1)
cell_rollout_wgmma_kernel(const RollArgs<bf16> a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((kWAlign - (recnet::smem_addr(smem_raw) & (kWAlign - 1))) &
                  (kWAlign - 1));
  constexpr int nG = LSTM ? 4 : 3;
  constexpr int R = NW / 2;                     // accumulators a thread
  constexpr int RP = ps_pitch(NW);
  constexpr int kIn = FWD ? nG + 1 : 8;         // a pair's prefetched inputs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;                     // batch rows 64 wg ..
  const int H = a.H, G = a.G, B = a.B, C = a.C, ub = a.ub, U = C * ub;
  const int rank = (int)(blockIdx.x % C), q = (int)(blockIdx.x / C);
  const int cu0 = q * U;                        // the cluster's units
  const int K = FWD ? H : G;
  const int kbeg = rank * a.kc, kend = min(K, kbeg + a.kc);
  const int nchunks = a.kc / kKC, S = a.stages;
  const int u_lo = cu0 + rank * ub;             // the block's own units
  const bool exchange = !(a.probe & kNoExchange);
  const bool cluster_sum = exchange && C > 1;
  const bool product = !(a.probe & kNoProduct);
  const bool mma = !(a.probe & kNoMma);
  const int stage_bytes = a.Bp * 128;
  // the ring, then the rows that a warpgroup's 64-row tile reads past the
  // last stage (garbage rows, whose products nothing reads), then the held
  // slice; the partials lie over the ring after the product
  unsigned char* ring = smem;
  unsigned char* Ws =
      ring + S * stage_bytes + ((a.Bp > 64 ? 128 : 64) - a.Bp) * 128;
  float* Ps = reinterpret_cast<float*>(ring);
  // a byte a half chunk: whether its writers had all published (the scan)
  unsigned char* ready = Ws + a.kc / kKC * NW * 128;
  // forward: b_hh of the block's units, [gate][unit], read once a launch
  // (L1 is invalidated by every acquire of a step)
  float* bias_s = reinterpret_cast<float*>(ready + kWReady);

  load_w_tiles<FWD>(Ws, NW, a.w, a.vec & kVecW, a.kc, nG, cu0, U, kbeg, kend,
                    H, G);
  if (FWD)
    for (int i = tid; i < nG * ub; i += kWThreads) {
      const int j = u_lo + i % ub;
      bias_s[i] = j < H ? to_f(a.bias[(i / ub) * H + j]) : 0.0f;
    }

  int round = 0;   // passes so far: each is one phase pair of the cluster
  // One pass of step t over batch rows b_lo .. b_lo + bp: the cells'
  // inputs loaded; P = X W_blk^T over the block's k slice (X's rows from
  // b_lo, the chunks staged once `need` is published by their writers; no
  // wait where need = 0); the partials out; the cluster's sum; the cells.
  auto pass = [&](const bf16* X, int ldx, bool xvec, unsigned need, int b_lo,
                  int bp, int t) {
    // the peers have read the last pass's partials, which lie over the ring
    if (round > 0) {
      if (cluster_sum)
        recnet::cluster_wait();
      else
        __syncthreads();
    }
    ++round;
    const int npairs = ub * bp;
    // the cells' inputs as stored (bf16 bits), converted only where the
    // cells use them, so that the loads land while the product runs
    unsigned short in[kWMaxPairs][kIn];
#pragma unroll
    for (int s = 0; s < kWMaxPairs; ++s) {
      // a thread past its pairs or a unit past H reads a valid pair's
      const int i = min(tid + s * kWThreads, npairs - 1);
      const int j = min(u_lo + i % ub, H - 1), b = b_lo + i / ub;
      const long bj = (long)b * H + j, row = (long)t * B + b;
      unsigned short* v = in[s];
      if constexpr (FWD) {
#pragma unroll
        for (int g = 0; g < nG; ++g) v[g] = ld_bits(a.gi + row * G + g * H + j);
        // the carry, c or h: the thread's own store of the last step
        v[nG] = t == 0 ? ld_bits((LSTM ? a.c0 : a.h0) + bj)
                       : ldcg_bits((LSTM ? a.cs : a.hs) + (row - B) * H + j);
      } else {
        v[7] = ldcg_bits((LSTM ? a.dc0 : a.dh0) + bj);   // dc, or GRU's dh z
        if (t > 0) {                                // step t - 1's inputs
          const long rw = row - B;
          v[0] = ld_bits(a.dhs + rw * H + j);
#pragma unroll
          for (int g = 0; g < 4; ++g) v[1 + g] = ld_bits(a.acts + rw * 4 * H + g * H + j);
          if constexpr (LSTM) {
            v[5] = ld_bits(a.cs + rw * H + j);
            v[6] = ld_bits(t == 1 ? a.c0 + bj : a.cs + (rw - B) * H + j);
          } else {
            v[5] = ld_bits(t == 1 ? a.h0 + bj : a.hs + (rw - B) * H + j);
          }
        }
      }
    }
    float acc[R];
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.0f;
    const bool rows_on = 64 * wg < bp;          // warpgroup-uniform
    // the chunks whose writers have all published, from one look at every
    // writer of the slice; a chunk found short is staged after looks at all
    // of them again (one L2 round trip each), until it is ready
    if (product && need) {
      scan_ready(ready, a.flags, need, kbeg, a.kc, kend, H, U, ub, C);
      __syncthreads();
    }
    auto stage = [&](int c) {
      if (need) {
        const long long start = clock64();
        while (!(ready[2 * c] && ready[2 * c + 1])) {   // block-uniform
          __syncthreads();
          __nanosleep(64);
          scan_ready(ready, a.flags, need, kbeg, a.kc, kend, H, U, ub, C);
          __syncthreads();
          if (clock64() - start > kBarrierTimeout) __trap();
        }
      }
      stage_tile(ring + (c % S) * stage_bytes, X, ldx, xvec, b_lo, bp,
                 kbeg + c * kKC, kend);
    };
    // S stages, S - 2 chunks staged ahead: chunk c's copies land while
    // chunk c - 1's MMAs run, and the stage they fill held chunk c - 2,
    // whose MMAs are done
    if (product) {
#pragma unroll 1
      for (int c = 0; c < S - 2; ++c) {
        if (c < nchunks) stage(c);
        cp_async_commit();
      }
#pragma unroll 1
      for (int c = 0; c < nchunks; ++c) {
        cp_async_wait_n(S - 3);                 // chunk c is in
        recnet::fence_proxy_async();
        recnet::wgmma_wait<1>();                // chunk c - 2's stage is read
        recnet::fence_operands(acc);
        __syncthreads();
        if (mma && rows_on) {
          const unsigned xa =
              recnet::smem_addr(ring + (c % S) * stage_bytes) + wg * 8192;
          const unsigned wa = recnet::smem_addr(Ws) + c * NW * 128;
          recnet::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKC / 16; ++kk)
            recnet::wgmma_bf16<NW>(acc, recnet::sw128_desc(xa + 32 * kk),
                                   recnet::sw128_desc(wa + 32 * kk), 1);
          recnet::wgmma_commit();
          recnet::fence_operands(acc);
        }
        if (c + S - 2 < nchunks) stage(c + S - 2);
        cp_async_commit();
      }
      recnet::wgmma_wait<0>();
      recnet::fence_operands(acc);
    }
    cp_async_wait<0>();     // (the held slice's copies, without a product)
    __syncthreads();        // the ring is read: the partials go over it
    if (rows_on) {
      const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);
      float2* P2 = reinterpret_cast<float2*>(Ps);
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int p = (4 * j + (lane & 3)) ^ ((r0 & 7) << 1);
        if (r0 < bp) P2[r0 * RP + p] = make_float2(acc[4 * j], acc[4 * j + 1]);
        if (r0 + 8 < bp)
          P2[(r0 + 8) * RP + p] = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    recnet::fence_proxy_async();   // before the ring is staged into again
    if (cluster_sum) {
      recnet::cluster_arrive();    // the partials are out
      recnet::cluster_wait();
    } else {
      __syncthreads();
    }
    // each pair's P summed over the cluster's ranks in order: every load
    // first, then the cells
    float P[kWMaxPairs][FWD ? nG : 1];
#pragma unroll
    for (int s = 0; s < kWMaxPairs; ++s) {
      const int i = min(tid + s * kWThreads, npairs - 1);
      const int u = i % ub, bl = i / ub;
#pragma unroll
      for (int g = 0; g < (FWD ? nG : 1); ++g) P[s][g] = 0.0f;
      for (int r = 0; r < (cluster_sum ? C : 1); ++r) {
        const float* src =
            cluster_sum ? cg::this_cluster().map_shared_rank(Ps, r) : Ps;
#pragma unroll
        for (int g = 0; g < (FWD ? nG : 1); ++g)
          P[s][g] += src[ps_offset(bl, g * U + rank * ub + u, NW)];
      }
    }
#pragma unroll
    for (int s = 0; s < kWMaxPairs; ++s) {
      const int i = tid + s * kWThreads;
      const int j = u_lo + i % ub, b = b_lo + i / ub;
      if (i >= npairs || j >= H) continue;
      float v[kIn];
#pragma unroll
      for (int e = 0; e < kIn; ++e) v[e] = bits_f(in[s][e]);
      const long row = (long)t * B + b;
      if constexpr (FWD) {
        float bias[nG];
#pragma unroll
        for (int g = 0; g < nG; ++g) bias[g] = bias_s[g * ub + i % ub];
        if constexpr (LSTM) {
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) pre[g] = round_to<bf16>(v[g] + P[s][g]);
          fwd_lstm_store<bf16>(a, row, j, pre, bias, v[nG]);
        } else {
          fwd_gru_store<bf16>(a, row, j, P[s], v, bias, v[nG]);
        }
      } else {
        const float dh = LSTM ? round_to<bf16>(P[s][0])
                              : round_to<bf16>(v[7] + P[s][0]);
        if (t > 0)
          bwd_cell_store<bf16, LSTM>(a, t - 1, j, b, v, dh,
                                     LSTM ? v[7] : 0.0f);
        else
          a.dh0[(long)b * H + j] = from_f<bf16>(dh);
      }
    }
    if (cluster_sum) recnet::cluster_arrive();   // the peers' partials read
  };
  // this block's units are written up to `count`
  auto publish = [&](unsigned count) {
    __syncthreads();
    if (tid == 0) st_release(a.flags + blockIdx.x, a.base + count);
  };

  const bool vec_h0 = a.vec & kVecH0, vec_hs = a.vec & kVecHs;
  const bool vec_dg = a.vec & kVecDg, vec_acts = a.vec & kVecActs;
  if constexpr (FWD) {
#pragma unroll 1
    for (int t = 0; t < a.steps; ++t) {
      const bool first = t == 0 || !exchange;
      const bf16* X = first ? a.h0 : a.hs + (long)(t - 1) * B * H;
#pragma unroll 1
      for (int b_lo = 0; b_lo < B; b_lo += a.Bp)
        pass(X, H, first ? vec_h0 : vec_hs, first ? 0u : a.base + t, b_lo,
             min(a.Bp, B - b_lo), t);
      publish(t + 1);                           // h_t
    }
  } else {
    // step T - 1's cell from zero carries, on the passes' pairs
#pragma unroll 1
    for (int b_lo = 0; b_lo < B; b_lo += a.Bp) {
      const int npairs = ub * min(a.Bp, B - b_lo);
      for (int i = tid; i < npairs; i += kWThreads) {
        const int j = u_lo + i % ub, b = b_lo + i / ub;
        if (j < H) {
          float v[7];
          bwd_cell_load<bf16, LSTM>(a, a.steps - 1, j, b, v);
          bwd_cell_store<bf16, LSTM>(a, a.steps - 1, j, b, v, 0.0f, 0.0f);
        }
      }
    }
    publish(1);                                 // dgates[T - 1]
#pragma unroll 1
    for (int t = a.steps - 1; t >= 0; --t) {
      const bf16* X = exchange ? (LSTM ? a.dgi : a.dgh) + (long)t * B * G
                               : a.acts + (long)t * B * 4 * H;
#pragma unroll 1
      for (int b_lo = 0; b_lo < B; b_lo += a.Bp)
        pass(X, exchange ? G : 4 * H, exchange ? vec_dg : vec_acts,
             exchange ? a.base + (a.steps - t) : 0u, b_lo,
             min(a.Bp, B - b_lo), t);
      if (t > 0) publish(a.steps - t + 1);      // dgates[t - 1]
    }
  }
  // no block leaves while a peer may still read its partials
  if (cluster_sum) recnet::cluster_wait();
}

// ---------------------------------------------------------------------------
// the f32 body
// ---------------------------------------------------------------------------

// the named barrier `id` of n threads: wait, or arrive without waiting
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// waits for the phase of parity `parity` of the mbarrier `bar` (trapping
// after about 10 s)
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (recnet::mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!recnet::mbar_try_wait(bar, parity))
    if (clock64() - start > kBarrierTimeout) __trap();
}

// By the f32 body's producer thread t: rows b_lo .. b_lo + bp of X's
// columns [k0, k0 + 32) into `dst`, rows of kFPitch floats (zero past
// kend), all by cp.async (so that the thread's arrival on the slot's
// mbarrier covers them): 16-byte pieces (cg: L2 only, since other SMs
// wrote them) where vec allows, the rest 4 bytes at a time.
__device__ __forceinline__ void stage_rows(float* dst, const float* X,
                                           int ldx, bool vec, int b_lo,
                                           int bp, int k0, int kend, int t) {
  for (int i = t; i < bp * 8; i += kFProducer) {
    const int r = i >> 3, j = i & 7, k = k0 + 4 * j;
    float* d = dst + r * kFPitch + 4 * j;
    const float* s = X + (long)(b_lo + r) * ldx + k;
    if (vec && k + 4 <= kend) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4_zfill(d + e, k + e < kend ? s + e : X, k + e < kend);
    }
  }
}

// One k8 step of a warpgroup in three TF32 terms into t, from zero: the A
// fragment (rows r0 and r0 + 8 of the staged rows xs where ok0 / ok1, k
// columns kq and kq + 4) split into ah / al in registers; B the split
// weight tiles at shared addresses bhi / blo (the k8 slice's start). The
// group is committed, not waited for.
template <int NW>
__device__ __forceinline__ void tf32_k8(float (&t)[NW / 2], unsigned (&ah)[4],
                                        unsigned (&al)[4], const float* xs,
                                        int r0, bool ok0, bool ok1, int kq,
                                        unsigned bhi, unsigned blo) {
  const float* x0 = xs + r0 * kFPitch + kq;
  const float* x1 = x0 + 8 * kFPitch;
  const float x[4] = {ok0 ? x0[0] : 0.0f, ok1 ? x1[0] : 0.0f,
                      ok0 ? x0[4] : 0.0f, ok1 ? x1[4] : 0.0f};
#pragma unroll
  for (int e = 0; e < 4; ++e) recnet::split_tf32(x[e], ah[e], al[e]);
  recnet::fence_operands(t);
  recnet::wgmma_fence();
  recnet::wgmma_tf32<NW>(t, al, recnet::sw128_desc(bhi), 0);
  recnet::wgmma_tf32<NW>(t, ah, recnet::sw128_desc(blo), 1);
  recnet::wgmma_tf32<NW>(t, ah, recnet::sw128_desc(bhi), 1);
  recnet::wgmma_commit();
  recnet::fence_operands(t);
  recnet::fence_operands(ah);
  recnet::fence_operands(al);
}

// acc += t in IEEE f32, once t's group has been waited for (the fences keep
// t's and the A fragment's registers as they are until here)
template <int R>
__device__ __forceinline__ void add_k8(float (&acc)[R], float (&t)[R],
                                       unsigned (&ah)[4], unsigned (&al)[4]) {
  recnet::fence_operands(t);
  recnet::fence_operands(ah);
  recnet::fence_operands(al);
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += t[i];
}

template <bool LSTM, bool FWD, int NW>
__global__ void __launch_bounds__(kFThreads, 1)
cell_rollout_tf32_kernel(const RollArgs<float> a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((kWAlign - (recnet::smem_addr(smem_raw) & (kWAlign - 1))) &
                  (kWAlign - 1));
  constexpr int nG = LSTM ? 4 : 3;
  constexpr int R = NW / 2;                     // accumulators a thread
  constexpr int RP = ps_pitch(NW);
  constexpr int kIn = FWD ? nG + 1 : 8;         // a pair's inputs
  constexpr int kTile = NW * 128;               // a split tile's bytes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;                     // 0, 1: rows 64 wg ..; 2
  const bool producer = wg == 2;
  const int ptid = tid - kFConsumers;           // the producer's threads
  const int H = a.H, G = a.G, B = a.B, C = a.C, ub = a.ub, U = C * ub;
  const int rank = (int)(blockIdx.x % C), q = (int)(blockIdx.x / C);
  const int cu0 = q * U;                        // the cluster's units
  const int Uv = min(U, H - cu0);               // ... below H
  const int K = FWD ? H : G;
  const int kbeg = rank * a.kc, kend = min(K, kbeg + a.kc);
  const int nchunks = a.kc / kFKC;
  const int u_lo = cu0 + rank * ub;             // the block's own units
  const bool exchange = !(a.probe & kNoExchange);
  const bool cluster_sum = exchange && C > 1;
  const bool product = !(a.probe & kNoProduct);
  const bool mma = !(a.probe & kNoMma);
  const int stage_bytes = a.Bp * kFPitch * 4;
  // the slots' split weight tiles (a hi and a lo tile a chunk), their
  // staged rows (the partials lie over them after the product), their
  // mbarriers, the readiness scan's bytes, b_hh of the block's units
  unsigned char* split = smem;
  unsigned char* ring = split + kFSlots * 2 * kTile;
  float* Ps = reinterpret_cast<float*>(ring);
  const unsigned full0 = recnet::smem_addr(ring + kFSlots * stage_bytes);
  unsigned char* ready = ring + kFSlots * stage_bytes + kFSlots * 8;
  float* bias_s = reinterpret_cast<float*>(ready + kWReady);
  // the block's part of the images: chunk c's hi tile, then its lo tile
  unsigned char* images = reinterpret_cast<unsigned char*>(a.wsplit) +
                          (long)blockIdx.x * nchunks * 2 * kTile;

  if (FWD)
    for (int i = tid; i < nG * ub; i += kFThreads) {
      const int j = u_lo + i % ub;
      bias_s[i] = j < H ? a.bias[(i / ub) * H + j] : 0.0f;
    }
  if (tid == 0)
    for (int s = 0; s < kFSlots; ++s)
      recnet::mbar_init(full0 + 8 * s, kFProducer + 1);
  recnet::fence_mbar_init();
  // The block's slice of W_hh split once for the launch into the chunks'
  // tile images, in the layout of the slots' tiles (swizzled K-major rows
  // of 32 k a product row; zero outside the slice): piece (chunk c,
  // product row n, k 4j .. 4j + 3), 16 bytes of hi and of lo. Forward row n
  // is gate n / U of the cluster's unit n % U, backward the cluster's unit
  // n. The images are read back through the async proxy (bulk copies).
  if (product) {
    for (int i = tid; i < nchunks * NW * 8; i += kFThreads) {
      const int c = i / (NW * 8), r = i - c * NW * 8;
      const int n = r % NW, j = r / NW, k = kbeg + c * kFKC + 4 * j;
      const int gate = n / U, u = n - gate * U;
      const bool row_ok = FWD ? gate < nG && u < Uv : n < Uv;
      unsigned hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long idx = FWD ? (long)(k + e) * G + (long)gate * H + cu0 + u
                             : (long)(cu0 + n) * G + k + e;
        recnet::split_tf32(row_ok && k + e < kend ? __ldg(a.w + idx) : 0.0f,
                           hi[e], lo[e]);
      }
      unsigned char* tile = images + c * 2 * kTile + recnet::sw128(n, j);
      *reinterpret_cast<uint4*>(tile) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(tile + kTile) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    recnet::fence_proxy_async_global();
  }
  __syncthreads();

  // the chunks in the order the products take them, every pass of every
  // step: chunk g is the slice's chunk g % nchunks, in slot g % kFSlots,
  // the (g / kFSlots)-th phase of the slot's mbarrier
  const long passes = (B + a.Bp - 1) / a.Bp;
  const long total = product ? (long)a.steps * passes * nchunks : 0;
  long g0 = 0;       // the pass's first chunk

  int round = 0;   // passes so far: each is one phase pair of the cluster
  // One pass of step t over batch rows b_lo .. b_lo + bp: P = X W_blk^T
  // over the block's k slice (X's rows from b_lo, the chunks staged once
  // `need` is published by their writers; no wait where need = 0); the
  // cells' inputs loaded; the partials out; the cluster's sum; the cells.
  auto pass = [&](const float* X, int ldx, bool xvec, unsigned need,
                  int b_lo, int bp, int t) {
    // the peers have read the last pass's partials, which lie over the rows
    if (round > 0) {
      if (cluster_sum)
        recnet::cluster_wait();
      else
        __syncthreads();
    }
    ++round;
    const int npairs = ub * bp;
    if (product && producer) {
      // the chunks whose writers have all published, from one look at every
      // writer of the slice; a chunk found short is staged after looks at
      // all of them again (one L2 round trip each), until it is ready
      if (need) {
        scan_ready(ready, a.flags, need, kbeg, a.kc, kend, H, U, ub, C, ptid,
                   kFProducer);
        named_sync(kBarProducer, kFProducer);
      }
      // chunk c into its slot once the consumers are done with chunk c -
      // kFSlots: its rows by cp.async (each thread's arrival on the slot's
      // mbarrier follows its copies' landing), its tile images by one bulk
      // copy whose bytes the mbarrier counts
#pragma unroll 1
      for (int c = 0; c < nchunks; ++c) {
        const long g = g0 + c;
        const int slot = (int)(g % kFSlots);
        if (g >= kFSlots) named_sync(kBarEmpty + slot, kFThreads);
        if (need) {
          const long long start = clock64();
          while (!ready[c]) {                   // producer-uniform
            __nanosleep(64);
            named_sync(kBarProducer, kFProducer);
            scan_ready(ready, a.flags, need, kbeg, a.kc, kend, H, U, ub, C,
                       ptid, kFProducer);
            named_sync(kBarProducer, kFProducer);
            if (clock64() - start > kBarrierTimeout) __trap();
          }
        }
        stage_rows(reinterpret_cast<float*>(ring + slot * stage_bytes), X,
                   ldx, xvec, b_lo, bp, kbeg + c * kFKC, kend, ptid);
        recnet::mbar_arrive_cp_async(full0 + 8 * slot);
        if (ptid == 0) {
          recnet::mbar_arrive_expect(full0 + 8 * slot, 2 * kTile);
          recnet::bulk_copy_g2s(recnet::smem_addr(split + slot * 2 * kTile),
                                images + c * 2 * kTile, 2 * kTile,
                                full0 + 8 * slot);
        }
      }
    } else if (!producer) {
      // the consumers: each k8 step's three terms from zero into tk, added
      // to acc once waited for
      float acc[R], tk[R];
#pragma unroll
      for (int e = 0; e < R; ++e) acc[e] = 0.0f;
      unsigned ah[4], al[4];
      const bool rows_on = 64 * wg < bp;        // warpgroup-uniform
      const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);
      const bool ok0 = r0 < bp, ok1 = r0 + 8 < bp;
      const bool on = mma && rows_on;
      const int kq = lane & 3;
#pragma unroll 1
      for (int c = 0; c < (product ? nchunks : 0); ++c) {
        const long g = g0 + c;
        const int slot = (int)(g % kFSlots);
        mbar_wait(full0 + 8 * slot, (unsigned)((g / kFSlots) & 1));
        if (on) {
          const float* xs =
              reinterpret_cast<const float*>(ring + slot * stage_bytes);
          const unsigned bhi = recnet::smem_addr(split + slot * 2 * kTile);
          const unsigned blo = bhi + kTile;
#pragma unroll
          for (int kk = 0; kk < kFKC / 8; ++kk) {
            tf32_k8<NW>(tk, ah, al, xs, r0, ok0, ok1, kq + 8 * kk,
                        bhi + 32 * kk, blo + 32 * kk);
            recnet::wgmma_wait<0>();
            add_k8(acc, tk, ah, al);
          }
        }
        // the slot is free (its rows read, its tiles' MMAs waited for),
        // where the producer will wait for it
        if (g + kFSlots < total)
          named_arrive(kBarEmpty + slot, kFThreads);
      }
      // both consumer warpgroups have read the rows (all landed): the
      // partials go over them
      named_sync(kBarConsumers, kFConsumers);
      if (rows_on) {
        float2* P2 = reinterpret_cast<float2*>(Ps);
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const int p = (4 * j + (lane & 3)) ^ ((r0 & 7) << 1);
          if (ok0) P2[r0 * RP + p] = make_float2(acc[4 * j], acc[4 * j + 1]);
          if (ok1)
            P2[(r0 + 8) * RP + p] =
                make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
    if (product) g0 += nchunks;
    // the cells' inputs, landing beside the cluster's barrier (a thread past
    // its pairs or a unit past H reads a valid pair's)
    float in[kFMaxPairs][kIn];
#pragma unroll
    for (int s = 0; s < kFMaxPairs; ++s) {
      const int i = min(tid + s * kFThreads, npairs - 1);
      const int j = min(u_lo + i % ub, H - 1), b = b_lo + i / ub;
      const long bj = (long)b * H + j, row = (long)t * B + b;
      float* v = in[s];
      if constexpr (FWD) {
#pragma unroll
        for (int g = 0; g < nG; ++g) v[g] = __ldg(a.gi + row * G + g * H + j);
        // the carry, c or h: the thread's own store of the last step
        v[nG] = t == 0 ? __ldg((LSTM ? a.c0 : a.h0) + bj)
                       : __ldcg((LSTM ? a.cs : a.hs) + (row - B) * H + j);
      } else {
        v[7] = __ldcg((LSTM ? a.dc0 : a.dh0) + bj);   // dc, or GRU's dh z
        if (t > 0) {                                // step t - 1's inputs
          const long rw = row - B;
          v[0] = __ldg(a.dhs + rw * H + j);
#pragma unroll
          for (int g = 0; g < 4; ++g) v[1 + g] = __ldg(a.acts + rw * 4 * H + g * H + j);
          if constexpr (LSTM) {
            v[5] = __ldg(a.cs + rw * H + j);
            v[6] = __ldg(t == 1 ? a.c0 + bj : a.cs + (rw - B) * H + j);
          } else {
            v[5] = __ldg(t == 1 ? a.h0 + bj : a.hs + (rw - B) * H + j);
          }
        }
      }
    }
    if (cluster_sum) {
      recnet::cluster_arrive();    // the partials are out
      recnet::cluster_wait();
    } else {
      __syncthreads();
    }
    // each pair's P summed over the cluster's ranks in order: every load
    // first, then the cells
    float P[kFMaxPairs][FWD ? nG : 1];
#pragma unroll
    for (int s = 0; s < kFMaxPairs; ++s) {
      const int i = min(tid + s * kFThreads, npairs - 1);
      const int u = i % ub, bl = i / ub;
#pragma unroll
      for (int g = 0; g < (FWD ? nG : 1); ++g) P[s][g] = 0.0f;
      for (int r = 0; r < (cluster_sum ? C : 1); ++r) {
        const float* src =
            cluster_sum ? cg::this_cluster().map_shared_rank(Ps, r) : Ps;
#pragma unroll
        for (int g = 0; g < (FWD ? nG : 1); ++g)
          P[s][g] += src[ps_offset(bl, g * U + rank * ub + u, NW)];
      }
    }
#pragma unroll
    for (int s = 0; s < kFMaxPairs; ++s) {
      const int i = tid + s * kFThreads;
      const int j = u_lo + i % ub, b = b_lo + i / ub;
      if (i >= npairs || j >= H) continue;
      const float* v = in[s];
      const long row = (long)t * B + b;
      if constexpr (FWD) {
        float bias[nG];
#pragma unroll
        for (int g = 0; g < nG; ++g) bias[g] = bias_s[g * ub + i % ub];
        if constexpr (LSTM) {
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) pre[g] = v[g] + P[s][g];
          fwd_lstm_store<float>(a, row, j, pre, bias, v[nG]);
        } else {
          fwd_gru_store<float>(a, row, j, P[s], v, bias, v[nG]);
        }
      } else {
        const float dh = LSTM ? P[s][0] : v[7] + P[s][0];
        if (t > 0)
          bwd_cell_store<float, LSTM>(a, t - 1, j, b, v, dh,
                                      LSTM ? v[7] : 0.0f);
        else
          a.dh0[(long)b * H + j] = dh;
      }
    }
    if (cluster_sum) recnet::cluster_arrive();   // the peers' partials read
  };
  // this block's units are written up to `count`
  auto publish = [&](unsigned count) {
    __syncthreads();
    if (tid == 0) st_release(a.flags + blockIdx.x, a.base + count);
  };

  const bool vec_h0 = a.vec & kVecH0, vec_hs = a.vec & kVecHs;
  const bool vec_dg = a.vec & kVecDg, vec_acts = a.vec & kVecActs;
  if constexpr (FWD) {
#pragma unroll 1
    for (int t = 0; t < a.steps; ++t) {
      const bool first = t == 0 || !exchange;
      const float* X = first ? a.h0 : a.hs + (long)(t - 1) * B * H;
#pragma unroll 1
      for (int b_lo = 0; b_lo < B; b_lo += a.Bp)
        pass(X, H, first ? vec_h0 : vec_hs, first ? 0u : a.base + t, b_lo,
             min(a.Bp, B - b_lo), t);
      publish(t + 1);                           // h_t
    }
  } else {
    // step T - 1's cell from zero carries, on the passes' pairs
#pragma unroll 1
    for (int b_lo = 0; b_lo < B; b_lo += a.Bp) {
      const int npairs = ub * min(a.Bp, B - b_lo);
      for (int i = tid; i < npairs; i += kFThreads) {
        const int j = u_lo + i % ub, b = b_lo + i / ub;
        if (j < H) {
          float v[7];
          bwd_cell_load<float, LSTM>(a, a.steps - 1, j, b, v);
          bwd_cell_store<float, LSTM>(a, a.steps - 1, j, b, v, 0.0f, 0.0f);
        }
      }
    }
    publish(1);                                 // dgates[T - 1]
#pragma unroll 1
    for (int t = a.steps - 1; t >= 0; --t) {
      const float* X = exchange ? (LSTM ? a.dgi : a.dgh) + (long)t * B * G
                                : a.acts + (long)t * B * 4 * H;
#pragma unroll 1
      for (int b_lo = 0; b_lo < B; b_lo += a.Bp)
        pass(X, exchange ? G : 4 * H, exchange ? vec_dg : vec_acts,
             exchange ? a.base + (a.steps - t) : 0u, b_lo,
             min(a.Bp, B - b_lo), t);
      if (t > 0) publish(a.steps - t + 1);      // dgates[t - 1]
    }
  }
  // no block leaves while a peer may still read its partials
  if (cluster_sum) recnet::cluster_wait();
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// plan fields (ops/cuda/rollout.py's rollout_plan makes them)
enum { kPlanC, kPlanNB, kPlanUb, kPlanRows, kPlanKc, kPlanBp, kPlanStages,
       kPlanSmem, kPlanFields };

#define RECNET_TRY(x)                              \
  do {                                             \
    const cudaError_t e_ = (x);                    \
    if (e_ != cudaSuccess) return (int)e_;         \
  } while (0)

// clusters of C blocks of `threads` that the card holds at once with
// `smem` bytes a block (raising the kernel's shared-memory limit to the
// card's first)
int capacity(const void* kern, int threads, int C, int smem, int* cap) {
  int dev = 0, limit = 0;
  RECNET_TRY(cudaGetDevice(&dev));
  RECNET_TRY(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  RECNET_TRY(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, limit));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
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

// The kernel of a plan for NW product rows (nullptr for an NW the build has
// no kernel for).
template <typename T, bool LSTM, bool FWD>
void* kernel_of(int NW) {
  if constexpr (std::is_same<T, float>::value) {
    switch (NW) {
      case 32: return (void*)cell_rollout_tf32_kernel<LSTM, FWD, 32>;
      case 64: return (void*)cell_rollout_tf32_kernel<LSTM, FWD, 64>;
      case 96: return (void*)cell_rollout_tf32_kernel<LSTM, FWD, 96>;
      case 104: return (void*)cell_rollout_tf32_kernel<LSTM, FWD, 104>;
    }
  } else {
    switch (NW) {
      case 32: return (void*)cell_rollout_wgmma_kernel<LSTM, FWD, 32>;
      case 64: return (void*)cell_rollout_wgmma_kernel<LSTM, FWD, 64>;
      case 96: return (void*)cell_rollout_wgmma_kernel<LSTM, FWD, 96>;
      case 104: return (void*)cell_rollout_wgmma_kernel<LSTM, FWD, 104>;
    }
  }
  return nullptr;
}

template <typename T>
constexpr int threads_of() {
  return std::is_same<T, float>::value ? kFThreads : kWThreads;
}

// the plan's fields against what the body takes
template <typename T>
bool plan_ok(const int* p, int B, int H) {
  const int C = p[kPlanC], NB = p[kPlanNB], ub = p[kPlanUb];
  const int rows = p[kPlanRows], kc = p[kPlanKc], Bp = p[kPlanBp];
  const int stages = p[kPlanStages];
  if (B < 1 || H < 1 || C < 1 || NB < 1 || ub < 1 || kc < kKC ||
      kc % kKC || Bp < 8 || Bp % 8 || (long)C * NB > kMaxBlocks ||
      (long)C * NB * ub < H || kc > 32 * kWReady || Bp > kWPassRows ||
      !(rows == 32 || rows == 64 || rows == 96 || rows == 104))
    return false;
  if (std::is_same<T, float>::value)
    return ub * Bp <= kFMaxPairs * kFThreads && stages == kFSlots;
  return ub * Bp <= kWMaxPairs * kWThreads && stages >= kWMinStages &&
         stages <= kWMaxStages;
}

template <typename T, bool LSTM, bool FWD>
int launch(const int* p, RollArgs<T> a, cudaStream_t s) {
  if (a.steps < 1 || !plan_ok<T>(p, a.B, a.H))
    return (int)cudaErrorInvalidValue;
  a.C = p[kPlanC];
  a.ub = p[kPlanUb];
  a.Mpad = p[kPlanRows];
  a.kc = p[kPlanKc];
  a.Bp = p[kPlanBp];
  a.stages = p[kPlanStages];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.C * p[kPlanNB], 1, 1);
  cfg.blockDim = dim3(threads_of<T>(), 1, 1);
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
  void* kern = kernel_of<T, LSTM, FWD>(a.Mpad);
  void* args[] = {&a};
  RECNET_TRY(cudaLaunchKernelExC(&cfg, kern, args));
  return (int)cudaGetLastError();
}

template <typename T, bool LSTM>
int forward(const int* p, int steps, int B, int H, int probe, int vec,
            unsigned base, const void* gi, const void* w, const void* bias,
            const void* h0, const void* c0, void* hs, void* cs, void* acts,
            void* scratch, void* wsplit, cudaStream_t s) {
  RollArgs<T> a = {};
  a.steps = steps;
  a.B = B;
  a.H = H;
  a.G = (LSTM ? 4 : 3) * H;
  a.probe = probe;
  a.vec = vec;
  a.base = base;
  a.gi = (const T*)gi;
  a.w = (const T*)w;
  a.bias = (const T*)bias;
  a.h0 = (const T*)h0;
  a.c0 = (const T*)c0;
  a.hs = (T*)hs;
  a.cs = (T*)cs;
  a.acts = (T*)acts;
  a.flags = (unsigned*)scratch;
  a.wsplit = (float*)wsplit;
  return launch<T, LSTM, true>(p, a, s);
}

template <typename T, bool LSTM>
int backward(const int* p, int steps, int B, int H, int probe, int vec,
             unsigned base, const void* dhs, const void* acts, const void* w,
             const void* h0, const void* hs, const void* c0, const void* cs,
             void* dgi, void* dgh, void* dh0, void* dc0, void* dh_steps,
             void* dc_steps, void* scratch, void* wsplit, cudaStream_t s) {
  RollArgs<T> a = {};
  a.steps = steps;
  a.B = B;
  a.H = H;
  a.G = (LSTM ? 4 : 3) * H;
  a.probe = probe;
  a.vec = vec;
  a.base = base;
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
  a.flags = (unsigned*)scratch;
  a.wsplit = (float*)wsplit;
  return launch<T, LSTM, false>(p, a, s);
}

}  // namespace

extern "C" {

const char* recnet_cell_rollout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The current device's SM count, its shared-memory limit a block (with
// the opt-in) and the readiness words a launch's scratch holds.
int recnet_cell_rollout_device(int* out) {
  int dev = 0;
  RECNET_TRY(cudaGetDevice(&dev));
  RECNET_TRY(cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount,
                                    dev));
  RECNET_TRY(cudaDeviceGetAttribute(
      &out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  out[2] = kMaxBlocks;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16; lstm: 1 = LSTM, 0 = GRU; fwd: 1 =
// the forward kernel, 0 = the backward; rows: the body's NW (32, 64, 96 or
// 104). cap: the clusters of C blocks the current device
// holds at once with `smem` bytes a block. Returns a CUDA error code.
int recnet_cell_rollout_capacity(int dtype, int lstm, int fwd, int rows,
                                 int C, int smem, int* cap) {
  void* kern = nullptr;
  int threads = 0;
#define RECNET_KERNEL(T_, L_, F_)                                   \
  if (dtype == (std::is_same<T_, float>::value ? 0 : 1) &&         \
      lstm == (L_ ? 1 : 0) && fwd == (F_ ? 1 : 0)) {                \
    kern = kernel_of<T_, L_, F_>(rows);                             \
    threads = threads_of<T_>();                                     \
  }
  RECNET_KERNEL(float, true, true)
  RECNET_KERNEL(float, true, false)
  RECNET_KERNEL(float, false, true)
  RECNET_KERNEL(float, false, false)
  RECNET_KERNEL(bf16, true, true)
  RECNET_KERNEL(bf16, true, false)
  RECNET_KERNEL(bf16, false, true)
  RECNET_KERNEL(bf16, false, false)
#undef RECNET_KERNEL
  if (kern == nullptr || C < 1 || smem < 0) return (int)cudaErrorInvalidValue;
  return capacity(kern, threads, C, smem, cap);
}

// The forward of a T-step rollout on `plan` (kPlanFields ints, made by
// rollout_plan): gi (T, B, G), w (H, G), bias (G), h0, c0 (LSTM) (B, H) ->
// hs, cs (LSTM) (T, B, H), acts (T, B, 4H). vec: kVecH0 | kVecHs | kVecW
// where h0 / hs / w rows may be copied in 16-byte pieces (bf16). scratch:
// kMaxBlocks readiness words, each at most `base` before the launch and
// left at most base + T + 1; wsplit (f32; unread in bf16): the blocks' tile
// images of W_hh, C NB (k slice / 32) 2 NW 128 bytes, which the launch
// writes and reads; neither shared with a launch that may run at the same
// time. probe: 0, or the split probes' bits. Launches on `stream`.
int recnet_cell_rollout_fwd(int dtype, int lstm, const int* plan, int T,
                            int B, int H, int probe, int vec, unsigned base,
                            const void* gi, const void* w, const void* bias,
                            const void* h0, const void* c0, void* hs,
                            void* cs, void* acts, void* scratch, void* wsplit,
                            void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define RECNET_FWD(T_, L_)                                                  \
  return forward<T_, L_>(plan, T, B, H, probe, vec, base, gi, w, bias, h0, \
                         c0, hs, cs, acts, scratch, wsplit, s)
  if (dtype == 0 && lstm) RECNET_FWD(float, true);
  if (dtype == 0) RECNET_FWD(float, false);
  if (dtype == 1 && lstm) RECNET_FWD(bf16, true);
  if (dtype == 1) RECNET_FWD(bf16, false);
#undef RECNET_FWD
  return (int)cudaErrorInvalidValue;
}

// The backward: dhs (T, B, H), acts (T, B, 4H), w (H, G), h0 and hs
// (GRU), c0 and cs (LSTM) -> dgi (T, B, G; LSTM's dgates), dgh (GRU),
// dh0, dc0 (LSTM) (B, H); dh_steps and dc_steps (LSTM) (T, B, H), or null:
// the carries into each step. vec: kVecDg where dgi's (LSTM) or dgh's
// (GRU) rows may be copied in 16-byte pieces, kVecActs for acts, kVecW for
// w. base, scratch and wsplit as for the forward.
int recnet_cell_rollout_bwd(int dtype, int lstm, const int* plan, int T,
                            int B, int H, int probe, int vec, unsigned base,
                            const void* dhs, const void* acts, const void* w,
                            const void* h0, const void* hs, const void* c0,
                            const void* cs, void* dgi, void* dgh, void* dh0,
                            void* dc0, void* dh_steps, void* dc_steps,
                            void* scratch, void* wsplit, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define RECNET_BWD(T_, L_)                                                   \
  return backward<T_, L_>(plan, T, B, H, probe, vec, base, dhs, acts, w, h0, \
                          hs, c0, cs, dgi, dgh, dh0, dc0, dh_steps,          \
                          dc_steps, scratch, wsplit, s)
  if (dtype == 0 && lstm) RECNET_BWD(float, true);
  if (dtype == 0) RECNET_BWD(float, false);
  if (dtype == 1 && lstm) RECNET_BWD(bf16, true);
  if (dtype == 1) RECNET_BWD(bf16, false);
#undef RECNET_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
