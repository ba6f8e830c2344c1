// Fused vocab projection + exact per-row top-k for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel outproj_topk of
// recnet_tpu/ops/pallas/topk_proj.py (body _kernel). For out (N, H),
// out_w (H, V) and out_b (V,) it returns the k best logits of each row of
// out @ out_w + out_b: values (N, k) f32 and their columns (N, k) int32, in
// lax.top_k order (value descending; among equal values the lowest column
// first). Beam search calls it once per step with N = batch x beam rows.
//
// Precision. The logits are f32. On the split route (k <= 8) f32 inputs go
// to the tensor cores as three-term TF32 products (mma.sync m16n8k8: each
// operand split in registers into hi = tf32(x) and lo = tf32(x - hi), a
// product a_lo b_hi + a_hi b_lo + a_hi b_hi from a zero accumulator, added
// to the f32 sums on the CUDA cores; about 2^-21 of |a b| a product,
// hopper_mma.cuh mma_3xtf32); on the single pass they are multiplied and
// summed in f32 FMAs on CUDA cores (no TF32). bf16 inputs go to the tensor
// cores (mma.sync m16n8k16 with f32 accumulators): the products of bf16
// values are exact and the sums f32. The bias is added in f32 after the
// sum, as the Pallas kernel does.
//
// What bounds it. At the flagship beam (B = 1024, beam 5: N = 5120, H = 512,
// V = 4188) one call is 11.0 G multiply-adds (21.96 GFLOP: 0.022 ms at the
// tensor cores' bf16 peak) over 9.7 MB of operands, so the arithmetic, not
// device memory, bounds it: on CUDA cores in f32, on the tensor cores in
// bf16, where feeding them from L2 is the practical limit. The kernel
// writes 40 B per row (k = 5 values and columns). The plain route writes
// the whole logit matrix every step (86 MB in f32, 43 MB in bf16) and reads
// it again in each of the k rounds of max and mask.
//
// Two designs:
//
// * k <= 8 (the beam path), bf16 and f32: the vocabulary splits into S
//   contiguous ranges of 128-column tiles, one block per (64 rows, range), S
//   chosen by the wrapper so that the blocks fill two a SM in one wave (N =
//   5120: 80 x 3 = 240 blocks for 132 SMs; 4 ranges, 320 blocks, took a
//   second wave and 0.32 ms against 0.26; at the eval batch's beam, N =
//   500, 8 x 6 = 48 blocks where the single pass has 8). Slices of out and
//   out_w (64 deep in bf16, 32 in f32: the same bytes) come through a
//   3-slot cp.async ring in 16-byte copies (the wrapper pads out_w's rows
//   to a multiple of 16 bytes once per parameter set, bf16 V = 4188 ->
//   4192 columns; f32 rows of 4188 already are) into mma.sync, the bf16
//   fragments by ldmatrix, the f32 ones by 32-bit shared loads on row
//   strides that keep them free of bank conflicts. Each thread keeps the k
//   best of its two rows in registers, offered in ascending column order,
//   and the 8 lists of a row are merged in shared memory at the end. Each
//   block writes its rows' k best of its range to an (N, S, k) scratch; a
//   second small kernel, one warp a row, merges the S sorted lists with the
//   lower column first among equal values, as lax.top_k orders them (f32
//   may take S k up to 64, two entries a lane: at the eval batch's N = 500,
//   8 x 12 blocks).
// * k > 8: one pass, below (and the f32 first design, kept as the split
//   route's baseline).
//
// Single-pass design. A block owns BM = 64 rows and walks the vocabulary in
// tiles of BN = 128 columns, so no block ever holds a whole logit row and
// any V works. For each tile it computes the 64 x 128 logits from slices of
// out and out_w staged in shared memory: in f32 each of 256 threads owns 4
// rows x 8 columns in registers; in bf16 each of 8 warps owns 32 rows x 32
// columns of mma.sync tiles, and the next 64-deep slice is loaded into
// registers (two bf16 per 32-bit load where H and V are even) while the
// current one is multiplied. The tile goes to shared memory, and one warp
// per row merges it into that row's running top-k list, which is kept sorted
// in shared memory. A column enters only if it ranks before the list's k-th
// entry, and is inserted after every entry that ranks before it. Columns are
// offered in ascending order, so an equal value from a later column never
// displaces an earlier one, within a tile or across tiles. Rows past N and
// columns past V are masked in the kernel; out and out_w are read where they
// lie, never padded or copied. NaN logits never enter. Later work: wgmma
// with TMA in place of mma.sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstddef>
#include <type_traits>

#include "hopper_mma.cuh"

namespace {

using recnet::ldmatrix_x4;
using recnet::mma_bf16;

constexpr int BM = 64;           // rows per block
constexpr int BN = 128;          // vocab columns per tile
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_K = 128;       // as the Pallas kernel's 128 lanes
constexpr unsigned FULL = 0xffffffffu;

// f32 staging: out transposed [BK][A_LD] (padded against bank conflicts on
// the transposing store) and out_w [BK][BN]
constexpr int BK = 16;
constexpr int A_LD = BM + 4;
constexpr size_t F32_STAGE = sizeof(float) * ((size_t)BK * A_LD + BK * BN);
// bf16 staging: out [BM][A16_LD] and out_w [BK16][B16_LD], rows padded so
// that the fragment loads are free of bank conflicts
constexpr int BK16 = 64;
constexpr int A16_LD = BK16 + 8;
constexpr int B16_LD = BN + 8;
constexpr size_t BF16_STAGE =
    sizeof(__nv_bfloat16) * ((size_t)BM * A16_LD + BK16 * B16_LD);
constexpr size_t STAGE = F32_STAGE > BF16_STAGE ? F32_STAGE : BF16_STAGE;
static_assert(STAGE % 16 == 0, "the logits tile must stay 16-byte aligned");
// row stride of the f32 logits tile, padded against bank conflicts
constexpr int L_LD = BN + 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (v1, i1) ranks before (v2, i2): the larger value, then the lower column
__device__ __forceinline__ bool ranks_before(float v1, int i1, float v2,
                                             int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

size_t smem_bytes(int k) {
  return STAGE + sizeof(float) * (size_t)BM * L_LD
         + (sizeof(float) + sizeof(int)) * (size_t)BM * k;
}

// logits tile [BM][L_LD] of columns v0.. without the bias, f32 on CUDA cores
__device__ __forceinline__ void tile_fma(const float* __restrict__ out,
                                         const float* __restrict__ out_w,
                                         unsigned char* stage, float* l_s,
                                         int m0, int v0, int N, int H,
                                         int V) {
  float* a_s = reinterpret_cast<float*>(stage);  // [BK][A_LD]
  float* b_s = a_s + BK * A_LD;                  // [BK][BN]
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4.. and 64 + tx*4..
  const int ty = tid / 16;  // rows ty*4 .. ty*4 + 3
  float acc[4][8] = {};
  for (int k0 = 0; k0 < H; k0 += BK) {
    // out rows m0.., depth k0..: coalesced along H, stored transposed
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, kk = i % BK;
      const int row = m0 + m, col = k0 + kk;
      a_s[kk * A_LD + m] = row < N && col < H ? out[(size_t)row * H + col]
                                              : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, n = i % BN;
      const int row = k0 + kk, col = v0 + n;
      b_s[kk * BN + n] = row < H && col < V ? out_w[(size_t)row * V + col]
                                            : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = reinterpret_cast<const float4*>(a_s + kk * A_LD)[ty];
      const float4 b0 = reinterpret_cast<const float4*>(b_s + kk * BN)[tx];
      const float4 b1 =
          reinterpret_cast<const float4*>(b_s + kk * BN + 64)[tx];
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) l_s[(ty * 4 + i) * L_LD + c] = acc[i][j];
  }
}

// two bf16 in one register, the first in the low half
__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo)
         | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

// elements (r, c) and (r, c + 1) of a row-major (rows, cols) bf16 matrix,
// zero outside it; c is even. PAIRS: cols is even and the base 4-byte
// aligned, so one 32-bit load reads both.
template <bool PAIRS>
__device__ __forceinline__ unsigned load2(const __nv_bfloat16* __restrict__ m,
                                          int r, int c, int rows, int cols) {
  if (r >= rows || c >= cols) return 0u;
  const __nv_bfloat16* p = m + (size_t)r * cols + c;
  if (PAIRS) return *reinterpret_cast<const unsigned*>(p);
  return pack2(p[0], c + 1 < cols ? p[1] : __float2bfloat16(0.f));
}

// logits tile [BM][L_LD] of columns v0.. without the bias: bf16 products on
// tensor cores, f32 sums. Warp w owns rows (w / 4) * 32.. and columns
// (w % 4) * 32..: 2 x 4 tiles of m16n8. The fragments come from shared
// memory by ldmatrix: A's m16k16 as four 8x8 matrices (rows +0/+8, depth
// +0/+8), B's k16n8 pairs transposed (depth +0/+8, columns +0/+8).
template <bool PAIRS>
__device__ __forceinline__ void tile_mma(
    const __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ out_w, unsigned char* stage,
    float* l_s, int m0, int v0, int N, int H, int V) {
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(stage);  // [BM][A16_LD]
  __nv_bfloat16* b_s = a_s + BM * A16_LD;                  // [BK16][B16_LD]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
  const int g = lane >> 2, tg = lane & 3;
  // the 8x8 matrix row this lane points ldmatrix at: row lane % 8 of
  // matrix lane / 8, whose offsets are +8 rows (odd) and +8 columns (>= 2)
  const int lr = (lane & 7) + (lane & 8), lc = (lane & 16) >> 1;
  // element pairs per thread and slice
  constexpr int A_PER = BM * BK16 / 2 / THREADS;   // 8
  constexpr int B_PER = BK16 * BN / 2 / THREADS;   // 16
  unsigned ra[A_PER], rb[B_PER];

  // slice k0.. of out (rows m0..) and out_w (columns v0..) into registers,
  // coalesced: a warp reads 32 neighbouring pairs of one row
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * THREADS;
      ra[i] = load2<PAIRS>(out, m0 + idx / (BK16 / 2),
                           k0 + 2 * (idx % (BK16 / 2)), N, H);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * THREADS;
      rb[i] = load2<PAIRS>(out_w, k0 + idx / (BN / 2),
                           v0 + 2 * (idx % (BN / 2)), H, V);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * THREADS;
      *reinterpret_cast<unsigned*>(
          a_s + (idx / (BK16 / 2)) * A16_LD + 2 * (idx % (BK16 / 2))) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * THREADS;
      *reinterpret_cast<unsigned*>(
          b_s + (idx / (BN / 2)) * B16_LD + 2 * (idx % (BN / 2))) = rb[i];
    }
  };

  float acc[2][4][4] = {};
  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < H; k0 += BK16) {
    const bool more = k0 + BK16 < H;
    if (more) load(k0 + BK16);  // in flight while this slice multiplies
#pragma unroll
    for (int ks = 0; ks < BK16; ks += 16) {
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4<false>(af[mi], a_s + (wm + mi * 16 + lr) * A16_LD + ks
                                       + lc);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        ldmatrix_x4<true>(r, b_s + (ks + lr) * B16_LD + wn + np * 16 + lc);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm + mi * 16 + g, c = wn + ni * 8 + tg * 2;
      *reinterpret_cast<float2*>(l_s + r * L_LD + c) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(l_s + (r + 8) * L_LD + c) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// Insert (cv, ci) into the sorted list (lv, li) of length k; the whole warp
// calls it. ci is larger than every column already in the list.
__device__ __forceinline__ void insert(float* lv, int* li, int k, float cv,
                                       int ci, int lane) {
  int pos = 0;
#pragma unroll
  for (int s = 0; s < MAX_K / 32; ++s) {
    const int j = s * 32 + lane;
    const bool before = j < k && ranks_before(lv[j], li[j], cv, ci);
    pos += __popc(__ballot_sync(FULL, before));
  }
  float sv[MAX_K / 32];
  int si[MAX_K / 32];
#pragma unroll
  for (int s = 0; s < MAX_K / 32; ++s) {
    const int j = s * 32 + lane;
    if (j >= pos && j < k - 1) {
      sv[s] = lv[j];
      si[s] = li[j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < MAX_K / 32; ++s) {
    const int j = s * 32 + lane;
    if (j >= pos && j < k - 1) {
      lv[j + 1] = sv[s];
      li[j + 1] = si[s];
    }
  }
  if (lane == 0 && pos < k) {
    lv[pos] = cv;
    li[pos] = ci;
  }
  __syncwarp();
}

template <typename T, bool PAIRS>
__global__ void __launch_bounds__(THREADS)
topk_proj_kernel(const T* __restrict__ out, const T* __restrict__ out_w,
                 const T* __restrict__ out_b, float* __restrict__ vals,
                 int* __restrict__ idxs, int N, int H, int V, int k) {
  extern __shared__ float4 smem_f4[];
  unsigned char* stage = reinterpret_cast<unsigned char*>(smem_f4);
  float* l_s = reinterpret_cast<float*>(stage + STAGE);  // [BM][L_LD] logits
  float* list_v = l_s + BM * L_LD;                       // [BM][k]
  int* list_i = reinterpret_cast<int*>(list_v + (size_t)BM * k);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * BM;

  for (int i = tid; i < BM * k; i += THREADS) {
    list_v[i] = -INFINITY;
    list_i[i] = INT_MAX;
  }

  for (int v0 = 0; v0 < V; v0 += BN) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      tile_mma<PAIRS>(out, out_w, stage, l_s, m0, v0, N, H, V);
    else
      tile_fma(out, out_w, stage, l_s, m0, v0, N, H, V);
    __syncthreads();

    // merge the tile, plus the bias in f32, into the running lists: one
    // warp per row, columns in ascending order
    for (int r = warp; r < BM; r += NWARPS) {
      if (m0 + r >= N) break;
      float* lv = list_v + (size_t)r * k;
      int* li = list_i + (size_t)r * k;
#pragma unroll 1
      for (int q = 0; q < BN / 32; ++q) {
        const int col = v0 + q * 32 + lane;
        const bool valid = col < V;
        const float v = valid ? l_s[r * L_LD + q * 32 + lane] + to_f(out_b[col])
                              : -INFINITY;
        unsigned pend = __ballot_sync(
            FULL, valid && ranks_before(v, col, lv[k - 1], li[k - 1]));
        while (pend) {
          const int src = __ffs(pend) - 1;
          const float cv = __shfl_sync(FULL, v, src);
          insert(lv, li, k, cv, v0 + q * 32 + src, lane);
          pend &= pend - 1;
          // the k-th entry only ever improves: filter the rest again
          pend &= __ballot_sync(
              FULL, valid && ranks_before(v, col, lv[k - 1], li[k - 1]));
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < BM * k; i += THREADS) {
    const int row = m0 + i / k;
    if (row < N) {
      vals[(size_t)m0 * k + i] = list_v[i];
      idxs[(size_t)m0 * k + i] = list_i[i];
    }
  }
}

template <typename T, bool PAIRS>
int launch(const void* out, const void* out_w, const void* out_b, float* vals,
           int* idxs, int N, int H, int V, int k, cudaStream_t stream) {
  const size_t smem = smem_bytes(k);
  auto kernel = topk_proj_kernel<T, PAIRS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>((const T*)out, (const T*)out_w,
                                          (const T*)out_b, vals, idxs, N, H,
                                          V, k);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// k <= KR_MAX: vocab ranges split across blocks, then a merge
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int KR_MAX = 8;        // the longest list kept in registers
constexpr int SSTAGES = 3;       // slices in the cp.async ring
constexpr int LISTS = 8;         // lists a row: 4 lanes x 2 column halves

// The staging of one operand type: a slice SBK deep of out [BM][SA_LD]
// and out_w [SBK][SB_LD]. bf16: 64 deep, rows padded so that ldmatrix
// reads hit distinct banks. f32: 32 deep (the same bytes), the out row
// stride 4 mod 32 words (the A fragment's (row g, k t) loads) and the
// out_w stride 8 mod 32 (the B fragment's (k t, column g) loads), so
// that both hit 32 distinct banks.
template <typename T>
struct Stage {
  static constexpr int SBK = std::is_same<T, float>::value ? 32 : 64;
  static constexpr int SA_LD = std::is_same<T, float>::value ? SBK + 4
                                                             : SBK + 8;
  static constexpr int SB_LD = BN + 8;
  static constexpr int SA_ELEMS = BM * SA_LD;
  static constexpr int ELEMS = SA_ELEMS + SBK * SB_LD;   // a slot
  static constexpr int CHUNK = 16 / (int)sizeof(T);     // a 16-byte copy
};
static_assert(Stage<bf16>::ELEMS * sizeof(bf16)
                  == Stage<float>::ELEMS * sizeof(float),
              "both types stage the same bytes");
static_assert(Stage<bf16>::ELEMS * sizeof(bf16) % 16 == 0,
              "slots stay 16-byte aligned");
constexpr size_t SPLIT_RING = sizeof(bf16) * SSTAGES * Stage<bf16>::ELEMS;
constexpr size_t SPLIT_LISTS =
    (sizeof(float) + sizeof(int)) * (size_t)BM * LISTS * KR_MAX;
constexpr size_t SPLIT_SMEM = SPLIT_RING > SPLIT_LISTS ? SPLIT_RING
                                                       : SPLIT_LISTS;

// Offer (v, c) to the sorted list (lv, li) of the KR best; static indices
// only, so the list stays in registers
template <int KR>
__device__ __forceinline__ void offer(float (&lv)[KR], int (&li)[KR],
                                      float v, int c) {
  if (!ranks_before(v, c, lv[KR - 1], li[KR - 1])) return;
  lv[KR - 1] = v;
  li[KR - 1] = c;
#pragma unroll
  for (int s = KR - 1; s > 0; --s) {
    if (ranks_before(lv[s], li[s], lv[s - 1], li[s - 1])) {
      const float tv = lv[s];
      const int ti = li[s];
      lv[s] = lv[s - 1];
      li[s] = li[s - 1];
      lv[s - 1] = tv;
      li[s - 1] = ti;
    }
  }
}

// Block (row block x, vocab range y): the k best of rows m0.. over the
// columns of tiles [y tpr, (y + 1) tpr), written to scratch (N, S, k).
// Warp w owns rows (w % 4) * 16.. and columns (w / 4) * 64.. of each 64 x
// 128 tile: one m16 x eight n8 mma.sync tiles (bf16: m16n8k16; f32:
// m16n8k8 in three TF32 terms). out and out_w slices come
// through a ring of SSTAGES slots by cp.async, every thread copying its
// share, one __syncthreads an item. Each thread keeps the KR best of each
// of its two rows in registers, offered in ascending column order; at the
// end the 8 lists of a row meet in shared memory and one thread merges them.
template <typename T, int KR>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 2 : 1)
topk_split_kernel(const T* __restrict__ out, const T* __restrict__ out_w,
                  const T* __restrict__ out_b, float* __restrict__ scr_v,
                  int* __restrict__ scr_i, int N, int H, int V, int ldw,
                  int k, int S, int tpr, bool aligned_a, bool aligned_b) {
  using St = Stage<T>;
  constexpr int SBK = St::SBK, SA_LD = St::SA_LD, SB_LD = St::SB_LD;
  constexpr int SA_ELEMS = St::SA_ELEMS, SSTAGE = St::ELEMS;
  constexpr int CH = St::CHUNK;
  extern __shared__ float4 smem_f4[];
  T* ring = reinterpret_cast<T*>(smem_f4);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 64;
  const int lr = (lane & 7) + (lane & 8), lc = (lane & 16) >> 1;
  const int m0 = blockIdx.x * BM, r = blockIdx.y;
  const int n_tiles = (V + BN - 1) / BN;
  const int t0 = r * tpr, t1 = min(t0 + tpr, n_tiles);
  const int col_end = min(t1 * BN, V);
  const int nk = (H + SBK - 1) / SBK;
  const int n_items = max(t1 - t0, 0) * nk;

  float lv[2][KR];
  int li[2][KR];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int s = 0; s < KR; ++s) {
      lv[q][s] = -INFINITY;
      li[q][s] = INT_MAX;
    }
  float acc[8][4] = {};

  int i_tile = t0, i_k = 0;   // the next item to issue
  auto issue = [&](int slot) {
    T* a_s = ring + slot * SSTAGE;
    T* b_s = a_s + SA_ELEMS;
    const int k0 = i_k * SBK, v0 = i_tile * BN;
    // out rows m0.., depth k0.., in 16-byte chunks
#pragma unroll
    for (int idx = tid; idx < BM * SBK / CH; idx += THREADS) {
      const int row = idx / (SBK / CH), kc = idx % (SBK / CH) * CH;
      const bool ok = m0 + row < N;
      recnet::copy_chunk(a_s + row * SA_LD + kc,
                 ok ? out + (size_t)(m0 + row) * H : out, k0 + kc, H, ok,
                 aligned_a);
    }
    // out_w depth k0.., columns v0..
#pragma unroll
    for (int idx = tid; idx < SBK * BN / CH; idx += THREADS) {
      const int kk = idx / (BN / CH), cc = idx % (BN / CH) * CH;
      const bool ok = k0 + kk < H;
      recnet::copy_chunk(b_s + kk * SB_LD + cc,
                 ok ? out_w + (size_t)(k0 + kk) * ldw : out_w, v0 + cc, ldw,
                 ok, aligned_b);
    }
    if (++i_k == nk) {
      i_k = 0;
      ++i_tile;
    }
  };

#pragma unroll
  for (int s = 0; s < SSTAGES - 1; ++s) {
    if (s < n_items) issue(s);
    recnet::cp_async_commit();
  }
  int c_tile = t0, c_k = 0;
  for (int i = 0; i < n_items; ++i) {
    recnet::cp_async_wait<SSTAGES - 2>();
    __syncthreads();   // item i landed for all; slot i - 1 was read
    if (i + SSTAGES - 1 < n_items) issue((i + SSTAGES - 1) % SSTAGES);
    recnet::cp_async_commit();
    const T* a_s = ring + (i % SSTAGES) * SSTAGE;
    const T* b_s = a_s + SA_ELEMS;
    if constexpr (std::is_same<T, float>::value) {
      // three-term TF32 products of two k8 steps from a zero accumulator
      // (the tensor cores' own sums stay 16 products deep), added in f32
#pragma unroll
      for (int ks = 0; ks < SBK; ks += 16) {
        unsigned ahi[2][4], alo[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* ap = a_s + (wm + g) * SA_LD + ks + 8 * kk + t4;
          recnet::split_tf32(ap[0], ahi[kk][0], alo[kk][0]);
          recnet::split_tf32(ap[8 * SA_LD], ahi[kk][1], alo[kk][1]);
          recnet::split_tf32(ap[4], ahi[kk][2], alo[kk][2]);
          recnet::split_tf32(ap[8 * SA_LD + 4], ahi[kk][3], alo[kk][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const float* bp =
                b_s + (ks + 8 * kk + t4) * SB_LD + wn + nt * 8 + g;
            unsigned bhi[2], blo[2];
            recnet::split_tf32(bp[0], bhi[0], blo[0]);
            recnet::split_tf32(bp[4 * SB_LD], bhi[1], blo[1]);
            recnet::mma_tf32(d, alo[kk], bhi);
            recnet::mma_tf32(d, ahi[kk], blo);
            recnet::mma_tf32(d, ahi[kk], bhi);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] += d[e];
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < SBK; ks += 16) {
        unsigned af[4];
        ldmatrix_x4<false>(af, a_s + (wm + lr) * SA_LD + ks + lc);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned rr[4];
          ldmatrix_x4<true>(rr, b_s + (ks + lr) * SB_LD + wn + np * 16 + lc);
          const unsigned b0[2] = {rr[0], rr[1]}, b1[2] = {rr[2], rr[3]};
          mma_bf16(acc[2 * np], af, b0);
          mma_bf16(acc[2 * np + 1], af, b1);
        }
      }
    }
    if (++c_k < nk) continue;
    // the tile's logits, plus the bias in f32, into the two rows' lists
    const int v0 = c_tile * BN + wn;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + nt * 8 + 2 * t4 + (e & 1);
        if (col < col_end)
          offer(lv[e >> 1], li[e >> 1], acc[nt][e] + to_f(out_b[col]), col);
        acc[nt][e] = 0.f;
      }
    c_k = 0;
    ++c_tile;
  }

  __syncthreads();   // the ring becomes the lists' meeting place
  float* mv = reinterpret_cast<float*>(smem_f4);    // [BM][LISTS][KR]
  int* mi = reinterpret_cast<int*>(mv + BM * LISTS * KR);
  const int list = (warp >> 2) * 4 + t4;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int at = ((wm + g + q * 8) * LISTS + list) * KR;
#pragma unroll
    for (int s = 0; s < KR; ++s) {
      mv[at + s] = lv[q][s];
      mi[at + s] = li[q][s];
    }
  }
  __syncthreads();
  if (tid < BM && m0 + tid < N) {
    float bv[KR];
    int bi[KR];
#pragma unroll
    for (int s = 0; s < KR; ++s) {
      bv[s] = -INFINITY;
      bi[s] = INT_MAX;
    }
    for (int j = 0; j < LISTS * KR; ++j)
      offer(bv, bi, mv[tid * LISTS * KR + j], mi[tid * LISTS * KR + j]);
    const size_t at = ((size_t)(m0 + tid) * S + r) * k;
#pragma unroll
    for (int s = 0; s < KR; ++s)
      if (s < k) {
        scr_v[at + s] = bv[s];
        scr_i[at + s] = bi[s];
      }
  }
}

// One warp a row: the k best of the row's S sorted lists of k (S k <= 32
// PER: PER entries a lane), ties to the lower column, so to the lower range
template <int PER>
__global__ void topk_merge_kernel(const float* __restrict__ scr_v,
                                  const int* __restrict__ scr_i,
                                  float* __restrict__ vals,
                                  int* __restrict__ idxs, int N, int S,
                                  int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (row >= N) return;   // the whole warp
  const int n = S * k;
  float v[PER];
  int c[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = lane + 32 * p;
    v[p] = j < n ? scr_v[(size_t)row * n + j] : -INFINITY;
    c[p] = j < n ? scr_i[(size_t)row * n + j] : INT_MAX;
  }
  for (int s = 0; s < k; ++s) {
    float bv = v[0];
    int bc = c[0], bp = 0;
#pragma unroll
    for (int p = 1; p < PER; ++p)
      if (ranks_before(v[p], c[p], bv, bc)) {
        bv = v[p];
        bc = c[p];
        bp = p;
      }
    int bl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oc = __shfl_xor_sync(FULL, bc, off);
      const int ol = __shfl_xor_sync(FULL, bl, off);
      if (ranks_before(ov, oc, bv, bc)
          || (ov == bv && oc == bc && ol < bl)) {
        bv = ov;
        bc = oc;
        bl = ol;
      }
    }
    if (lane == 0) {
      vals[(size_t)row * k + s] = bv;
      idxs[(size_t)row * k + s] = bc;
    }
    if (lane == bl) {
#pragma unroll
      for (int p = 0; p < PER; ++p)
        if (p == bp) {
          v[p] = -INFINITY;
          c[p] = INT_MAX;
        }
    }
  }
}

template <typename T, int KR>
int launch_split(const void* out, const void* out_w, const void* out_b,
                 float* vals, int* idxs, float* scr_v, int* scr_i, int N,
                 int H, int V, int ldw, int k, int S, cudaStream_t stream) {
  auto kernel = topk_split_kernel<T, KR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SPLIT_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (V + BN - 1) / BN;
  const int tpr = (n_tiles + S - 1) / S;
  const dim3 grid((N + BM - 1) / BM, S);
  kernel<<<grid, THREADS, SPLIT_SMEM, stream>>>(
      (const T*)out, (const T*)out_w, (const T*)out_b, scr_v, scr_i, N, H,
      V, ldw, k, S, tpr, recnet::rows_aligned16<T>(out, H),
      recnet::rows_aligned16<T>(out_w, ldw));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int ROWS = 8;   // rows (warps) of a merge block
  const dim3 mgrid((N + ROWS - 1) / ROWS);
  if (S * k > 32)
    topk_merge_kernel<2><<<mgrid, 32 * ROWS, 0, stream>>>(scr_v, scr_i, vals,
                                                          idxs, N, S, k);
  else
    topk_merge_kernel<1><<<mgrid, 32 * ROWS, 0, stream>>>(scr_v, scr_i, vals,
                                                          idxs, N, S, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* recnet_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. Needs N, H >= 1 and 1 <= k <= min(128,
// V). splits > 0 (k <= 8, splits x k <= 32 in bf16, 64 in f32) runs the
// vocab split into `splits` ranges, with (N, splits, k) scratch at scr_v /
// scr_i and out_w's rows ldw >= V columns apart (columns past V are never
// read as logits); splits = 0 the single-pass kernel, with ldw = V.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int recnet_topk_proj(int dtype, const void* out, const void* out_w,
                     const void* out_b, float* vals, int* idxs, int N, int H,
                     int V, int ldw, int k, float* scr_v, int* scr_i,
                     int splits, void* stream) {
  if (N < 1 || H < 1 || k < 1 || k > MAX_K || k > V || splits < 0
      || ldw < V || (splits == 0 && ldw != V))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (splits > 0) {
    if ((dtype != 0 && dtype != 1) || k > KR_MAX
        || splits * k > (dtype == 0 ? 64 : 32))
      return (int)cudaErrorInvalidValue;
    if (dtype == 0) {
      if (k <= 2)
        return launch_split<float, 2>(out, out_w, out_b, vals, idxs, scr_v,
                                      scr_i, N, H, V, ldw, k, splits, s);
      if (k <= 4)
        return launch_split<float, 4>(out, out_w, out_b, vals, idxs, scr_v,
                                      scr_i, N, H, V, ldw, k, splits, s);
      return launch_split<float, 8>(out, out_w, out_b, vals, idxs, scr_v,
                                    scr_i, N, H, V, ldw, k, splits, s);
    }
    if (k <= 2)
      return launch_split<bf16, 2>(out, out_w, out_b, vals, idxs, scr_v,
                                   scr_i, N, H, V, ldw, k, splits, s);
    if (k <= 4)
      return launch_split<bf16, 4>(out, out_w, out_b, vals, idxs, scr_v,
                                   scr_i, N, H, V, ldw, k, splits, s);
    return launch_split<bf16, 8>(out, out_w, out_b, vals, idxs, scr_v, scr_i,
                                 N, H, V, ldw, k, splits, s);
  }
  if (dtype == 0)
    return launch<float, false>(out, out_w, out_b, vals, idxs, N, H, V, k, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bool pairs = H % 2 == 0 && V % 2 == 0
                     && (size_t)out % 4 == 0 && (size_t)out_w % 4 == 0;
  if (pairs)
    return launch<__nv_bfloat16, true>(out, out_w, out_b, vals, idxs, N, H,
                                       V, k, s);
  return launch<__nv_bfloat16, false>(out, out_w, out_b, vals, idxs, N, H, V,
                                      k, s);
}

}  // extern "C"
