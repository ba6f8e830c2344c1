// Fused vocab projection + exact per-row top-k for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel outproj_topk of
// recnet_tpu/ops/pallas/topk_proj.py (body _kernel). For out (N, H),
// out_w (H, V) and out_b (V,) it returns the k best logits of each row of
// out @ out_w + out_b: values (N, k) f32 and their columns (N, k) int32, in
// lax.top_k order (value descending; among equal values the lowest column
// first). Beam search calls it once per step with N = batch x beam rows.
//
// Precision. The logits are f32. f32 inputs are multiplied and summed in f32
// FMAs on CUDA cores (no TF32). bf16 inputs go to the tensor cores
// (mma.sync m16n8k16 with f32 accumulators): the products of bf16 values are
// exact and the sums f32. The bias is added in f32 after the sum, as the
// Pallas kernel does.
//
// What bounds it. At the flagship beam (B = 1024, beam 5: N = 5120, H = 512,
// V = 4188) one call is 11.0 G multiply-adds. out_w is 4.3 MB in bf16 and
// stays in the 50 MB L2, so the work, not device memory, bounds it: on CUDA
// cores in f32; in bf16 the tensor cores would take about 0.02 ms, so the
// loads that feed them bound it instead. One block per 64 rows gives 80
// blocks of 8 warps, one per SM, too few warps to hide the L2 latency of
// each slice. The kernel writes 40 B per row (k = 5 values and columns).
// The plain route writes the whole logit matrix every step (86 MB in f32,
// 43 MB in bf16) and reads it again in each of the k rounds of max and mask.
//
// Design. A block owns BM = 64 rows and walks the vocabulary in tiles of
// BN = 128 columns, so no block ever holds a whole logit row and any V works.
// For each tile it computes the 64 x 128 logits from slices of out and
// out_w staged in shared memory: in f32 each of 256 threads owns 4 rows x 8
// columns in registers; in bf16 each of 8 warps owns 32 rows x 32 columns
// of mma.sync tiles, and the next 64-deep slice is loaded into registers
// (two bf16 per 32-bit load where H and V are even) while the current one
// is multiplied. The tile goes to shared memory, and one warp
// per row merges it into that row's running top-k list, which is kept
// sorted in shared memory. A column enters only if it ranks before the
// list's k-th entry, and is inserted after every entry that ranks before
// it. Columns are offered in ascending order, so an equal value from a later
// column never displaces an earlier one, within a tile or across tiles. Rows
// past N and columns past V are masked in the kernel; out and out_w are
// read where they lie, never padded or copied. NaN logits never enter.
// Later work: wgmma with TMA, and a split of V across blocks, since
// N = 5120 gives only 80 blocks for the card's 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstddef>
#include <type_traits>

namespace {

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

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the four 8x8 b16 matrices whose rows lanes 0-7, 8-15, 16-23 and 24-31
// point at, as mma.sync fragments; TRANS delivers them transposed
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
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

}  // namespace

extern "C" {

const char* recnet_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. Needs N, H >= 1 and 1 <= k <= min(128,
// V). Launches on `stream` and returns cudaGetLastError() (0 on success).
int recnet_topk_proj(int dtype, const void* out, const void* out_w,
                     const void* out_b, float* vals, int* idxs, int N, int H,
                     int V, int k, void* stream) {
  if (N < 1 || H < 1 || k < 1 || k > MAX_K || k > V)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
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
