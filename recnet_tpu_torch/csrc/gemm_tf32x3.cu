// The train step's float32 matrix products on the Hopper tensor cores:
// C (+)= A B (+ bias) in three TF32 terms. It replaces no Pallas kernel:
// the JAX package leaves these products to XLA (recnet_tpu/models/
// decoder.py, reconstructors.py, ops/rnn.py and ops/attention.py), and
// cuBLAS runs them in float32 on the CUDA cores, whose 67 TFLOP/s bound a
// B 1024 train step's 3.4 TFLOP of products at 51 ms. TF32 wgmma runs at
// 494.7 TFLOP/s; three terms (164.9 TFLOP/s) keep float32's accuracy.
//
// What it computes (ops/cuda/gemm.py's plain twin and mm_reference): each
// operand split as hi = tf32(x), lo = tf32(x - hi) (hopper_mma.cuh's
// split_tf32, cvt.rna's rounding), a b = a_lo b_hi + a_hi b_lo + a_hi b_hi,
// about 2^-21 of |a b| a product. A is (M x K), K-major (a[m lda + k]) or
// M-major (a[m + k lda]); B is (K x N), K-major (b[k + n ldb]) or N-major
// (b[k ldb + n]); C's element (m, n) lies at c[m c_rs + n c_cs], bias's at
// bias[m bias_rs + n bias_cs]. Epilogues: C = A B (+ bias), or C += A B.
//
// Bound: a product is 2MNK operations at 164.9 TFLOP/s or its bytes (A, B
// and C once) at 3.35 TB/s; the train step's products are all on the
// operations' side. The design:
// * Warp-specialised blocks of 384 threads, one a SM (205 KB of shared
//   memory): warpgroups 0 and 1 consume, 64 rows of the 128-row tile each,
//   warpgroup 2 produces, into a ring of 4 slots of one 32-k chunk.
// * B, which wgmma reads from shared memory only and K-major only: the
//   producer loads it from global memory into registers (a chunk ahead)
//   and writes its hi and lo halves into the slot as two K-major tiles of
//   128-byte swizzled rows, transposing an N-major B on the way (4-byte
//   stores laid out so that a warp's 32 stores hit 32 banks). A: cp.async
//   into a padded tile in its own layout (no bank conflicts on the fragment
//   reads in either); the consumers read each k8 step's fragment and split
//   it in registers (wgmma's A from registers).
// * A k8 step is three wgmma m64nBNk8 into one register accumulator that
//   a chunk's first step starts from zero; after the chunk's 4 steps (32
//   k) the accumulator is added to the float32 sums on the CUDA cores, so
//   that the tensor cores never sum more than 32 k (their accumulation does
//   not round as IEEE float32 does). Two k8 steps are in flight at a time.
// * Ragged edges (M, N, K not multiples of the tile) are read as zeros and
//   not written. Split-K: block s of a tile sums its k range into a
//   workspace, and a second kernel adds the ranges in order 0, 1, ..., then
//   runs the epilogue: no atomics, the same bits on every call.
// * The wrapper (ops/cuda/gemm.py) swaps A and B (computing C^T = B^T A^T)
//   where that makes B K-major, so that the forward products x W take the
//   producer's 16-byte stores.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBM = 128;           // rows of C a block
constexpr int kBN = 128;           // columns of C a block
constexpr int kBK = 32;            // k a slot: one 128-byte row of f32
constexpr int kSlots = 4;
constexpr int kConsumers = 256;    // warpgroups 0 and 1
constexpr int kProducer = 128;     // warpgroup 2
constexpr int kThreads = kConsumers + kProducer;
constexpr int kPitchK = kBK + 4;   // K-major A rows, floats
constexpr int kPitchM = kBM + 8;   // M-major A rows (a k each), floats
constexpr int kATileBytes =
    (kBM * kPitchK > kBK * kPitchM ? kBM * kPitchK : kBK * kPitchM) * 4;
constexpr int kGroupM = 8;         // tiles of M that neighbouring blocks share
constexpr long long kBarrierTimeout = 20000000000LL;

constexpr int kSlotBytes = 2 * kBN * 128 + kATileBytes;   // B hi, B lo, A
constexpr int kSmemBytes = kSlots * kSlotBytes + 2 * kSlots * 8 + 1024;

struct GemmArgs {
  const float* a;
  long long a_ld;
  const float* b;
  long long b_ld;
  float* c;
  long long c_rs, c_cs;
  const float* bias;         // or null
  long long bias_rs, bias_cs;
  float* ws;                 // split-K partials (splits, M, N), or null
  int M, N, K, splits, kchunk, accumulate, vec_a, vec_b;
};

// waits for the phase of parity `parity` of the mbarrier `bar` (trapping
// after about 10 s)
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (recnet::mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!recnet::mbar_try_wait(bar, parity))
    if (clock64() - start > kBarrierTimeout) __trap();
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   recnet::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The producer thread pt's share of A's chunk [k0, k0 + 32) into the slot's
// A tile by cp.async: K-major rows of kPitchK floats (row r, its 32 k) or
// M-major rows of kPitchM floats (k, its 128 rows); zeros past M and kend.
// 16-byte copies where vec allows, else 4 bytes at a time.
template <bool AK>
__device__ __forceinline__ void stage_a(float* As, const GemmArgs& p, int m0,
                                        int k0, int kend, int pt) {
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int i = pt + kProducer * it;
    int m, k;
    float* dst;
    if (AK) {
      const int r = i >> 3, j = i & 7;
      m = m0 + r;
      k = k0 + 4 * j;
      dst = As + r * kPitchK + 4 * j;
    } else {
      const int kk = i >> 5, j = i & 31;
      m = m0 + 4 * j;
      k = k0 + kk;
      dst = As + kk * kPitchM + 4 * j;
    }
    if (m >= p.M || k >= kend) {
      recnet::cp_async16_zfill(dst, p.a, false);
      continue;
    }
    const float* src = AK ? p.a + (long long)m * p.a_ld + k
                          : p.a + (long long)k * p.a_ld + m;
    if (p.vec_a && (AK ? k + 4 <= kend : m + 4 <= p.M)) {
      recnet::cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = AK ? k + e < kend : m + e < p.M;
        cp_async4_zfill(dst + e, ok ? src + e : p.a, ok);
      }
    }
  }
}

// The producer thread pt's share of B's chunk [k0, k0 + 32) x [n0, n0 +
// kBN), 4 values a piece (zeros past N and kend). K-major: piece i is row n
// = i / 8's k 4 (i % 8) .. + 3. N-major: a warp's 32 pieces cover 16 k by
// 8 n (k % 4 = lane % 4, (k / 4) % 4 = lane / 8, n / 4 odd or even by
// (lane / 4) % 2), so that store_b's 4-byte stores hit 32 banks.
template <bool BK>
__device__ __forceinline__ void piece_b(int i, int& nl, int& kl) {
  if (BK) {
    nl = i >> 3;
    kl = 4 * (i & 7);
  } else {
    const int lane = i & 31, u = i >> 5;
    kl = (lane & 3) | ((lane >> 3) << 2) | ((u & 1) << 4);
    nl = 4 * (((lane >> 2) & 1) | ((u >> 1) << 1));
  }
}

template <bool BK>
__device__ __forceinline__ void load_b(float4 (&v)[kBN / 16],
                                       const GemmArgs& p, int n0, int k0,
                                       int kend, int pt) {
#pragma unroll
  for (int it = 0; it < kBN / 16; ++it) {
    int nl, kl;
    piece_b<BK>(pt + kProducer * it, nl, kl);
    const int n = n0 + nl, k = k0 + kl;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (BK) {
      if (n < p.N && k < kend) {
        const float* src = p.b + (long long)n * p.b_ld + k;
        if (p.vec_b && k + 4 <= kend) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(src));
          x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k + e < kend) x[e] = __ldg(src + e);
        }
      }
    } else {
      if (n < p.N && k < kend) {
        const float* src = p.b + (long long)k * p.b_ld + n;
        if (p.vec_b && n + 4 <= p.N) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(src));
          x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < p.N) x[e] = __ldg(src + e);
        }
      }
    }
    v[it] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// The pieces of load_b split into the slot's hi and lo tiles (K-major rows
// of 128 bytes, swizzled: wgmma's B); the tiles lie at `base` and `base +
// kBN * 128`.
template <bool BK>
__device__ __forceinline__ void store_b(const float4 (&v)[kBN / 16],
                                        unsigned char* base, int pt) {
#pragma unroll
  for (int it = 0; it < kBN / 16; ++it) {
    int nl, kl;
    piece_b<BK>(pt + kProducer * it, nl, kl);
    const float x[4] = {v[it].x, v[it].y, v[it].z, v[it].w};
    unsigned hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) recnet::split_tf32(x[e], hi[e], lo[e]);
    if (BK) {
      const int off = recnet::sw128(nl, kl >> 2);
      *reinterpret_cast<uint4*>(base + off) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(base + kBN * 128 + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = recnet::sw128(nl + e, kl >> 2) + 4 * (kl & 3);
        *reinterpret_cast<unsigned*>(base + off) = hi[e];
        *reinterpret_cast<unsigned*>(base + kBN * 128 + off) = lo[e];
      }
    }
  }
}

// One k8 step of a consumer warpgroup: the A fragment (rows `row` and row +
// 8 of the slot's A tile, k columns kk and kk + 4) split in registers, then
// t (+)= a_lo b_hi + a_hi b_lo + a_hi b_hi against the split B tiles at
// shared addresses bhi / blo (the k8 step's start); `acc` = 0 starts t from
// zero. The group is committed, not waited for: ah / al stay as they are
// until it is.
template <bool AK>
__device__ __forceinline__ void k8_step(float (&t)[kBN / 2], unsigned (&ah)[4],
                                        unsigned (&al)[4], const float* As,
                                        int row, int kk, unsigned bhi,
                                        unsigned blo, int acc) {
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = row + 8 * (e & 1), k = kk + 4 * (e >> 1);
    x[e] = AK ? As[r * kPitchK + k] : As[k * kPitchM + r];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) recnet::split_tf32(x[e], ah[e], al[e]);
  recnet::fence_operands(t);
  recnet::wgmma_fence();
  recnet::wgmma_tf32<kBN>(t, al, recnet::sw128_desc(bhi), acc);
  recnet::wgmma_tf32<kBN>(t, ah, recnet::sw128_desc(blo), 1);
  recnet::wgmma_tf32<kBN>(t, ah, recnet::sw128_desc(bhi), 1);
  recnet::wgmma_commit();
  recnet::fence_operands(t);
  recnet::fence_operands(ah);
  recnet::fence_operands(al);
}

// C's element (r, col) of the sum v: the epilogue (bias, then the sum onto
// C where accumulate), or v into the workspace of split `split`
__device__ __forceinline__ void put(const GemmArgs& p, int split, int r,
                                    int col, float v, bool partial) {
  if (partial) {
    p.ws[((long long)split * p.M + r) * p.N + col] = v;
    return;
  }
  if (p.bias) v += p.bias[r * p.bias_rs + col * p.bias_cs];
  float* dst = p.c + r * p.c_rs + col * p.c_cs;
  if (p.accumulate) v = *dst + v;
  *dst = v;
}

template <bool AK, bool BK>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tf32x3_kernel(const GemmArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (recnet::smem_addr(smem_raw) & 1023)) & 1023);
  constexpr int kSlot = kSlotBytes;
  constexpr int kTile = kBN * 128;      // a split B tile's bytes
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kSlots + s)
  const unsigned bars = recnet::smem_addr(smem + kSlots * kSlot);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;

  // the block's tile (tiles of kGroupM row blocks side by side, so that
  // neighbouring blocks share rows of A in L2) and its k range
  const int tiles_m = (p.M + kBM - 1) / kBM, tiles_n = (p.N + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n;
  const int split = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int group = t / (kGroupM * tiles_n), first_m = group * kGroupM;
  const int gm = min(tiles_m - first_m, kGroupM);
  const int within = t % (kGroupM * tiles_n);
  const int m0 = (first_m + within % gm) * kBM, n0 = (within / gm) * kBN;
  const int kbeg = split * p.kchunk, kend = min(p.K, kbeg + p.kchunk);
  const int nk = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;

  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      // the producer's cp.async arrivals (noinc) and its plain ones
      recnet::mbar_init(bars + 8 * s, 2 * kProducer);
      recnet::mbar_init(bars + 8 * (kSlots + s), kConsumers);
    }
  }
  recnet::fence_mbar_init();
  __syncthreads();

  if (wg == 2) {
    // the producer: chunk kt into slot kt % kSlots once the consumers have
    // freed it; B's chunk kt + 1 is read from global memory meanwhile
    const int pt = tid - kConsumers;
    float4 cur[kBN / 16], nxt[kBN / 16];
    if (nk > 0) load_b<BK>(cur, p, n0, kbeg, kend, pt);
#pragma unroll 1
    for (int kt = 0; kt < nk; ++kt) {
      const int slot = kt % kSlots;
      unsigned char* base = smem + slot * kSlot;
      if (kt >= kSlots)
        mbar_wait(bars + 8 * (kSlots + slot), ((kt / kSlots) & 1) ^ 1);
      const int k0 = kbeg + kt * kBK;
      stage_a<AK>(reinterpret_cast<float*>(base + 2 * kTile), p, m0, k0,
                  kend, pt);
      recnet::mbar_arrive_cp_async(bars + 8 * slot);
      if (kt + 1 < nk) load_b<BK>(nxt, p, n0, k0 + kBK, kend, pt);
      store_b<BK>(cur, base, pt);
      recnet::fence_proxy_async();     // the tiles, to wgmma's async proxy
      recnet::mbar_arrive(bars + 8 * slot);
#pragma unroll
      for (int i = 0; i < kBN / 16; ++i) cur[i] = nxt[i];
    }
    cp_async_wait_all();
    return;
  }

  // the consumers: rows 64 wg .. 64 wg + 63 of the tile
  const int row = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int kq = lane & 3;
  float acc[kBN / 2], tk[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % kSlots;
    const unsigned char* base = smem + slot * kSlot;
    mbar_wait(bars + 8 * slot, (kt / kSlots) & 1);
    const float* As = reinterpret_cast<const float*>(base + 2 * kTile);
    const unsigned bhi = recnet::smem_addr(base), blo = bhi + kTile;
    unsigned ah0[4], al0[4], ah1[4], al1[4];
#pragma unroll
    for (int st = 0; st < kBK / 8; ++st) {
      unsigned(&ah)[4] = (st & 1) ? ah1 : ah0;
      unsigned(&al)[4] = (st & 1) ? al1 : al0;
      k8_step<AK>(tk, ah, al, As, row, kq + 8 * st, bhi + 32 * st,
                  blo + 32 * st, st != 0);
      if (st + 1 == kBK / 8) {
        // the chunk's sum into the float32 sums
        recnet::wgmma_wait<0>();
        recnet::fence_operands(tk);
        recnet::fence_operands(ah);
        recnet::fence_operands(al);
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) acc[i] += tk[i];
      } else {
        recnet::wgmma_wait<1>();     // step st - 1 done: its A registers
        recnet::fence_operands((st & 1) ? ah0 : ah1);
        recnet::fence_operands((st & 1) ? al0 : al1);
      }
    }
    recnet::fence_proxy_async();   // before the slot is staged into again
    recnet::mbar_arrive(bars + 8 * (kSlots + slot));
  }

  // accumulator layout: acc[4 j + e] is row `row` + 8 (e / 2), column 8 j +
  // 2 kq + e % 2
  const bool partial = p.splits > 1;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + row + 8 * (e >> 1);
      const int col = n0 + 8 * j + 2 * kq + (e & 1);
      if (r < p.M && col < p.N) put(p, split, r, col, acc[4 * j + e], partial);
    }
}

// Split-K's second pass: the splits' partials of each element added in
// split order, then the epilogue.
__global__ void splitk_reduce_kernel(const GemmArgs p) {
  const long long total = (long long)p.M * p.N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float v = p.ws[i];
    for (int s = 1; s < p.splits; ++s) v += p.ws[s * total + i];
    put(p, 0, (int)(i / p.N), (int)(i % p.N), v, false);
  }
}

template <bool AK, bool BK>
cudaError_t launch(const GemmArgs& p, cudaStream_t stream) {
  static unsigned long long configured = 0;   // a bit a device
  auto kernel = gemm_tf32x3_kernel<AK, BK>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(configured >> (dev & 63) & 1ull)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    configured |= 1ull << (dev & 63);
  }
  const int tiles = ((p.M + kBM - 1) / kBM) * ((p.N + kBN - 1) / kBN);
  kernel<<<tiles * p.splits, kThreads, kSmemBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long total = (long long)p.M * p.N;
  const int blocks = (int)((total + 255) / 256 < 132 * 16
                               ? (total + 255) / 256 : 132 * 16);
  splitk_reduce_kernel<<<blocks, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// C (+)= A B (+ bias) on `stream`; see the file's head for the operands.
// splits > 1 needs ws (splits x M x N floats) and a kchunk that is a
// multiple of 32. Returns a cudaError_t.
int recnet_gemm_tf32x3(const float* a, long long a_ld, int a_kmajor,
                       const float* b, long long b_ld, int b_kmajor,
                       float* c, long long c_rs, long long c_cs,
                       const float* bias, long long bias_rs,
                       long long bias_cs, float* ws, int M, int N, int K,
                       int splits, int kchunk, int accumulate, int vec_a,
                       int vec_b, void* stream) {
  if (M < 1 || N < 1 || K < 0 || splits < 1 ||
      (splits > 1 && (ws == nullptr || kchunk % kBK != 0)))
    return (int)cudaErrorInvalidValue;
  const GemmArgs p{a, a_ld, b, b_ld, c, c_rs, c_cs, bias, bias_rs, bias_cs,
                   ws, M, N, K, splits, splits > 1 ? kchunk : K,
                   accumulate, vec_a, vec_b};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_kmajor)
    return (int)(b_kmajor ? launch<true, true>(p, s)
                          : launch<true, false>(p, s));
  return (int)(b_kmajor ? launch<false, true>(p, s)
                        : launch<false, false>(p, s));
}

const char* recnet_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
