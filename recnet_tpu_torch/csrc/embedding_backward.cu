// The embedding gather's backward for NVIDIA Hopper (sm_90a): the gradient
// of rows = table[tokens] with respect to the table.
//
// For tokens (N,) and the rows' cotangent d_rows (N, E) f32 it writes
// d_table (V, E) f32: row v the sum of the rows d_rows[i] with tokens[i] ==
// v, zeros where no token reads v. The decoder's teacher-forced rollout
// calls it once a train step on its (T, B) input tokens (the
// vocabulary-parallel module's embed). No Pallas kernel is on this path:
// XLA lowers the JAX package's gather transpose itself.
//
// Why a kernel. ATen's route (index_put_ with accumulate) sorts the
// positions by token, then one warp walks each run of equal tokens row by
// row: a caption batch's <PAD> run (about 23,000 of 31,744 positions at B
// 1024, T 31) is one chain of dependent read-modify-writes, about 15 ms.
// The work is a segmented sum over the sorted order: the cotangent read
// once, the table's gradient written once (at B 1024: 59.4 + 7.8 MB, 0.020
// ms at 3.35 TB/s).
//
// Design, four steps on the caller's stream, no host synchronisation and
// every buffer sized from N, E, V and R alone:
//
// 1. embedding_keys_kernel: each position's token as a key (a negative
//    token counts from the end, as the gather reads it; one outside
//    [-V, V) becomes V and is dropped) and the position itself as the
//    value.
// 2. CUB's DeviceRadixSort::SortPairs over the key bits V needs: a stable
//    sort, so the positions of one token stay in position order.
// 3. embedding_tile_sum_kernel: the sorted order cut into fixed tiles of R
//    positions, whatever the runs; a block a (tile, slice of up to 128
//    columns of 4 floats). A thread sums each run of its tile's positions
//    in order (UNROLL rows loaded before they are added) and writes a run
//    that lies inside the tile straight to d_table. A run that crosses a
//    tile edge leaves partial sums in the (tiles, 2, E) buffer: slot 0 the
//    tile's first run where it began in an earlier tile, slot 1 its last
//    run where it began in this tile and goes on past it.
// 4. embedding_merge_kernel: the owner tile of each crossing run (the tile
//    where it began) adds its slot 1 and every later tile's slot 0 in tile
//    order and writes the run's row; the <PAD> run of B 1024 is about 360
//    partials, every column in parallel. Blocks past the tiles write the
//    zero rows: a thread a row, found untouched by a binary search of the
//    sorted keys.
//
// Every row of d_table is written once, by one thread a column; sums are
// f32 adds in a fixed order (the positions of a run in position order, then
// the pieces in tile order), so a run gives the same bits every time and
// the plain twin (ops/cuda/embedding.py) reproduces them. No atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int MAX_THREADS = 128;   // columns of a block (of VW floats each)
constexpr int UNROLL = 8;          // rows a thread loads before it adds them
constexpr int MAX_TILE = 4096;     // R: the tile's keys and positions in smem
constexpr unsigned NO_KEY = 0xffffffffu;   // past either end of the keys

template <int VW> struct Vec;

template <> struct Vec<4> {
  float4 v;
  __device__ static Vec zero() { return {make_float4(0.f, 0.f, 0.f, 0.f)}; }
  __device__ static Vec load(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p))};
  }
  __device__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ void add(const Vec& o) {
    v.x = __fadd_rn(v.x, o.v.x);
    v.y = __fadd_rn(v.y, o.v.y);
    v.z = __fadd_rn(v.z, o.v.z);
    v.w = __fadd_rn(v.w, o.v.w);
  }
};

template <> struct Vec<1> {
  float v;
  __device__ static Vec zero() { return {0.f}; }
  __device__ static Vec load(const float* p) { return {__ldg(p)}; }
  __device__ void store(float* p) const { *p = v; }
  __device__ void add(const Vec& o) { v = __fadd_rn(v, o.v); }
};

template <typename Tok>
__global__ void embedding_keys_kernel(const Tok* __restrict__ tokens,
                                      unsigned* __restrict__ keys,
                                      int* __restrict__ positions, int N,
                                      int V) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  long long t = (long long)tokens[i];
  if (t < 0) t += V;
  keys[i] = (t >= 0 && t < V) ? (unsigned)t : (unsigned)V;
  positions[i] = i;
}

template <int VW>
__global__ void __launch_bounds__(MAX_THREADS)
embedding_tile_sum_kernel(const unsigned* __restrict__ keys,
                          const int* __restrict__ positions,
                          const float* __restrict__ d_rows,
                          float* __restrict__ d_table,
                          float* __restrict__ partial, int N, int E, int V,
                          int R) {
  extern __shared__ int smem[];
  // tile_keys[0] the key before the tile, [1..n] the tile's, [n+1] the
  // key after it
  unsigned* tile_keys = reinterpret_cast<unsigned*>(smem);
  int* tile_pos = smem + R + 2;
  const int t = blockIdx.x;
  const int lo = t * R;
  const int n = min(R, N - lo);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    tile_keys[i + 1] = keys[lo + i];
    tile_pos[i] = positions[lo + i];
  }
  if (threadIdx.x == 0) {
    tile_keys[0] = lo > 0 ? keys[lo - 1] : NO_KEY;
    tile_keys[n + 1] = lo + n < N ? keys[lo + n] : NO_KEY;
  }
  __syncthreads();
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * VW;
  if (c >= E) return;
  Vec<VW> acc = Vec<VW>::zero();
  int start = 0;              // the current run's first index in the tile
  for (int i0 = 0; i0 < n; i0 += UNROLL) {
    Vec<VW> row[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i0 + u < n)
        row[u] = Vec<VW>::load(d_rows + (size_t)tile_pos[i0 + u] * E + c);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u;
      if (i >= n) break;
      acc.add(row[u]);
      const unsigned key = tile_keys[i + 1];
      if (i + 1 < n && tile_keys[i + 2] == key) continue;
      // the run ends here or at the tile's end
      const bool began_before = start == 0 && tile_keys[0] == key;
      const bool goes_on = i + 1 == n && tile_keys[n + 1] == key;
      if (key < (unsigned)V) {
        float* dst = began_before ? partial + ((size_t)t * 2) * E
                     : goes_on   ? partial + ((size_t)t * 2 + 1) * E
                                 : d_table + (size_t)key * E;
        acc.store(dst + c);
      }
      acc = Vec<VW>::zero();
      start = i + 1;
    }
  }
}

template <int VW>
__global__ void __launch_bounds__(MAX_THREADS)
embedding_merge_kernel(const unsigned* __restrict__ keys,
                       const float* __restrict__ partial,
                       float* __restrict__ d_table, int N, int E, int V,
                       int R, int n_tiles) {
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * VW;
  if ((int)blockIdx.x < n_tiles) {
    const int t = blockIdx.x;
    const int lo = t * R;
    const int hi = min(lo + R, N);
    if (hi >= N) return;
    const unsigned key = keys[hi - 1];
    // the owner: the tile's last run goes on past it and began in it
    if (key >= (unsigned)V || keys[hi] != key) return;
    if (lo > 0 && keys[lo - 1] == key && keys[lo] == key) return;
    int a = hi, b = N;        // the run's end: the first key past ``key``
    while (a < b) {
      const int m = (a + b) >> 1;
      if (keys[m] <= key) a = m + 1; else b = m;
    }
    const int last = (a - 1) / R;
    if (c >= E) return;
    Vec<VW> acc = Vec<VW>::load(partial + ((size_t)t * 2 + 1) * E + c);
    for (int u0 = t + 1; u0 <= last; u0 += UNROLL) {
      Vec<VW> piece[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (u0 + u <= last)
          piece[u] = Vec<VW>::load(partial + ((size_t)(u0 + u) * 2) * E + c);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (u0 + u <= last) acc.add(piece[u]);
    }
    acc.store(d_table + (size_t)key * E + c);
    return;
  }
  // the zero rows: blockDim.x rows a block
  __shared__ unsigned char untouched[MAX_THREADS];
  const int r0 = ((int)blockIdx.x - n_tiles) * blockDim.x;
  const int r = r0 + threadIdx.x;
  if (r < V) {
    int a = 0, b = N;         // the first key not below r
    while (a < b) {
      const int m = (a + b) >> 1;
      if (keys[m] < (unsigned)r) a = m + 1; else b = m;
    }
    untouched[threadIdx.x] = a == N || keys[a] != (unsigned)r;
  }
  __syncthreads();
  if (c >= E) return;
  const int rows = min((int)blockDim.x, V - r0);
  for (int i = 0; i < rows; ++i)
    if (untouched[i])
      Vec<VW>::zero().store(d_table + (size_t)(r0 + i) * E + c);
}

size_t align_up(size_t n) { return (n + 255) & ~(size_t)255; }

int key_bits(int V) {
  int bits = 0;
  while (bits < 31 && (1u << bits) <= (unsigned)V) ++bits;
  return bits;
}

struct Workspace {
  unsigned *keys_in, *keys_out;
  int *pos_in, *pos_out;
  float* partial;
  void* sort_tmp;
  size_t sort_bytes, total;
};

// The workspace's parts at ``base`` (nullptr: the sizes alone).
cudaError_t plan(char* base, int N, int E, int V, int R, cudaStream_t s,
                 Workspace* w) {
  const size_t n_tiles = (N + (size_t)R - 1) / R;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + at : nullptr;
    at += align_up(bytes);
    return p;
  };
  w->keys_in = reinterpret_cast<unsigned*>(take((size_t)N * 4));
  w->keys_out = reinterpret_cast<unsigned*>(take((size_t)N * 4));
  w->pos_in = reinterpret_cast<int*>(take((size_t)N * 4));
  w->pos_out = reinterpret_cast<int*>(take((size_t)N * 4));
  w->partial = reinterpret_cast<float*>(take(n_tiles * 2 * E * 4));
  w->sort_bytes = 0;
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, w->sort_bytes, w->keys_in, w->keys_out, w->pos_in,
      w->pos_out, N, 0, key_bits(V), s);
  if (err != cudaSuccess) return err;
  w->sort_tmp = take(w->sort_bytes);
  w->total = at;
  return cudaSuccess;
}

bool valid(int N, int E, int V, int R) {
  return N >= 1 && E >= 1 && V >= 1 && V < INT_MAX && R >= 1
         && R <= MAX_TILE && N <= INT_MAX - R;
}

template <int VW>
cudaError_t launch_sums(const Workspace& w, const float* d_rows,
                        float* d_table, int N, int E, int V, int R,
                        cudaStream_t s) {
  const int cols = (E + VW - 1) / VW;
  const int threads = min(MAX_THREADS, (cols + 31) / 32 * 32);
  const int slices = (cols + threads - 1) / threads;
  const int n_tiles = (N + R - 1) / R;
  const size_t smem = (size_t)(2 * R + 2) * sizeof(int);
  embedding_tile_sum_kernel<VW><<<dim3(n_tiles, slices), threads, smem, s>>>(
      w.keys_out, w.pos_out, d_rows, d_table, w.partial, N, E, V, R);
  const int zero_blocks = (V + threads - 1) / threads;
  embedding_merge_kernel<VW><<<dim3(n_tiles + zero_blocks, slices), threads,
                               0, s>>>(w.keys_out, w.partial, d_table, N, E,
                                       V, R, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* recnet_embedding_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The workspace ``recnet_embedding_backward`` needs for N positions, E
// columns, V rows and tiles of R positions, in bytes, at *bytes.
int recnet_embedding_backward_workspace(int N, int E, int V, int R,
                                        size_t* bytes) {
  if (!valid(N, E, V, R)) return (int)cudaErrorInvalidValue;
  Workspace w;
  const cudaError_t err = plan(nullptr, N, E, V, R, 0, &w);
  *bytes = w.total;
  return (int)err;
}

// d_table (V, E) = the rows of d_rows (N, E) summed by token; tokens (N,)
// int32 (tokens_int64 = 0) or int64 (1). Needs N, E, V >= 1, 1 <= R <=
// 4096 and ``workspace_bytes`` at least the workspace function's answer.
// Launches on ``stream`` and returns the first error (0 on success).
int recnet_embedding_backward(const void* tokens, int tokens_int64,
                              const float* d_rows, float* d_table, int N,
                              int E, int V, int R, void* workspace,
                              size_t workspace_bytes, void* stream) {
  if (!valid(N, E, V, R) || (tokens_int64 != 0 && tokens_int64 != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Workspace w;
  cudaError_t err = plan(static_cast<char*>(workspace), N, E, V, R, s, &w);
  if (err != cudaSuccess) return (int)err;
  if (w.total > workspace_bytes) return (int)cudaErrorInvalidValue;
  const int blocks = (N + 255) / 256;
  if (tokens_int64)
    embedding_keys_kernel<long long><<<blocks, 256, 0, s>>>(
        static_cast<const long long*>(tokens), w.keys_in, w.pos_in, N, V);
  else
    embedding_keys_kernel<int><<<blocks, 256, 0, s>>>(
        static_cast<const int*>(tokens), w.keys_in, w.pos_in, N, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cub::DeviceRadixSort::SortPairs(w.sort_tmp, w.sort_bytes, w.keys_in,
                                        w.keys_out, w.pos_in, w.pos_out, N, 0,
                                        key_bits(V), s);
  if (err != cudaSuccess) return (int)err;
  const bool vec4 = E % 4 == 0
      && reinterpret_cast<uintptr_t>(d_rows) % 16 == 0
      && reinterpret_cast<uintptr_t>(d_table) % 16 == 0;
  return (int)(vec4 ? launch_sums<4>(w, d_rows, d_table, N, E, V, R, s)
                    : launch_sums<1>(w, d_rows, d_table, N, E, V, R, s));
}

}  // extern "C"
