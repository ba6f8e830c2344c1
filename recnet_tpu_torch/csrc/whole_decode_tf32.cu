// The f32 greedy whole decode on the tensor cores, for NVIDIA Hopper
// (sm_90a): the TF32 body of K1/K2 (ops/cuda/whole_decode.py, kernel_route)
// for production and the early exit. The body, what it replaces and what
// bounds it are whole_decode_tf32.cuh's; its K5 probes (dual, ablate) are
// built from whole_decode_tf32_probes.cu, so that a production build never
// compiles them.

#include <cuda_runtime.h>

#include "whole_decode_tf32.cuh"

extern "C" {

const char* recnet_tf32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The width of out_w's column groups in the f32 tiles.
int recnet_whole_decode_tf32_out_group() { return 16 * PT; }

// The body's shared memory in bytes, K = E + F (production's layout is
// the early exit's); the wrapper's tf32_smem_bytes mirrors it.
long long recnet_whole_decode_tf32_smem(int n_gates, int L, int A, int K,
                                        int H) {
  return (long long)tf32_smem(n_gates, 0, L, A, 0, K, H);
}

// n_gates: 3 = GRU, 4 = LSTM; variant: 0 (K1/K2) or 1 (the early exit);
// cluster: blocks a tile of 8 rows (1, 2, 4 or 8, at most H / 16). All
// operands f32; gates, attn_W and out_w are the f32 tiles of
// ops/cuda/layout.py (gate_tiles, column_tiles with groups of 16 and of
// recnet_whole_decode_tf32_out_group()). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int recnet_whole_decode_tf32(int n_gates, int variant, int cluster,
                             const float* enc, const float* uv,
                             const float* emb, const float* attn_W,
                             const float* attn_w, const float* attn_b,
                             const float* gates, const float* bias2,
                             const float* out_w, const float* out_b,
                             const float* h0, const float* c0,
                             const int* tok0, int* tokens, float* h_out,
                             float* c_out, int* tok_out, int B, int L, int F,
                             int A, int E, int H, int V, int n_steps,
                             float emb_scale, void* stream) {
  const Operands o{enc,   uv,     emb,   attn_W, attn_w, attn_b, gates,
                   bias2, out_w,  out_b, h0,     c0,     tok0,   tokens,
                   h_out, c_out,  tok_out, B,    L,      F,      A,
                   E,     H,      V,     n_steps, cluster, emb_scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0)
    return n_gates == 3 ? launch_tf32<3, 0>(o, s)
         : n_gates == 4 ? launch_tf32<4, 0>(o, s)
                        : (int)cudaErrorInvalidValue;
  if (variant == EARLY_EXIT)
    return n_gates == 3 ? launch_tf32<3, EARLY_EXIT>(o, s)
         : n_gates == 4 ? launch_tf32<4, EARLY_EXIT>(o, s)
                        : (int)cudaErrorInvalidValue;
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
