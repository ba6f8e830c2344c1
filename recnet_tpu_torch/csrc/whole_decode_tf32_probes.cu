// The K5 probes of the f32 greedy whole decode on the TF32 body (sm_90a):
// dual and each ablated part of the Pallas whole_greedy_decode
// (recnet_tpu/ops/pallas/whole_decode.py, _dual_kernel and _make_step's
// ablate stubs). The body is whole_decode_tf32.cuh's, which says what each
// variant drops or shares and how dual's 16 rows fit a block. This source
// holds only the probes' instantiations, so that they build beside
// whole_decode_tf32.cu and a production build never compiles them. The
// same variants on the CUDA-core body (cuda_cores) are whole_decode.cu's.

#include <cuda_runtime.h>

#include "whole_decode_tf32.cuh"

namespace {

template <int NG>
int launch_probe(int variant, const Operands& o, cudaStream_t s) {
  switch (variant) {
    case DUAL: return launch_tf32<NG, DUAL>(o, s);
    case ABL_EMB: return launch_tf32<NG, ABL_EMB>(o, s);
    case 1 << ABL_ATTN_SHIFT:
      return launch_tf32<NG, 1 << ABL_ATTN_SHIFT>(o, s);
    case 2 << ABL_ATTN_SHIFT:
      return launch_tf32<NG, 2 << ABL_ATTN_SHIFT>(o, s);
    case 3 << ABL_ATTN_SHIFT:
      return launch_tf32<NG, 3 << ABL_ATTN_SHIFT>(o, s);
    case 1 << ABL_PROJ_SHIFT:
      return launch_tf32<NG, 1 << ABL_PROJ_SHIFT>(o, s);
    case 2 << ABL_PROJ_SHIFT:
      return launch_tf32<NG, 2 << ABL_PROJ_SHIFT>(o, s);
    case 3 << ABL_PROJ_SHIFT:
      return launch_tf32<NG, 3 << ABL_PROJ_SHIFT>(o, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* recnet_tf32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The body's shared memory in bytes for any variant, its bits as
// recnet_whole_decode_tf32 and recnet_whole_decode_tf32_probe take them
// (K = E + F; E matters under DUAL); the wrapper's tf32_smem_bytes
// mirrors it.
long long recnet_whole_decode_tf32_variant_smem(int n_gates, int variant,
                                                int L, int A, int E, int K,
                                                int H) {
  return (long long)tf32_smem(n_gates, variant, L, A, E, K, H);
}

// recnet_whole_decode_tf32's arguments (whole_decode_tf32.cu) for variant
// DUAL (cluster: blocks a tile of 16 rows) or one ABL_ part (8 rows).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int recnet_whole_decode_tf32_probe(int n_gates, int variant, int cluster,
                                   const float* enc, const float* uv,
                                   const float* emb, const float* attn_W,
                                   const float* attn_w, const float* attn_b,
                                   const float* gates, const float* bias2,
                                   const float* out_w, const float* out_b,
                                   const float* h0, const float* c0,
                                   const int* tok0, int* tokens,
                                   float* h_out, float* c_out, int* tok_out,
                                   int B, int L, int F, int A, int E, int H,
                                   int V, int n_steps, float emb_scale,
                                   void* stream) {
  const Operands o{enc,   uv,     emb,   attn_W, attn_w, attn_b, gates,
                   bias2, out_w,  out_b, h0,     c0,     tok0,   tokens,
                   h_out, c_out,  tok_out, B,    L,      F,      A,
                   E,     H,      V,     n_steps, cluster, emb_scale};
  const cudaStream_t s = (cudaStream_t)stream;
  return n_gates == 3 ? launch_probe<3>(variant, o, s)
       : n_gates == 4 ? launch_probe<4>(variant, o, s)
                      : (int)cudaErrorInvalidValue;
}

}  // extern "C"
