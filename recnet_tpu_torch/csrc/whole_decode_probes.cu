// The K5 probes of the greedy whole decode on the tensor-core body (bf16,
// sm_90a): dual and each ablated part of the Pallas whole_greedy_decode
// (recnet_tpu/ops/pallas/whole_decode.py, _dual_kernel and _make_step's
// ablate stubs). The body is whole_decode_tc.cuh's, which says what each
// variant drops or shares; whole_decode.cu's header says what bounds the
// decode. This source holds only the probes' instantiations, so that they
// build beside whole_decode.cu and a production build never compiles them.
// The same variants on the CUDA-core body (f32, or cuda_cores) are
// whole_decode.cu's.

#include <cuda_runtime.h>

#include "whole_decode_tc.cuh"

namespace {

template <int NG>
int launch_probe(int variant, const Operands& o, cudaStream_t s) {
  switch (variant) {
    case TENSOR_CORES | DUAL: return launch_tc<NG, DUAL>(o, s);
    case TENSOR_CORES | ABL_EMB: return launch_tc<NG, ABL_EMB>(o, s);
    case TENSOR_CORES | 1 << ABL_ATTN_SHIFT:
      return launch_tc<NG, 1 << ABL_ATTN_SHIFT>(o, s);
    case TENSOR_CORES | 2 << ABL_ATTN_SHIFT:
      return launch_tc<NG, 2 << ABL_ATTN_SHIFT>(o, s);
    case TENSOR_CORES | 3 << ABL_ATTN_SHIFT:
      return launch_tc<NG, 3 << ABL_ATTN_SHIFT>(o, s);
    case TENSOR_CORES | 1 << ABL_PROJ_SHIFT:
      return launch_tc<NG, 1 << ABL_PROJ_SHIFT>(o, s);
    case TENSOR_CORES | 2 << ABL_PROJ_SHIFT:
      return launch_tc<NG, 2 << ABL_PROJ_SHIFT>(o, s);
    case TENSOR_CORES | 3 << ABL_PROJ_SHIFT:
      return launch_tc<NG, 3 << ABL_PROJ_SHIFT>(o, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// recnet_whole_decode's arguments (whole_decode.cu), for dtype 1 (bf16)
// and variant TENSOR_CORES | DUAL or TENSOR_CORES | one ABL_ part; the
// operands are the tensor-core body's weight tiles. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int recnet_whole_decode_probe(int dtype, int n_gates, int variant,
                              const void* enc, const void* uv,
                              const void* emb, const void* attn_W,
                              const void* attn_w, const void* attn_b,
                              const void* w_ih, const void* w_hh,
                              const void* bias2, const void* out_w,
                              const void* out_b, const void* h0,
                              const void* c0, const int* tok0, int* tokens,
                              void* h_out, void* c_out, int* tok_out, int B,
                              int L, int F, int A, int E, int H, int V,
                              int n_steps, float emb_scale, void* stream) {
  const Operands o{enc,   uv,   emb,   attn_W, attn_w, attn_b, w_ih,
                   w_hh,  bias2, out_w, out_b, h0,     c0,     tok0,
                   tokens, h_out, c_out, tok_out, B,   L,      F,
                   A,     E,    H,     V,      n_steps, emb_scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return n_gates == 3 ? launch_probe<3>(variant, o, s)
       : n_gates == 4 ? launch_probe<4>(variant, o, s)
                      : (int)cudaErrorInvalidValue;
}

}  // extern "C"
