// The v2 paged decode and verify (paged_decode_v2.cuh) on int8 pools with
// per-row f32 scales (the int8 page codec, each chunk decoded after its
// cp.async lands) under a bf16 or an f32 q: a source of its own, so that
// nvcc builds these type pairs beside paged_attention_tc.cu's.  Entry
// points: paged_decode_fwd_v2 and paged_verify_fwd_v2 in
// paged_attention_tc.cu.

#include "paged_decode_v2.cuh"

int launch_dc_codec(const DcParams& p, const Lut& lut, int B, int D, int use_hfa, int bf16,
                    cudaStream_t s) {
  return bf16 ? launch_dc_d<__nv_bfloat16, int8_t>(p, lut, B, D, use_hfa, s)
              : launch_dc_d<float, int8_t>(p, lut, B, D, use_hfa, s);
}
