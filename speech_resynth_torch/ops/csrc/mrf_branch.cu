// K2: one fused HiFi-GAN MRF branch for NVIDIA Hopper, sm_90a.
//
// Replaces: speech_resynth_tpu/ops/fused_mrf.py:_mrf_kernel, launched by
// mrf_branch_pallas. Same function (spec: mrf_branch_reference): for each
// dilation d of the branch,
//     x += conv_K(lrelu(conv_{K,d}(lrelu(x)) + b1)) + b2
// with SAME padding, every conv input zero outside the true sequence [0, T).
// Each conv's operands are rounded to bf16, products are accumulated in f32,
// the residual chain stays f32 across all six convs, and the output is
// rounded once.
//
// What bounds it on this card: the operations, 12 K C^2 T B FLOP against one
// read and one write of the (B, C, T) activation, everywhere except K = 3 at
// C = 16 and 32, where the bytes bound it (only barely at C = 32). At B = 16,
// T = 119 940, C = 64, K = 11: 1.04e12 FLOP, 1.05 ms at the bf16 peak.
//
// bf16: the one-branch instance of the block in csrc/mrf_block.cuh (wgmma
// with both operands in shared memory, a TMA weight ring fed by a producer
// warp, live-column M tiles, fused epilogues; its note has the design),
// compiled without K3's branch loop and branch sum, with the widest window,
// 24 576 / C columns (384 at C = 64: recompute 1.45x at K = 11). The tile
// comes from the C entry's plan (srt_mrf_branch_plan, read by
// ops/fused_mrf.py:kernel_branch_plan).
//
// f32 (used only by the card-side checks): K3's f32 kernel with one branch
// (csrc/fused_mrf.cu).
#include <cuda_runtime.h>

#include "mrf_block.cuh"

// K3 (fused_mrf.cu); K2's f32 variant is its one-branch case
extern "C" int srt_mrf_stage(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                             void* scratch, long long scratch_floats, int B, int C, int T_len, int n_branches,
                             const int* shapes, int is_bf16, float slope, void* stream);
extern "C" int srt_mrf_stage_plan(int B, int C, int T_len, int n_branches, const int* shapes, int is_bf16, int* plan);

namespace {

using mrf_block::Plan;
using mrf_block::Spec;

bool plan_bf16(int B, int C, int T_len, const Spec& spec, int sms, Plan* plan) {
  switch (C) {
    case 16: return mrf_block::plan_block<16, false>(B, T_len, spec, sms, plan);
    case 32: return mrf_block::plan_block<32, false>(B, T_len, spec, sms, plan);
    case 64: return mrf_block::plan_block<64, false>(B, T_len, spec, sms, plan);
    default: return false;
  }
}

// the branch as a one-branch stage; false for shapes the kernels do not take
bool branch_spec(int B, int T_len, const int* shape, Spec* spec) {
  return B > 0 && B <= 65535 && T_len > 0 && mrf_block::make_spec(1, shape, spec);
}

}  // namespace

// The plan K2 launches with at (B, C, T) on this card: plan[0..3] = t_tile,
// window columns, shared bytes, the SM count it was made for.
extern "C" int srt_mrf_branch_plan(int B, int C, int T_len, int K, int n_pairs, int d0, int d1, int d2, int is_bf16,
                                   int* plan) {
  const int shape[5] = {K, n_pairs, d0, d1, d2};
  Spec spec;
  if (!branch_spec(B, T_len, shape, &spec)) return cudaErrorInvalidValue;
  if (!is_bf16) return srt_mrf_stage_plan(B, C, T_len, 1, shape, 0, plan);
  int sms = 0;
  const cudaError_t err = mrf_block::sm_count(&sms);
  if (err != cudaSuccess) return err;
  Plan p;
  if (!plan_bf16(B, C, T_len, spec, sms, &p)) return cudaErrorInvalidValue;
  plan[0] = p.t_tile;
  plan[1] = p.window;
  plan[2] = p.lay.shared;
  plan[3] = sms;
  return cudaSuccess;
}

// x and out (B, C, T). bf16: w1, w2 (n_pairs, K, C_out, 64), each tap's rows
// in the 128-byte swizzle (ops/fused_mrf.py:swizzled_taps); f32: (n_pairs,
// K, C_out, C_in). Biases (n_pairs, C). The tile is planned here.
extern "C" int srt_mrf_branch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                              int B, int C, int T_len, int K, int n_pairs, int d0, int d1, int d2, int is_bf16,
                              float slope, void* stream) {
  const int shape[5] = {K, n_pairs, d0, d1, d2};
  Spec spec;
  if (!branch_spec(B, T_len, shape, &spec)) return cudaErrorInvalidValue;
  if (!is_bf16) return srt_mrf_stage(x, w1, b1, w2, b2, out, nullptr, 0, B, C, T_len, 1, shape, 0, slope, stream);
  int sms = 0;
  const cudaError_t err = mrf_block::sm_count(&sms);
  if (err != cudaSuccess) return err;
  Plan plan;
  if (!plan_bf16(B, C, T_len, spec, sms, &plan)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return mrf_block::launch_block<16, false>(x, w1, b1, w2, b2, out, nullptr, 0, B, T_len, spec, plan, sms, slope, s);
    case 32: return mrf_block::launch_block<32, false>(x, w1, b1, w2, b2, out, nullptr, 0, B, T_len, spec, plan, sms, slope, s);
    default: return mrf_block::launch_block<64, false>(x, w1, b1, w2, b2, out, nullptr, 0, B, T_len, spec, plan, sms, slope, s);
  }
}
