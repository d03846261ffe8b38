// K3: one fused HiFi-GAN MRF stage for NVIDIA Hopper, sm_90a, every branch
// and their mean in one launch.
//
// Replaces: speech_resynth_tpu/ops/fused_mrf.py:_mrf_stage_kernel, launched by
// mrf_stage_pallas (spec: ops/fused_mrf.py:mrf_stage_reference):
// mean_i(branch_i(x)), each branch's chain carried in f32, the branch outputs
// summed in f32 in branch order, multiplied by 1/n and rounded to x's dtype
// once.
//
// What bounds it on this card: the production stages are three MRF branches
// (K = 3, 7, 11; dilations 1, 3, 5), 12*(3+7+11)*C^2*T*B FLOP (1.0e12 at
// B = 16, C = 64, T = 40 980: 1.0 ms at the bf16 peak) against one read and
// one write of the activation (0.05 ms): the operations, at every stage.
//
// bf16: K2's block (csrc/mrf_block.cuh) with the branch loop and the f32
// branch sum: wgmma with both operands in shared memory, the weights of every
// branch streamed a tap at a time through a TMA ring by a producer warp, each
// conv over the live 64-column M tiles from the branch's own offset, the
// pristine input re-read per branch, the f32 sum in the block's slot of a
// scratch buffer in device memory (one slot an SM: the grid is persistent).
// The C entry plans the tile from B * T and the SM count (srt_mrf_stage_plan
// gives the plan to ops/fused_mrf.py) and sizes the scratch
// (srt_mrf_stage_scratch_floats). So the
// stage reads the activation from device memory once per branch, mostly
// from L2, and writes it once, where the per-branch route (three K2 launches,
// their sum and mean) writes three branch outputs and reads them back.
//
// f32 (the card-side checks, and K2's f32 variant through n_branches = 1): one
// block per time tile and batch row, a window of 16 384 / C columns holding
// the tile and the largest branch halo on each side, channel-major, every
// conv over the whole window on the CUDA cores, one tap's weights staged at a
// time; each thread keeps 4 channels x 16 columns of the branch sum in
// registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mrf_block.cuh"

namespace {

using mrf_block::Spec;
constexpr int THREADS = 256;
constexpr int WINDOW_ELEMS = 16384;  // f32: C * window columns, 64 outputs per thread

__device__ __forceinline__ float lrelu(float x, float slope) { return x > 0.f ? x : x * slope; }

constexpr int RC = 4;   // output channels per thread
constexpr int RT = 16;  // output columns per thread

// One SAME conv on the CUDA cores, channel-major [c][column]: acc = bias +
// sum_{tap, ci} W[tap][co][ci] * A[ci][column + tap*d - pad].
template <int C>
__device__ __forceinline__ void conv_f32(const float* __restrict__ wt,  // (K, C_out, C_in) of this conv
                                         const float* __restrict__ bias, int K, int d, const float* A, int AW,
                                         int margin, float* Wk, float (&acc)[RC][RT], int cg, int tg) {
  constexpr int NTG = THREADS / (C / RC);
  const int pad = (K - 1) * d / 2;
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const float bv = bias[cg * RC + r];
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[r][j] = bv;
  }
  for (int tap = 0; tap < K; ++tap) {
    __syncthreads();  // every thread is done with the previous tap's weights
    for (int i = threadIdx.x; i < C * C; i += THREADS) {
      const int co = i / C, ci = i - co * C;
      Wk[ci * C + co] = wt[(size_t)tap * C * C + i];
    }
    __syncthreads();
    const float* abase = A + margin + tap * d - pad + tg;
    for (int ci = 0; ci < C; ++ci) {
      const float4 wv = *reinterpret_cast<const float4*>(&Wk[ci * C + cg * RC]);
      const float* arow = abase + ci * AW;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const float a = arow[j * NTG];
        acc[0][j] += wv.x * a;
        acc[1][j] += wv.y * a;
        acc[2][j] += wv.z * a;
        acc[3][j] += wv.w * a;
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS) mrf_stage_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out, int T_len, int t_tile,
    const Spec spec, float slope) {
  constexpr int W = WINDOW_ELEMS / C;
  constexpr int NTG = THREADS / (C / RC);
  const int margin = spec.margin;
  const int AW = W + 2 * margin;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // C x W residual chain of the current branch
  float* Wk = xs + C * W;                        // C_in x C_out weights of one tap
  float* A = Wk + C * C;                         // C x AW conv operand, `margin` zero columns each side

  const int tid = threadIdx.x;
  const int cg = tid / NTG, tg = tid % NTG;
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * t_tile - spec.halo_max;  // sequence position of window column 0
  const float* xb = x + (size_t)b * C * T_len;

  for (int i = tid; i < C * 2 * margin; i += THREADS) {
    const int c = i / (2 * margin), m = i - c * 2 * margin;
    A[c * AW + (m < margin ? m : W + m)] = 0.f;
  }

  float acc[RC][RT], sum[RC][RT];
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int j = 0; j < RT; ++j) sum[r][j] = 0.f;

  for (int br = 0; br < spec.n_branches; ++br) {
    const int K = spec.K[br], n_pairs = spec.n_pairs[br];
    __syncthreads();  // every thread has read its part of the previous branch's residual
    for (int i = tid; i < C * W; i += THREADS) {  // the branch starts from the pristine input
      const int c = i / W, col = i - c * W;
      const int g = g0 + col;
      xs[i] = (g >= 0 && g < T_len) ? xb[(size_t)c * T_len + g] : 0.f;
    }
    __syncthreads();
    for (int p = 0; p < n_pairs; ++p) {
      const int d = spec.d[br][p];
      for (int i = tid; i < C * W; i += THREADS) {
        const int c = i / W, col = i - c * W;
        const int g = g0 + col;
        A[c * AW + margin + col] = (g >= 0 && g < T_len) ? lrelu(xs[i], slope) : 0.f;
      }
      __syncthreads();
      conv_f32<C>(w1 + ((size_t)spec.tap_off[br] + p * K) * C * C, b1 + (spec.pair_off[br] + p) * C, K, d, A, AW, margin,
                  Wk, acc, cg, tg);
      __syncthreads();  // every thread is done reading conv1's input
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int col = tg + j * NTG;
        const int g = g0 + col;
        const bool in = g >= 0 && g < T_len;
#pragma unroll
        for (int r = 0; r < RC; ++r) A[(cg * RC + r) * AW + margin + col] = in ? lrelu(acc[r][j], slope) : 0.f;
      }
      conv_f32<C>(w2 + ((size_t)spec.tap_off[br] + p * K) * C * C, b2 + (spec.pair_off[br] + p) * C, K, 1, A, AW, margin,
                  Wk, acc, cg, tg);
      const bool last = p == n_pairs - 1;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int col = tg + j * NTG;
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          float& res = xs[(cg * RC + r) * W + col];
          if (last) {
            sum[r][j] += res + acc[r][j];  // the branch output, into this thread's own sums
          } else {
            res += acc[r][j];
          }
        }
      }
      __syncthreads();  // the residual chain is complete before the next pair reads it
    }
  }

#pragma unroll
  for (int j = 0; j < RT; ++j)
#pragma unroll
    for (int r = 0; r < RC; ++r) xs[(cg * RC + r) * W + tg + j * NTG] = sum[r][j] * spec.inv_n;
  __syncthreads();

  float* ob = out + (size_t)b * C * T_len;
  for (int i = tid; i < C * t_tile; i += THREADS) {
    const int c = i / t_tile, tt = i - c * t_tile;
    const int g = blockIdx.x * t_tile + tt;
    if (g < T_len) ob[(size_t)c * T_len + g] = xs[c * W + spec.halo_max + tt];
  }
}

// f32: the whole-window geometry, as ops/fused_mrf.py:mrf_stage_tile gives it
template <int C>
bool plan_f32(const Spec& spec, mrf_block::Plan* plan) {
  const int window = WINDOW_ELEMS / C, rows = window + 2 * spec.margin;
  const int t_tile = window - 2 * spec.halo_max;
  const long long smem = 4LL * C * (window + C + rows);
  if (t_tile < 32 || smem > mrf_block::MAX_SHARED) return false;
  *plan = {t_tile, window, {0, 0, static_cast<int>(smem)}};
  return true;
}

template <int C>
bool make_plan(int B, int T_len, const Spec& spec, bool bf, int sms, mrf_block::Plan* plan) {
  if (!bf) return plan_f32<C>(spec, plan);
  return mrf_block::plan_block<C, true>(B, T_len, spec, sms, plan);
}

template <int C>
cudaError_t launch_stage(bool bf, const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                         void* out, float* scratch, long long scratch_floats, int B, int T_len, const Spec& spec,
                         int sms, float slope, cudaStream_t stream) {
  mrf_block::Plan plan;
  if (!make_plan<C>(B, T_len, spec, bf, sms, &plan)) return cudaErrorInvalidValue;
  if (bf)
    return mrf_block::launch_block<C, true>(x, w1, b1, w2, b2, out, scratch, scratch_floats, B, T_len, spec, plan, sms,
                                            slope, stream);
  static const cudaError_t attr =
      cudaFuncSetAttribute(mrf_stage_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, mrf_block::MAX_SHARED);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((T_len + plan.t_tile - 1) / plan.t_tile, B);
  mrf_stage_f32_kernel<C><<<grid, THREADS, plan.lay.shared, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out), T_len, plan.t_tile, spec,
      slope);
  return cudaGetLastError();
}

bool checked(int B, int T_len, int n_branches, const int* shapes, Spec* spec) {
  return B > 0 && B <= 65535 && T_len > 0 && mrf_block::make_spec(n_branches, shapes, spec);
}

}  // namespace

// The plan K3 launches with at (B, C, T) on this card: plan[0..3] = t_tile,
// window columns, shared bytes, the SM count it was made for.
extern "C" int srt_mrf_stage_plan(int B, int C, int T_len, int n_branches, const int* shapes, int is_bf16, int* plan) {
  Spec spec;
  if (!checked(B, T_len, n_branches, shapes, &spec)) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = mrf_block::sm_count(&sms);
  if (err != cudaSuccess) return err;
  mrf_block::Plan p;
  const bool bf = is_bf16 != 0;
  bool ok = false;
  switch (C) {
    case 16: ok = make_plan<16>(B, T_len, spec, bf, sms, &p); break;
    case 32: ok = make_plan<32>(B, T_len, spec, bf, sms, &p); break;
    case 64: ok = make_plan<64>(B, T_len, spec, bf, sms, &p); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  plan[0] = p.t_tile;
  plan[1] = p.window;
  plan[2] = p.lay.shared;
  plan[3] = sms;
  return cudaSuccess;
}

// K3. Per branch, `shapes` (host memory) holds K, n_pairs, d0, d1, d2. The
// branches' weights are concatenated in branch order: bf16 each (n_pairs, K,
// C_out, 64), every tap's rows in the 128-byte swizzle
// (ops/fused_mrf.py:swizzled_taps); f32 each (n_pairs, K, C_out, C_in). Their
// (n_pairs, C) biases likewise; x and out are (B, C, T). scratch: the
// branch sums of bf16 with more than one branch, scratch_floats f32, as
// srt_mrf_stage_scratch_floats sizes it (one slot an SM); unused otherwise.
// The tile is planned here.
extern "C" int srt_mrf_stage(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                             void* scratch, long long scratch_floats, int B, int C, int T_len, int n_branches,
                             const int* shapes, int is_bf16, float slope, void* stream) {
  Spec spec;
  if (!checked(B, T_len, n_branches, shapes, &spec)) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = mrf_block::sm_count(&sms);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sums = static_cast<float*>(scratch);
  const bool bf = is_bf16 != 0;
  switch (C) {
    case 16: return launch_stage<16>(bf, x, w1, b1, w2, b2, out, sums, scratch_floats, B, T_len, spec, sms, slope, st);
    case 32: return launch_stage<32>(bf, x, w1, b1, w2, b2, out, sums, scratch_floats, B, T_len, spec, sms, slope, st);
    case 64: return launch_stage<64>(bf, x, w1, b1, w2, b2, out, sums, scratch_floats, B, T_len, spec, sms, slope, st);
    default: return cudaErrorInvalidValue;
  }
}

// The f32 floats of K3's scratch on this card: a [C][tile] sum slot of
// mrf_block::SLOT_FLOATS for each SM, enough for the persistent grid at
// every C and tile.
extern "C" int srt_mrf_stage_scratch_floats(long long* n) {
  int sms = 0;
  const cudaError_t err = mrf_block::sm_count(&sms);
  if (err != cudaSuccess) return err;
  *n = static_cast<long long>(sms) * mrf_block::SLOT_FLOATS;
  return cudaSuccess;
}
