// K5: the CFM velocity transformer's conv feed-forward for NVIDIA Hopper,
// sm_90a, channels-last.
//
// Replaces no TPU kernel: the JAX package leaves this block to XLA
// (speech_resynth_tpu/models/transformer.py:ConvFeedForward, two
// _conv1d_ntc calls around a SiGLU). It was added because the plain chain
// (models/transformer.py:ConvFeedForward on the "plain chain" route) spends
// most of its time moving bytes, not multiplying: each of the 64 calls of a
// serving batch (16 Euler steps x 4 layers) transposes and pads its input for
// cuDNN, converts NCHW <-> NHWC around each implicit GEMM (the 1 792-wide
// conv1 output twice), adds the biases and computes the SiGLU and the mask in
// separate bf16 passes: ~14 launches and ~1.5 GB a call at (32, 1 024, 256 /
// 896).
//
// Function (spec: ops/conv_ff.py conv_ff_reference), on channels-last
// (B, N, C) activations, with SAME padding (zeros outside [0, N) of each
// batch row):
//     h   = mask * silu(conv3(x, W_gate) + b_gate) * (conv3(x, W_value) + b_value)
//     out = conv3(h, W2) + b2
// Products of bf16 operands are accumulated in f32; the biases, the SiGLU
// and the mask are applied in f32 and h is rounded to bf16 once, where it is
// stored; out is rounded once.
//
// One kernel template, launched twice a call (srt_conv_ff): conv1 with the
// SiGLU / mask epilogue (h, (B, N, I)), then conv2 with the bias epilogue
// (out, (B, N, C)).
// - Each conv is an implicit GEMM: M = B * N frame rows in tiles of 128 that
//   never cross a batch row, K = 3 taps x C_in, N-dim = the output columns in
//   tiles of BN = 256 (the caller's widths are whole tiles: C a multiple of
//   256, I of 128). A k-step is one tap and 64 input channels. Its A tile is the
//   tile's 128 rows shifted by tap - 1, loaded by TMA from a 3-D tensor map
//   (C_in, N, B): rows at -1 and at N or past fill zeros, which is the SAME
//   padding, and a tile never reads the next batch row. The weights are laid
//   out once (ops/conv_ff.py:ff_operands) as a K-major (columns, 3 C_in)
//   matrix, tap-major along K, and conv1's columns in blocks of 128: 64 value
//   channels, then their 64 gate channels. So a thread's accumulators hold
//   each value beside its gate, and the SiGLU needs no exchange.
// - Both operands come by TMA in the 128-byte swizzle into a ring of stages
//   (4 of 48 KiB) that one producer warp keeps ahead; two
//   consumer warpgroups (64 rows each) run m64 x BN x k16 wgmma with both
//   operands in shared memory, one commit group a k-step, each waiting only
//   for the group before. The grid is persistent (one block an SM, tiles i,
//   i + grid, ...): the producer loads the next tile while the consumers run
//   the epilogue, straight from the accumulators to device memory.
//
// What bounds it on this card: the operations. At (32, 1 024, 256 / 896):
// 90.2 GFLOP (conv1) + 45.1 (conv2) = 135 GFLOP, 0.137 ms at 989 TFLOP/s,
// against ~151 MB of x, h (written and read), out and weights, 0.045 ms at
// 3.35 TB/s. The A tile is fetched once per tap (the shifted rows come from
// L2) and each weight tile once per row tile, so the L2 traffic, not the
// device memory's, is what the tile sizes trade against the registers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BM = 128;                  // frame rows a tile: two consumer warpgroups of 64
constexpr int BN = 256;                  // output columns a tile: one m64n256k16 wgmma a warpgroup and k16
constexpr int BK = 64;                   // input channels a k-step: one 128-byte swizzled row
constexpr int TAPS = 3;                  // the conv's kernel size
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int RING_BYTES = 196608;       // the ring's shared memory, of the 232 448 a block may use
constexpr int MAX_SHARED = 232448;

enum Epilogue { SIGLU = 1, BIAS = 0 };

constexpr int A_BYTES = BM * BK * 2;  // [128 rows][64] swizzled
constexpr int B_BYTES = BN * BK * 2;  // [256 columns][64] swizzled
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int STAGES = RING_BYTES / STAGE_BYTES;
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int SHARED = 1024 + BAR_OFF + 2 * STAGES * 8;
constexpr int NACC = BN / 2;  // accumulators a thread: 64 rows x BN over 128 threads
static_assert(STAGE_BYTES % 1024 == 0, "swizzle atoms stay 1024-byte aligned");
static_assert(SHARED <= MAX_SHARED, "the ring fits a block");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + __expf(-g)); }

// One conv of the feed-forward. ta: the input (c_in, N, B) with (64, 128)
// boxes; tb: the laid-out weights (3 c_in, n_cols, 1) with (64, BN) boxes.
// bias: f32 in the weights' column order. out: (B, N, out_cols) bf16, where
// out_cols = n_cols / 2 (SIGLU: h) or n_cols (BIAS). mask: (B, N) bytes or null
// (SIGLU only: a zero byte zeroes the frame's h).
template <int EPI>
__global__ void __launch_bounds__(THREADS, 1) conv_ff_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, const float* __restrict__ bias,
    const uint8_t* __restrict__ mask, bf16* __restrict__ out, int B, int N, int c_in, int n_cols, int out_cols) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int tiles_n = n_cols / BN, tiles_row = (N + BM - 1) / BM;
  const int n_tiles = B * tiles_row * tiles_n;
  const int slices = c_in / BK, k_steps = TAPS * slices;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread loads every k-step of every tile of the block
    if (tid == CONSUMERS) {
      int item = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int nt = tile % tiles_n, mt = tile / tiles_n;
        const int b = mt / tiles_row, n0 = (mt % tiles_row) * BM;
        for (int k = 0; k < k_steps; ++k, ++item) {
          const int s = item % STAGES;
          if (item >= STAGES) mbar_wait(&empty[s], ((item / STAGES) - 1) & 1);
          const int tap = k / slices, c0 = (k % slices) * BK;
          uint8_t* stage = smem + s * STAGE_BYTES;
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load_3d(stage, &ta, &full[s], c0, n0 + tap - 1, b);  // row -1 and rows past N fill zeros
          tma_load_3d(stage + A_BYTES, &tb, &full[s], tap * c_in + c0, nt * BN, 0);
        }
      }
    }
    return;
  }

  const int wg = warp_uniform(tid / 128), warp = (tid % 128) / 32, lane = tid & 31, g = lane >> 2, t = lane & 3;
  int item = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    float acc[NACC];
    // one commit group a k-step; a stage is released once the group after it
    // is in flight and its own has completed
    wgmma_fence();
    for (int k = 0; k < k_steps; ++k, ++item) {
      const int s = item % STAGES;
      mbar_wait(&full[s], (item / STAGES) & 1);
      const bf16* a = reinterpret_cast<const bf16*>(smem + s * STAGE_BYTES) + wg * 64 * BK;
      const bf16* w = reinterpret_cast<const bf16*>(smem + s * STAGE_BYTES + A_BYTES);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_m64n256k16_bf16_ss(acc, sw128_desc(a + ks * 16, 16, 1024), sw128_desc(w + ks * 16, 16, 1024), k > 0 || ks > 0);
      wgmma_commit();
      if (k > 0) {
        wgmma_wait<1>();
        mbar_arrive(&empty[(item - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(&empty[(item - 1) % STAGES]);

    // the epilogue: thread (warp, g, t) holds rows 16 warp + g + 8 h of its
    // warpgroup's 64, columns 8 j + 2 t + {0, 1}
    const int nt = tile % tiles_n, mt = tile / tiles_n;
    const int b = mt / tiles_row, n0 = (mt % tiles_row) * BM;
    const float* bias_t = bias + nt * BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = n0 + wg * 64 + warp * 16 + g + 8 * h;
      if (row >= N) continue;
      const size_t r = static_cast<size_t>(b) * N + row;
      if constexpr (EPI == SIGLU) {
        // columns in blocks of 128: 64 values, then their 64 gates; h's column is the block's half
        const bool valid = mask == nullptr || mask[r] != 0;
        bf16* dst = out + r * out_cols + nt * (BN / 2) + 2 * t;
#pragma unroll
        for (int blk = 0; blk < BN / 128; ++blk) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int jv = 16 * blk + j, jg = jv + 8;
            const float2 bv = *reinterpret_cast<const float2*>(bias_t + 8 * jv + 2 * t);
            const float2 bg = *reinterpret_cast<const float2*>(bias_t + 8 * jg + 2 * t);
            const float v0 = acc[4 * jv + 2 * h] + bv.x, v1 = acc[4 * jv + 2 * h + 1] + bv.y;
            const float g0 = acc[4 * jg + 2 * h] + bg.x, g1 = acc[4 * jg + 2 * h + 1] + bg.y;
            *reinterpret_cast<uint32_t*>(dst + 64 * blk + 8 * j) = valid ? pack_bf16(silu(g0) * v0, silu(g1) * v1) : 0u;
          }
        }
      } else {
        bf16* dst = out + r * out_cols + nt * BN + 2 * t;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 bv = *reinterpret_cast<const float2*>(bias_t + 8 * j + 2 * t);
          *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(acc[4 * j + 2 * h] + bv.x, acc[4 * j + 2 * h + 1] + bv.y);
        }
      }
    }
  }
}

inline cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return err;
}

template <int EPI>
cudaError_t launch(const void* x, const void* w, const float* bias, const uint8_t* mask, void* out, int B, int N,
                   int c_in, int n_cols, int sms, cudaStream_t stream) {
  CUtensorMap ta, tb;
  cudaError_t err = tensor_map_3d(&ta, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, c_in, N, B, BK, BM);
  if (err == cudaSuccess) err = tensor_map_3d(&tb, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, TAPS * c_in, n_cols, 1, BK, BN);
  if (err != cudaSuccess) return err;
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv_ff_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, SHARED);
  if (attr != cudaSuccess) return attr;
  const long long n_tiles = static_cast<long long>(B) * ((N + BM - 1) / BM) * (n_cols / BN);
  if (n_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = n_tiles < sms ? static_cast<int>(n_tiles) : sms;
  const int out_cols = EPI == SIGLU ? n_cols / 2 : n_cols;
  conv_ff_kernel<EPI><<<grid, THREADS, SHARED, stream>>>(ta, tb, bias, mask, static_cast<bf16*>(out), B, N, c_in,
                                                          n_cols, out_cols);
  return cudaGetLastError();
}

}  // namespace

// One conv of K5 on channels-last bf16. x (B, N, c_in), 16-byte aligned;
// w (n_cols, 3 c_in) bf16, tap-major along K (ops/conv_ff.py:ff_operands);
// bias (n_cols) f32 in w's column order; out (B, N, n_cols / 2) with siglu
// (conv1: columns in blocks of 64 values then their 64 gates; mask (B, N)
// bytes or null) or (B, N, n_cols) without (conv2: mask unused). n_cols is
// a multiple of the 256-column tile; the grid is one block an SM at most.
extern "C" int srt_conv_ff(const void* x, const void* w, const void* bias, const void* mask, void* out, int B, int N,
                           int c_in, int n_cols, int siglu, void* stream) {
  if (B < 1 || N < 1 || c_in < BK || c_in % BK != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0) return cudaErrorInvalidValue;
  if (n_cols < BN || n_cols % BN != 0) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const uint8_t* m = siglu ? static_cast<const uint8_t*>(mask) : nullptr;
  if (siglu) return launch<SIGLU>(x, w, b, m, out, B, N, c_in, n_cols, sms, s);
  return launch<BIAS>(x, w, b, m, out, B, N, c_in, n_cols, sms, s);
}
