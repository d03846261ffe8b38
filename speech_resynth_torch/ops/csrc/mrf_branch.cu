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
// The design, against the three costs of the kernel it replaces (one block
// per time tile with a 256-column window at every C, scalar loads and stores,
// six phases of which none overlapped, a whole conv's weights staged before
// its products, every conv over the whole window, mma.sync):
// - The products run on wgmma as an implicit GEMM: M = 64 window columns per
//   instruction, N = C_out (16, 32 or 64), 16 input channels deep, looping
//   over taps and channel slices. A tap shifts the operand by tap*d rows,
//   which no 8-row swizzle atom allows. So the operand is kept without
//   swizzle, channel-chunk-major ([C / 8][column][8]): any 8 consecutive
//   columns of a chunk are one 128-byte core matrix, and a tap's shift is
//   the start address of A's descriptor. B, the tap's [C_out][C_in] weights,
//   is K-major in the 128-byte swizzle (ops/fused_mrf.py lays them out so,
//   rows padded to 64 channels). With both operands in shared memory no
//   registers wait on a product: a warpgroup issues a tap's products, then
//   waits only for the tap before it, so the tensor cores always hold the
//   next tap's work.
// - Weights stream a tap at a time through a 4-stage ring of 1-D TMA copies
//   that a producer warp keeps ahead of the products (one tap is C * 128
//   bytes, 8 KB at C = 64; a whole conv was 101 KB). Three consumer
//   warpgroups share each tap, and each holds the accumulators of up to
//   128 / C M tiles, so a tap is read from device memory once per block.
// - The space the weights freed goes to a wider window: 24 576 / C columns
//   (384 at C = 64, where the old window was 256), so the recompute at K = 11
//   is 384 / 264 = 1.45x instead of 1.88x; 1.19x and 1.09x at C = 32 and 16.
//   The f32 residual lives in shared memory, so each conv's M tiles start
//   where the columns the tile still needs start (the JAX kernel's shrinking
//   widths, K3's live_lo / live_hi), and a conv runs over ceil(width / 64)
//   tiles, not the window.
// - The elementwise work rides on the epilogues: conv1's writes lrelu(acc +
//   b1) into the operand, conv2's adds acc + b2 into the residual and writes
//   the next conv1's operand lrelu(x). x is read and the output written in
//   8-byte pieces where T, the tile and the halo are multiples of 4 (T % 8 is
//   4 at C = 64, so a row is never 16-byte aligned), else element by element.
// - The tile comes from the C entry (plan_bf16): the widest window
//   unless B * T gives too few blocks for the card's SMs, as the streaming
//   windows and the continuation do at B = 1; then the narrower tile that
//   finishes in the fewest tile steps.
//
// f32 (used only by the card-side checks): K3's f32 kernel with one branch
// (csrc/fused_mrf.cu), whose arithmetic is the one this kernel had before.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// K3 (fused_mrf.cu); K2's f32 variant is its one-branch case
extern "C" int srt_mrf_stage(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                             int B, int C, int T_len, int n_branches, const int* shapes, int t_tile, int is_bf16,
                             float slope, void* stream);

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int NWG = 3;                    // consumer warpgroups
constexpr int CONSUMERS = NWG * 128;
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int STAGES = 4;                 // weight ring: one tap a stage
constexpr int FIXED_STEPS = 2;            // the plan's cost of a block's load and store, in tile steps
constexpr int LOAD_BATCH = 8;             // window loads a thread has in flight
constexpr int MAX_SHARED = 232448;        // dynamic shared memory a block may use on sm_90
constexpr int STAGE_WINDOW_ELEMS = 16384; // K3's window (fused_mrf.cu WINDOW_ELEMS): the f32 variant's

template <int C>
struct Geo {
  static constexpr int TPW = 128 / C;            // M tiles per warpgroup: 64 accumulators a thread
  static constexpr int W_MAX = 64 * TPW * NWG;   // window columns
  static constexpr int XS = C + 4;               // f32 residual row stride [column][channel]
  static constexpr int NACC = C / 2;
  static constexpr int KS = C / 16;              // k16 slices of a tap
  static constexpr int TAP_ELEMS = C * 64;       // one tap's weights, [C_out][64] bf16 swizzled
  static constexpr int TAP_BYTES = TAP_ELEMS * 2;
  static constexpr int BAR_OFF = STAGES * TAP_BYTES;
  static constexpr int BIAS_OFF = BAR_OFF + 2 * STAGES * 8;  // f32 biases [pair][conv][C]
  static constexpr int RES_OFF = BIAS_OFF + 3 * 2 * C * 4;
  static constexpr int ACT_OFF = RES_OFF + W_MAX * XS * 4;
  static size_t smem(int margin) { return 1024 + ACT_OFF + static_cast<size_t>(W_MAX + 2 * margin) * C * 2; }
  static_assert(TAP_BYTES % 1024 == 0, "swizzle atoms stay 1024-byte aligned");
};

struct BranchSpec {
  int K, n_pairs;
  int d[3];
  int halo;    // the pads of all six convs: window column of the tile's first output
  int margin;  // the largest conv pad: zero operand rows past both window ends
};

__device__ __forceinline__ float lrelu(float x, float slope) { return x > 0.f ? x : x * slope; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int C>
__device__ __forceinline__ void wgmma_tap(float (&d)[C / 2], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  if constexpr (C == 64)
    wgmma_m64n64k16_bf16_ss(d, desc_a, desc_b, accumulate);
  else if constexpr (C == 32)
    wgmma_m64n32k16_bf16_ss(d, desc_a, desc_b, accumulate);
  else
    wgmma_m64n16k16_bf16_ss(d, desc_a, desc_b, accumulate);
}

// The conv operand, channel-chunk-major: 8 channels of one column make a
// 16-byte row, and chunk q of all rows lies together, [C / 8][rows][8]. Eight
// consecutive rows are then the 128 contiguous bytes of a no-swizzle wgmma
// core matrix whatever row they start at, so a tap's shift is a descriptor's
// start address.
__device__ __forceinline__ bf16* operand_at(bf16* act, int rows, int row, int c) {
  return act + ((c >> 3) * rows + row) * 8 + (c & 7);
}

// Work item i of the copy loops below: channel c and 4-column chunk ch, lanes
// laid out 8 chunks x 4 channels so that a warp reads 64 contiguous bytes of 4
// rows and its shared-memory accesses spread over the banks.
template <int C>
__device__ __forceinline__ void chunk_of(int i, int& c, int& ch) {
  const int rest = i >> 5;
  c = (rest % (C / 4)) * 4 + ((i >> 3) & 3);
  ch = (rest / (C / 4)) * 8 + (i & 7);
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1) mrf_branch_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const bf16* __restrict__ w2, const bf16* __restrict__ b2, bf16* __restrict__ out, int T_len, int t_tile,
    const BranchSpec spec, int vec4, float slope) {
  using G = Geo<C>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
  uint64_t* empty = full + STAGES;
  float* bias_s = reinterpret_cast<float*>(smem + G::BIAS_OFF);
  float* res = reinterpret_cast<float*>(smem + G::RES_OFF);  // window x XS, the f32 residual chain
  bf16* act = reinterpret_cast<bf16*>(smem + G::ACT_OFF);    // the conv operand, [C / 8][window + 2 margin][8]

  const int K = spec.K, halo = spec.halo, margin = spec.margin;
  const int window = t_tile + 2 * halo;
  const int rows = window + 2 * margin;  // operand rows: `margin` zero rows past both window ends
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * t_tile;
  const int g0 = t0 - halo;  // sequence position of window column 0
  const size_t row_off = static_cast<size_t>(blockIdx.y) * C * T_len;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread streams every tap, in the order the convs use them
    if (tid == CONSUMERS) {
      const int n_items = 2 * spec.n_pairs * K;
      for (int item = 0; item < n_items; ++item) {
        const int s = item % STAGES;
        if (item >= STAGES) mbar_wait(&empty[s], ((item / STAGES) - 1) & 1);
        const int pair = item / (2 * K), conv = (item / K) & 1, tap = item % K;
        const bf16* src = (conv ? w2 : w1) + (static_cast<size_t>(pair) * K + tap) * G::TAP_ELEMS;
        mbar_expect_tx(&full[s], G::TAP_BYTES);
        bulk_load(smem + s * G::TAP_BYTES, src, G::TAP_BYTES, &full[s]);
      }
    }
    return;
  }

  // ---- the window: x into the residual (f32) and lrelu(x) into the operand (bf16).
  // Each thread starts LOAD_BATCH loads before it uses any, so their latencies overlap.
  const bf16* xb = x + row_off;
  const int n_chunks = (window + 3) / 4;
  const int chunk_items = C * 8 * ((n_chunks + 7) / 8);
  for (int base = tid; base < chunk_items; base += LOAD_BATCH * CONSUMERS) {
    float v[LOAD_BATCH][4];
    int cs[LOAD_BATCH], chs[LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int i = base + u * CONSUMERS;
      chunk_of<C>(i, cs[u], chs[u]);
      if (i >= chunk_items) chs[u] = n_chunks;  // no chunk
      const int gp0 = g0 + chs[u] * 4;
      const bf16* src = xb + static_cast<size_t>(cs[u]) * T_len + gp0;
      if (vec4) {  // g0, T % 4 == 0: a chunk lies wholly inside [0, T) or wholly outside
        uint2 w = {0u, 0u};
        if (chs[u] < n_chunks && gp0 >= 0 && gp0 < T_len) w = *reinterpret_cast<const uint2*>(src);
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
        v[u][0] = __low2float(lo), v[u][1] = __high2float(lo), v[u][2] = __low2float(hi), v[u][3] = __high2float(hi);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gp = gp0 + e;
          v[u][e] = chs[u] < n_chunks && gp >= 0 && gp < T_len ? __bfloat162float(src[e]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      if (chs[u] >= n_chunks) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = chs[u] * 4 + e;
        if (col >= window) break;
        res[col * G::XS + cs[u]] = v[u][e];
        *operand_at(act, rows, margin + col, cs[u]) = __float2bfloat16(lrelu(v[u][e], slope));  // x is 0 outside [0, T)
      }
    }
  }
  for (int i = tid; i < 2 * spec.n_pairs * C; i += CONSUMERS) {  // the biases, [pair][conv][C] in f32
    const int pc = i / C, co = i % C;
    bias_s[i] = __bfloat162float(((pc & 1) ? b2 : b1)[(pc >> 1) * C + co]);
  }
  for (int i = tid; i < margin * (C / 2); i += CONSUMERS) {  // zero rows past both window ends
    const int r = i / (C / 2), c2 = (i % (C / 2)) * 2;
    *reinterpret_cast<uint32_t*>(operand_at(act, rows, r, c2)) = 0u;
    *reinterpret_cast<uint32_t*>(operand_at(act, rows, margin + window + r, c2)) = 0u;
  }
  named_barrier_sync(1, CONSUMERS);

  const int wg = warp_uniform(tid / 128), warp = (tid % 128) / 32, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float acc[G::TPW][G::NACC];
  int item = 0;
  int rem = halo;  // pads of the convs after the current one
  for (int p = 0; p < spec.n_pairs; ++p) {
    const int dp = spec.d[p];
#pragma unroll 1
    for (int conv = 0; conv < 2; ++conv) {
      const int dil = conv == 0 ? dp : 1;
      const int pad = (K - 1) * dil / 2;
      rem -= pad;
      // the outputs the tile still needs: [halo - rem, halo + t_tile + rem), in 64-column M tiles;
      // a tile past the window's end starts at window - 64 and writes only the columns past its
      // predecessor's
      const int lo = halo - rem;
      const int n_tiles = warp_uniform((t_tile + 2 * rem + 63) / 64);
      const float* bias = bias_s + (2 * p + conv) * C;

      // one commit group per tap; a tap's weight stage is released once the
      // group after it is in flight and its own has completed, so the tensor
      // cores always hold the next tap's products
      wgmma_fence();
      for (int tap = 0; tap < K; ++tap, ++item) {
        const int s = item % STAGES;
        mbar_wait(&full[s], (item / STAGES) & 1);
        const bf16* wtap = reinterpret_cast<const bf16*>(smem + s * G::TAP_BYTES);
#pragma unroll
        for (int i = 0; i < G::TPW; ++i) {
          const int idx = i * NWG + wg;
          if (idx < n_tiles) {
            const int start = min(lo + 64 * idx, window - 64);
            const bf16* a0 = operand_at(act, rows, margin + start + tap * dil - pad, 0);
#pragma unroll
            for (int ks = 0; ks < G::KS; ++ks)
              wgmma_tap<C>(acc[i], noswizzle_desc(a0 + 2 * ks * rows * 8, rows * 16, 128), sw128_desc(wtap + ks * 16, 16, 1024),
                           tap > 0 || ks > 0);
          }
        }
        wgmma_commit();
        if (tap > 0) {
          wgmma_wait<1>();
          mbar_arrive(&empty[(item - 1) % STAGES]);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < G::TPW; ++i) fence_operands(acc[i]);
      mbar_arrive(&empty[(item - 1) % STAGES]);
      named_barrier_sync(1, CONSUMERS);  // every warpgroup is done reading the operand

      const bool next_conv1 = conv == 1 && p + 1 < spec.n_pairs;
      float2 bv[C / 8];
#pragma unroll
      for (int j = 0; j < C / 8; ++j) bv[j] = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
#pragma unroll
      for (int i = 0; i < G::TPW; ++i) {
        const int idx = i * NWG + wg;
        if (idx >= n_tiles) continue;
        const int own = lo + 64 * idx;
        const int start = min(own, window - 64);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = start + warp * 16 + g + 8 * h;
          if (col < own) continue;
          const int gp = g0 + col;
          const bool in = gp >= 0 && gp < T_len;
#pragma unroll
          for (int j = 0; j < C / 8; ++j) {
            const float v0 = acc[i][4 * j + 2 * h] + bv[j].x, v1 = acc[i][4 * j + 2 * h + 1] + bv[j].y;
            if (conv == 0) {  // conv2's operand: lrelu(conv1 + b1), zero outside [0, T)
              *reinterpret_cast<uint32_t*>(operand_at(act, rows, margin + col, 8 * j + 2 * t)) =
                  in ? pack_bf16(lrelu(v0, slope), lrelu(v1, slope)) : 0u;
            } else {  // the residual add, then the next conv1's operand
              float2* r2 = reinterpret_cast<float2*>(res + col * G::XS + 8 * j + 2 * t);
              float2 r = *r2;
              r.x += v0;
              r.y += v1;
              *r2 = r;
              if (next_conv1)
                *reinterpret_cast<uint32_t*>(operand_at(act, rows, margin + col, 8 * j + 2 * t)) =
                    in ? pack_bf16(lrelu(r.x, slope), lrelu(r.y, slope)) : 0u;
            }
          }
        }
      }
      named_barrier_sync(1, CONSUMERS);  // the operand (and the residual) are complete
    }
  }

  // ---- the tile's outputs: window columns [halo, halo + n_out)
  bf16* ob = out + row_off;
  const int n_out = min(t_tile, T_len - t0);
  const int out_chunks = (n_out + 3) / 4;
  const int out_items = C * 8 * ((out_chunks + 7) / 8);
  for (int i = tid; i < out_items; i += CONSUMERS) {
    int c, ch;
    chunk_of<C>(i, c, ch);
    if (ch >= out_chunks) continue;
    const int tt0 = ch * 4;
    const float* src = res + (halo + tt0) * G::XS + c;
    bf16* dst = ob + static_cast<size_t>(c) * T_len + t0 + tt0;
    if (vec4) {  // t0, T % 4 == 0: the chunk is whole
      uint2 u;
      u.x = pack_bf16(src[0], src[G::XS]);
      u.y = pack_bf16(src[2 * G::XS], src[3 * G::XS]);
      *reinterpret_cast<uint2*>(dst) = u;
    } else {
      for (int e = 0; e < 4 && tt0 + e < n_out; ++e) dst[e] = __float2bfloat16(src[e * G::XS]);
    }
  }
}

// The branch's halo and largest conv pad; false for shapes the kernels do not take.
bool branch_spec(int K, int n_pairs, int d0, int d1, int d2, BranchSpec* spec) {
  if (K < 1 || K % 2 == 0 || n_pairs < 1 || n_pairs > 3) return false;
  *spec = {};
  spec->K = K;
  spec->n_pairs = n_pairs;
  const int d[3] = {d0, d1, d2};
  for (int p = 0; p < n_pairs; ++p) {
    if (d[p] < 1) return false;
    spec->d[p] = d[p];
    const int pad = (K - 1) * d[p] / 2;
    spec->halo += pad + (K - 1) / 2;
    spec->margin = pad > spec->margin ? pad : spec->margin;
  }
  return true;
}

struct Plan {
  int t_tile, window, shared;
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// bf16: the widest tile of the widest window, unless a narrower tile
// finishes in fewer tile steps: waves of blocks over the card's SMs, times a
// block's M-tile steps per warpgroup over its six convs plus its load and
// store. ops/fused_mrf.py:kernel_branch_plan reads the plan made here.
template <int C>
bool plan_bf16(int B, int T_len, const BranchSpec& spec, int sms, Plan* plan) {
  using G = Geo<C>;
  const size_t smem = G::smem(spec.margin);
  const int t_max = G::W_MAX - 2 * spec.halo;
  if (t_max < 32 || smem > MAX_SHARED) return false;
  int pads[6], n = 0;
  for (int p = 0; p < spec.n_pairs; ++p) {
    pads[n++] = (spec.K - 1) * spec.d[p] / 2;
    pads[n++] = (spec.K - 1) / 2;
  }
  auto cost = [&](int t) {
    long long steps = FIXED_STEPS;
    int rem = spec.halo;
    for (int j = 0; j < n; ++j) {
      rem -= pads[j];
      steps += ceil_div(ceil_div(t + 2 * rem, 64), NWG);
    }
    return ceil_div(static_cast<long long>(B) * ceil_div(T_len, t), sms) * steps;
  };
  const int t_min = 64 - 2 * spec.halo > 32 ? 64 - 2 * spec.halo : 32;  // the window holds one M tile
  int best = t_max;
  long long best_cost = cost(t_max);
  for (int t = t_max / 4 * 4; t >= t_min; t -= 4) {
    const long long c = cost(t);
    if (c < best_cost) {
      best_cost = c;
      best = t;
    }
  }
  *plan = {best, best + 2 * spec.halo, static_cast<int>(smem)};
  return true;
}

// f32: K3's one-branch geometry (fused_mrf.cu), as ops/fused_mrf.py:mrf_stage_tile gives it
bool plan_f32(int C, const BranchSpec& spec, Plan* plan) {
  const int window = STAGE_WINDOW_ELEMS / C, rows = window + 2 * spec.margin;
  const int t_tile = window - 2 * spec.halo;
  const long long smem = 4LL * C * (window + C + rows);
  if (t_tile < 32 || smem > MAX_SHARED) return false;
  *plan = {t_tile, window, static_cast<int>(smem)};
  return true;
}

bool make_plan(int B, int C, int T_len, const BranchSpec& spec, bool bf, int sms, Plan* plan) {
  if (!bf) return (C == 16 || C == 32 || C == 64) && plan_f32(C, spec, plan);
  switch (C) {
    case 16: return plan_bf16<16>(B, T_len, spec, sms, plan);
    case 32: return plan_bf16<32>(B, T_len, spec, sms, plan);
    case 64: return plan_bf16<64>(B, T_len, spec, sms, plan);
    default: return false;
  }
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return err;
}

template <int C>
cudaError_t launch_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out, int B,
                        int T_len, const BranchSpec& spec, const Plan& plan, float slope, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(mrf_branch_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SHARED);
  if (attr != cudaSuccess) return attr;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const int vec4 = aligned && T_len % 4 == 0 && plan.t_tile % 4 == 0 && spec.halo % 4 == 0;
  const dim3 grid((T_len + plan.t_tile - 1) / plan.t_tile, B);
  mrf_branch_bf16_kernel<C><<<grid, THREADS, plan.shared, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(out), T_len, plan.t_tile, spec,
      vec4, slope);
  return cudaGetLastError();
}

}  // namespace

// The plan K2 launches with at (B, C, T) on this card: plan[0..3] = t_tile,
// window columns, shared bytes, the SM count it was made for.
extern "C" int srt_mrf_branch_plan(int B, int C, int T_len, int K, int n_pairs, int d0, int d1, int d2, int is_bf16,
                                   int* plan) {
  BranchSpec spec;
  if (B <= 0 || B > 65535 || T_len <= 0 || !branch_spec(K, n_pairs, d0, d1, d2, &spec)) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  Plan p;
  if (!make_plan(B, C, T_len, spec, is_bf16 != 0, sms, &p)) return cudaErrorInvalidValue;
  plan[0] = p.t_tile;
  plan[1] = p.window;
  plan[2] = p.shared;
  plan[3] = sms;
  return cudaSuccess;
}

// x and out (B, C, T). bf16: w1, w2 (n_pairs, K, C_out, 64), each tap's rows
// in the 128-byte swizzle (ops/fused_mrf.py:swizzled_taps); f32: (n_pairs,
// K, C_out, C_in). Biases (n_pairs, C). The tile is planned here.
extern "C" int srt_mrf_branch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                              int B, int C, int T_len, int K, int n_pairs, int d0, int d1, int d2, int is_bf16,
                              float slope, void* stream) {
  BranchSpec spec;
  if (B <= 0 || B > 65535 || T_len <= 0 || !branch_spec(K, n_pairs, d0, d1, d2, &spec)) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  Plan plan;
  if (!make_plan(B, C, T_len, spec, is_bf16 != 0, sms, &plan)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    const int shape[5] = {K, n_pairs, d0, d1, d2};
    return srt_mrf_stage(x, w1, b1, w2, b2, out, B, C, T_len, 1, shape, plan.t_tile, 0, slope, stream);
  }
  switch (C) {
    case 16: return launch_bf16<16>(x, w1, b1, w2, b2, out, B, T_len, spec, plan, slope, s);
    case 32: return launch_bf16<32>(x, w1, b1, w2, b2, out, B, T_len, spec, plan, slope, s);
    default: return launch_bf16<64>(x, w1, b1, w2, b2, out, B, T_len, spec, plan, slope, s);
  }
}
