// The bf16 block of the fused HiFi-GAN MRF kernels for NVIDIA Hopper, sm_90a.
// K2 (one branch, csrc/mrf_branch.cu) and K3 (every branch of a stage and
// their mean, csrc/fused_mrf.cu) are two instances of the kernel template
// below: K2 compiles it without the branch loop and the branch sum
// (STAGE = false), K3 with them.
//
// Function (spec: ops/fused_mrf.py mrf_branch_reference, mrf_stage_reference):
// for each branch, for each dilation d of the branch,
//     x += conv_K(lrelu(conv_{K,d}(lrelu(x)) + b1)) + b2
// with SAME padding, every conv input zero outside the true sequence [0, T).
// Each conv's operands are rounded to bf16, products are accumulated in f32,
// the residual chain stays f32; the branch outputs are summed in f32 in
// branch order, multiplied by 1/n in f32, and rounded to bf16 once.
//
// The block (K2: one per time tile and batch row; K3: one per SM, looping
// over them):
// - The products run on wgmma as an implicit GEMM: M = 64 window columns per
//   instruction, N = C_out (16, 32 or 64), 16 input channels deep, looping
//   over taps and channel slices. A tap shifts the operand by tap*d rows,
//   which no 8-row swizzle atom allows. So the operand is kept without
//   swizzle, channel-chunk-major ([C / 8][column][8]): any 8 consecutive
//   columns of a chunk are one 128-byte core matrix, and a tap's shift is
//   the start address of A's descriptor. B, the tap's [C_out][C_in] weights,
//   is K-major in the 128-byte swizzle (ops/fused_mrf.py:swizzled_taps lays
//   them out so, rows padded to 64 channels). With both operands in shared
//   memory no registers wait on a product: a warpgroup issues a tap's
//   products, then waits only for the tap before it.
// - Weights stream a tap at a time through a 4-stage ring of 1-D TMA copies
//   that a producer warp keeps ahead of the products, every tap of every
//   branch in the order the convs use them (126 taps for the production
//   stage). Three consumer warpgroups share each tap, and each holds the
//   accumulators of up to 128 / C M tiles. The biases of every branch are
//   staged in f32 once.
// - The f32 residual lives in shared memory, so each conv's M tiles start
//   where the columns the tile still needs start: [halo_max - rem, halo_max
//   + t_tile + rem), rem the pads of the branch's convs after this one, and
//   a conv runs over ceil(width / 64) tiles, not the window. A tile past the
//   window's end starts at window - 64 and writes only the columns past its
//   predecessor's. Each branch's chain starts at column halo_max - halo_b
//   (the JAX kernel's per-branch offsets), so the K = 3 and K = 7 branches
//   load and compute well under the window.
// - The elementwise work rides on the epilogues, compiled once per conv of a
//   pair: conv1's writes lrelu(acc + b1) into the operand, conv2's adds acc +
//   b2 into the residual and writes the next conv1's operand lrelu(x). x is
//   read (8 channels x 4 columns a thread, every read in flight at once) and
//   the output written in 8-byte pieces where T, the tile and the halos are
//   multiples of 4 (T % 8 is 4 at C = 64, so a row is never 16-byte
//   aligned), else element by element.
// - K3 adds two things. Each branch starts from the pristine input, re-read
//   from device memory (the second and third reads hit L2): no bf16 copy of
//   the window fits beside the residual. Each branch's output over the
//   tile's columns goes into an f32 sum ([C][tile], in a pass of 16-byte
//   pieces after the branch's last conv, so the conv epilogues stay K2's),
//   and the last branch's output is added to the sum, multiplied by 1/n and
//   rounded on its way out. The sum lives in device memory beside K2's
//   window, in a [C][tile] slot of a scratch buffer that belongs to the
//   block: K3's grid is persistent (one block per SM, each looping over
//   time tiles), so the card holds one slot an SM, 24 576 floats each
//   (96 KiB; 13 MB for 132 SMs), which stay in its 50 MB L2. The other
//   design of the A/B in PERF.md, the sum in shared memory beside a
//   narrower window, was the slower at every stage width and is not kept.
//
// Shared memory (bytes, C = 64, K = 3, 7, 11, dilations 1, 3, 5; margin 25),
// of the 232 448 a block may use: 1 024 alignment, 32 768 ring, 64 barriers,
// 1 536 biases a branch, then at K2's window (384 columns, tile 264) 104 448
// residual (384 x 68 x 4) and 55 552 operand ((384 + 50) x 64 x 2): 195 392
// for K2 (K = 11), 198 464 for K3.
//
// What bounds it on this card: the operations, 12 K C^2 T B FLOP per branch
// against one read and one write of the (B, C, T) activation, everywhere
// except K = 3 alone at C = 16 and 32. The tile comes from the C entries'
// plan: the widest window unless B * T gives too few blocks for the card's
// SMs (the B = 1 streaming windows and the continuation); then the narrower
// tile that finishes in the fewest tile steps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace mrf_block {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int NWG = 3;                   // consumer warpgroups
constexpr int CONSUMERS = NWG * 128;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int STAGES = 4;                // weight ring: one tap a stage
constexpr int FIXED_STEPS = 1;           // the plan's cost of a block's store (and of each branch's load), in tile steps
constexpr int LOAD_ITEMS = 2;            // window items (8 reads each) a thread loads: K2's widest window
constexpr int LOAD_BATCH = 8;            // sum reads a thread has in flight
constexpr int MAX_SHARED = 232448;       // dynamic shared memory a block may use on sm_90
constexpr int MAX_BRANCHES = 4;
constexpr int SLOT_FLOATS = 64 * 128 * NWG;  // K3's sum slot: C x K2's widest window, at every C

template <int C>
struct Geo {
  static constexpr int TPW = 128 / C;           // M tiles per warpgroup: 64 accumulators a thread
  static constexpr int W_MAX = 64 * TPW * NWG;  // K2's window columns, 24 576 / C
  static constexpr int XS = C + 4;              // f32 residual row stride [column][channel]
  static constexpr int NACC = C / 2;
  static constexpr int KS = C / 16;             // k16 slices of a tap
  static constexpr int TAP_ELEMS = C * 64;      // one tap's weights, [C_out][64] bf16 swizzled
  static constexpr int TAP_BYTES = TAP_ELEMS * 2;
  static constexpr int BAR_OFF = STAGES * TAP_BYTES;
  static constexpr int BIAS_OFF = BAR_OFF + 2 * STAGES * 8;  // f32 biases [pair][conv][C], every branch's
  static_assert(TAP_BYTES % 1024 == 0, "swizzle atoms stay 1024-byte aligned");
  static_assert(C * W_MAX == SLOT_FLOATS, "a sum slot holds [C][tile] at the widest tile");
  static_assert(C / 8 * (W_MAX / 4) <= LOAD_ITEMS * CONSUMERS, "one fetch loads the widest window");
};

// The branches of one launch. Shapes per branch: K, n_pairs, d0, d1, d2.
struct Spec {
  int n_branches;
  int K[MAX_BRANCHES], n_pairs[MAX_BRANCHES], d[MAX_BRANCHES][3];
  int halo[MAX_BRANCHES];      // the branch's halo: the pads of all its convs
  int pair_off[MAX_BRANCHES];  // pairs of the branches before it: its biases start at pair_off * C
  int tap_off[MAX_BRANCHES];   // taps (per conv) of the branches before it: its weights start at tap_off taps
  int pairs;                   // pairs of every branch
  int halo_max;                // the largest branch halo: window column of the tile's first output
  int margin;                  // the largest conv pad: zero operand rows past both window ends
  float inv_n;                 // 1 / n_branches in f32, as the JAX kernel multiplies
};

// false for shapes the kernels do not take
inline bool make_spec(int n_branches, const int* shapes, Spec* spec) {
  if (n_branches < 1 || n_branches > MAX_BRANCHES) return false;
  *spec = {};
  spec->n_branches = n_branches;
  spec->inv_n = 1.0f / n_branches;
  for (int br = 0; br < n_branches; ++br) {
    const int* s = shapes + 5 * br;
    const int K = s[0], n_pairs = s[1];
    if (K < 1 || K % 2 == 0 || n_pairs < 1 || n_pairs > 3) return false;
    spec->K[br] = K;
    spec->n_pairs[br] = n_pairs;
    spec->pair_off[br] = spec->pairs;
    spec->tap_off[br] = br == 0 ? 0 : spec->tap_off[br - 1] + spec->n_pairs[br - 1] * spec->K[br - 1];
    spec->pairs += n_pairs;
    for (int p = 0; p < n_pairs; ++p) {
      const int d = s[2 + p];
      if (d < 1) return false;
      spec->d[br][p] = d;
      const int pad = (K - 1) * d / 2;
      spec->halo[br] += pad + (K - 1) / 2;
      spec->margin = pad > spec->margin ? pad : spec->margin;
    }
    spec->halo_max = spec->halo[br] > spec->halo_max ? spec->halo[br] : spec->halo_max;
  }
  return true;
}

// Byte offsets from the 1024-aligned base, and the bytes to launch with.
struct Layout {
  int res_off, act_off, shared;
};

struct Plan {
  int t_tile, window;
  Layout lay;
};

inline int round16(int v) { return (v + 15) / 16 * 16; }

// K2's widest window of residual and operand
template <int C>
Layout layout(int margin, int pairs) {
  using G = Geo<C>;
  Layout lay;
  lay.res_off = G::BIAS_OFF + round16(2 * pairs * C * 4);
  lay.act_off = lay.res_off + G::W_MAX * G::XS * 4;
  lay.shared = 1024 + lay.act_off + round16((G::W_MAX + 2 * margin) * C * 2);
  return lay;
}

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

// A branch's window: columns [col0, col0 + n_cols) from sequence position g0
// on, x into the residual (f32) and lrelu(x) into the operand (bf16), zero
// outside [0, T). A work item is 8 channels x 4 columns; a window of at most
// K2's width is LOAD_ITEMS items a thread. fetch_window starts every global
// read (8 bytes each, consecutive lanes on consecutive columns of a channel)
// into registers, so their latencies overlap; store_window then writes per
// column two 16-byte residual pieces and one 16-byte operand row. vec4: g0
// and T are multiples of 4, so a chunk lies wholly inside [0, T) or wholly
// outside.
struct Window {
  int col0, n_cols, g0;
};

template <int C>
__device__ __forceinline__ void fetch_window(const bf16* __restrict__ xb, const Window& win, int T_len, int vec4,
                                             int tid, uint2 (&w)[LOAD_ITEMS][8]) {
  const int n_chunks = (win.n_cols + 3) / 4;
  const int items = C / 8 * n_chunks;
#pragma unroll
  for (int u = 0; u < LOAD_ITEMS; ++u) {
    const int i = tid + u * CONSUMERS;
    const int q = i / n_chunks, gp0 = win.g0 + 4 * (i % n_chunks);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const bf16* src = xb + static_cast<size_t>(8 * q + r) * T_len + gp0;
      w[u][r] = make_uint2(0u, 0u);
      if (i >= items) continue;
      if (vec4) {
        if (gp0 >= 0 && gp0 < T_len) w[u][r] = *reinterpret_cast<const uint2*>(src);
      } else {
        uint32_t h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) h[e] = gp0 + e >= 0 && gp0 + e < T_len ? __bfloat16_as_ushort(src[e]) : 0u;
        w[u][r] = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
      }
    }
  }
}

template <int C>
__device__ __forceinline__ void store_window(const Window& win, float* res, bf16* act, int rows, int margin,
                                             float slope, int tid, const uint2 (&w)[LOAD_ITEMS][8]) {
  using G = Geo<C>;
  const int n_chunks = (win.n_cols + 3) / 4;
  const int items = C / 8 * n_chunks;
#pragma unroll
  for (int u = 0; u < LOAD_ITEMS; ++u) {
    const int i = tid + u * CONSUMERS;
    if (i >= items) continue;
    const int q = i / n_chunks, c4 = 4 * (i % n_chunks);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c4 + e >= win.n_cols) break;
      float f[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t word = e < 2 ? w[u][r].x : w[u][r].y;
        f[r] = __uint_as_float(e % 2 == 0 ? word << 16 : word & 0xffff0000u);
      }
      const int col = win.col0 + c4 + e;
      float4* rdst = reinterpret_cast<float4*>(res + col * G::XS + 8 * q);
      rdst[0] = make_float4(f[0], f[1], f[2], f[3]);
      rdst[1] = make_float4(f[4], f[5], f[6], f[7]);
      *reinterpret_cast<uint4*>(operand_at(act, rows, margin + col, 8 * q)) =  // x is 0 outside [0, T)
          make_uint4(pack_bf16(lrelu(f[0], slope), lrelu(f[1], slope)), pack_bf16(lrelu(f[2], slope), lrelu(f[3], slope)),
                     pack_bf16(lrelu(f[4], slope), lrelu(f[5], slope)), pack_bf16(lrelu(f[6], slope), lrelu(f[7], slope)));
    }
  }
}

enum TileMode { OUT, SET_SUM, ADD_SUM, MEAN_OUT };

// One pass over the tile's n_out columns (window columns [halo, halo +
// n_out)) of the residual: OUT writes it, rounded, to the output; SET_SUM and
// ADD_SUM store it into or add it to K3's f32 sum ([C][stride], the block's
// slot in device memory); MEAN_OUT writes (sum + it) * (1/n), rounded once. The sum
// moves in 16-byte pieces, LOAD_BATCH of them in flight a thread; the output
// in 8-byte pieces where vec4 (t0, T % 4 == 0: the chunk is whole). The mode
// is a template parameter: a pass compiles without the others' registers.
template <int C, TileMode MODE>
__device__ __forceinline__ void tile_pass(const float* res, float* sum, int stride, int halo, int n_out,
                                          bf16* __restrict__ ob, int T_len, int t0, int vec4, float inv_n, int tid) {
  using G = Geo<C>;
  const int chunks = (n_out + 3) / 4;
  const int items = C * 8 * ((chunks + 7) / 8);
  for (int base = tid; base < items; base += LOAD_BATCH * CONSUMERS) {
    float4 s[LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      int c, ch;
      const int i = base + u * CONSUMERS;
      chunk_of<C>(i, c, ch);
      s[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if ((MODE == ADD_SUM || MODE == MEAN_OUT) && i < items && ch < chunks)
        s[u] = *reinterpret_cast<const float4*>(sum + c * stride + 4 * ch);
    }
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      int c, ch;
      const int i = base + u * CONSUMERS;
      chunk_of<C>(i, c, ch);
      if (i >= items || ch >= chunks) continue;
      const float* src = res + (halo + 4 * ch) * G::XS + c;
      float4 v = make_float4(src[0], src[G::XS], src[2 * G::XS], src[3 * G::XS]);
      if (MODE == SET_SUM || MODE == ADD_SUM) {
        if (MODE == ADD_SUM) v = make_float4(s[u].x + v.x, s[u].y + v.y, s[u].z + v.z, s[u].w + v.w);
        *reinterpret_cast<float4*>(sum + c * stride + 4 * ch) = v;
        continue;
      }
      if (MODE == MEAN_OUT)  // the branch outputs summed in branch order, then 1/n
        v = make_float4((s[u].x + v.x) * inv_n, (s[u].y + v.y) * inv_n, (s[u].z + v.z) * inv_n, (s[u].w + v.w) * inv_n);
      bf16* dst = ob + static_cast<size_t>(c) * T_len + t0 + 4 * ch;
      if (vec4) {
        uint2 w;
        w.x = pack_bf16(v.x, v.y);
        w.y = pack_bf16(v.z, v.w);
        *reinterpret_cast<uint2*>(dst) = w;
      } else {
        const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * ch + e < n_out) dst[e] = __float2bfloat16(e4[e]);
      }
    }
  }
}

// One block per time tile and batch row for K2 (STAGE = false); for K3 a
// persistent grid of at most one block per SM, block i taking tiles i, i +
// gridDim.x, ..., with its f32 branch sums in slot i of ``scratch``, [C][t_tile
// rounded up to 4] (unused by K2 and by a one-branch stage).
template <int C, bool STAGE>
__global__ void __launch_bounds__(THREADS, 1) mrf_block_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const bf16* __restrict__ w2, const bf16* __restrict__ b2, bf16* __restrict__ out, float* __restrict__ scratch,
    int B, int T_len, int t_tile, const __grid_constant__ Spec spec, const Layout lay, int vec4, float slope) {
  using G = Geo<C>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
  uint64_t* empty = full + STAGES;
  float* bias_s = reinterpret_cast<float*>(smem + G::BIAS_OFF);
  float* res = reinterpret_cast<float*>(smem + lay.res_off);  // window x XS, the f32 residual chain
  bf16* act = reinterpret_cast<bf16*>(smem + lay.act_off);    // the conv operand, [C / 8][window + 2 margin][8]

  const int n_br = STAGE ? spec.n_branches : 1;
  const int halo = spec.halo_max, margin = spec.margin;
  const int window = t_tile + 2 * halo;
  const int rows = window + 2 * margin;  // operand rows: `margin` zero rows past both window ends
  const int tid = threadIdx.x;
  const int tiles_x = (T_len + t_tile - 1) / t_tile, n_tiles = tiles_x * B;
  // K3: the branch outputs summed over the tile's columns, [C][sum_stride] f32
  const int sum_stride = (t_tile + 3) / 4 * 4;
  float* sum = nullptr;
  if constexpr (STAGE) sum = scratch + static_cast<size_t>(blockIdx.x) * C * sum_stride;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread streams every tap of every tile, in the order the convs use them
    if (tid == CONSUMERS) {
      int item = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int br = 0; br < n_br; ++br) {
          const int K = spec.K[br];
          for (int p = 0; p < spec.n_pairs[br]; ++p)
            for (int conv = 0; conv < 2; ++conv)
              for (int tap = 0; tap < K; ++tap, ++item) {
                const int s = item % STAGES;
                if (item >= STAGES) mbar_wait(&empty[s], ((item / STAGES) - 1) & 1);
                const bf16* src = (conv ? w2 : w1) + static_cast<size_t>(spec.tap_off[br] + p * K + tap) * G::TAP_ELEMS;
                mbar_expect_tx(&full[s], G::TAP_BYTES);
                bulk_load(smem + s * G::TAP_BYTES, src, G::TAP_BYTES, &full[s]);
              }
        }
    }
    return;
  }

  for (int i = tid; i < 2 * spec.pairs * C; i += CONSUMERS) {  // the biases, [pair][conv][C] in f32
    const int pc = i / C, co = i % C;
    bias_s[i] = __bfloat162float(((pc & 1) ? b2 : b1)[(pc >> 1) * C + co]);
  }
  for (int i = tid; i < margin * (C / 2); i += CONSUMERS) {  // zero rows past both window ends
    const int r = i / (C / 2), c2 = (i % (C / 2)) * 2;
    *reinterpret_cast<uint32_t*>(operand_at(act, rows, r, c2)) = 0u;
    *reinterpret_cast<uint32_t*>(operand_at(act, rows, margin + window + r, c2)) = 0u;
  }

  const int wg = warp_uniform(tid / 128), warp = (tid % 128) / 32, lane = tid & 31, g = lane >> 2, t = lane & 3;
  int item = 0;
  // one time tile of one batch row; a lambda, so that K2's one tile a block
  // compiles without the loop around it
  auto run_tile = [&](int tile) {
    const int t0 = (tile % tiles_x) * t_tile;
    const size_t row_off = static_cast<size_t>(tile / tiles_x) * C * T_len;
    const int n_out = min(t_tile, T_len - t0);  // the tile's outputs: window columns [halo, halo + n_out)
    for (int br = 0; br < n_br; ++br) {
      const int K = spec.K[br], n_pairs = spec.n_pairs[br];
      {  // the branch's chain starts at column halo - halo_b, from the pristine input
        const Window win{halo - spec.halo[br], t_tile + 2 * spec.halo[br], t0 - spec.halo[br]};
        uint2 xw[LOAD_ITEMS][8];
        fetch_window<C>(x + row_off, win, T_len, vec4, tid, xw);
        store_window<C>(win, res, act, rows, margin, slope, tid, xw);
      }
      fence_async_shared();
      named_barrier_sync(1, CONSUMERS);

      int rem = spec.halo[br];  // pads of the branch's convs after the current one
      for (int p = 0; p < n_pairs; ++p) {
        const int dp = spec.d[br][p];
#pragma unroll 1
        for (int conv = 0; conv < 2; ++conv) {
          const int dil = conv == 0 ? dp : 1;
          const int pad = (K - 1) * dil / 2;
          rem -= pad;
          // the outputs the tile still needs: [halo - rem, halo + t_tile + rem), in 64-column M tiles;
          // a tile past the window's end starts at window - 64 and writes only the columns past its
          // predecessor's
          const int lo = halo - rem;
          const int n_mt = warp_uniform((t_tile + 2 * rem + 63) / 64);
          const float* bias = bias_s + (2 * (spec.pair_off[br] + p) + conv) * C;
          // one conv's accumulators: the wgmmas read them ("+f"), so declared here they are
          // not live across the window loads and sum passes between branches
          float acc[G::TPW][G::NACC];

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
              if (idx < n_mt) {
                const int start = min(lo + 64 * idx, window - 64);
                const bf16* a0 = operand_at(act, rows, margin + start + tap * dil - pad, 0);
#pragma unroll
                for (int ks = 0; ks < G::KS; ++ks)
                  wgmma_tap<C>(acc[i], noswizzle_desc(a0 + 2 * ks * rows * 8, rows * 16, 128),
                               sw128_desc(wtap + ks * 16, 16, 1024), tap > 0 || ks > 0);
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

          const bool next_conv1 = conv == 1 && p + 1 < n_pairs;
          float2 bv[C / 8];
#pragma unroll
          for (int j = 0; j < C / 8; ++j) bv[j] = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
          // the epilogue, compiled once for each conv of the pair
          auto epilogue = [&](auto conv_c) {
            constexpr int CONV = decltype(conv_c)::value;
#pragma unroll
            for (int i = 0; i < G::TPW; ++i) {
              const int idx = i * NWG + wg;
              if (idx >= n_mt) continue;
              const int own = lo + 64 * idx;
              const int start = min(own, window - 64);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int col = start + warp * 16 + g + 8 * h;
                if (col < own) continue;
                const int gp = t0 - halo + col;
                const bool in = gp >= 0 && gp < T_len;
                bf16* arow = operand_at(act, rows, margin + col, 2 * t);
                float* rrow = res + col * G::XS + 2 * t;
#pragma unroll
                for (int j = 0; j < C / 8; ++j) {
                  const float v0 = acc[i][4 * j + 2 * h] + bv[j].x, v1 = acc[i][4 * j + 2 * h + 1] + bv[j].y;
                  uint32_t* a2 = reinterpret_cast<uint32_t*>(arow + j * rows * 8);
                  if constexpr (CONV == 0) {  // conv2's operand: lrelu(conv1 + b1), zero outside [0, T)
                    *a2 = in ? pack_bf16(lrelu(v0, slope), lrelu(v1, slope)) : 0u;
                  } else {  // the residual add, then the next conv1's operand
                    float2* r2 = reinterpret_cast<float2*>(rrow + 8 * j);
                    float2 r = *r2;
                    r.x += v0;
                    r.y += v1;
                    *r2 = r;
                    if (next_conv1) *a2 = in ? pack_bf16(lrelu(r.x, slope), lrelu(r.y, slope)) : 0u;
                  }
                }
              }
            }
          };
          if (conv == 0)
            epilogue(std::integral_constant<int, 0>{});
          else
            epilogue(std::integral_constant<int, 1>{});
          fence_async_shared();
          named_barrier_sync(1, CONSUMERS);  // the operand and the residual are complete
        }
      }
      if (STAGE && br + 1 < n_br) {  // K3: the branch output into the sum, before the next branch's load
        if (br == 0)
          tile_pass<C, SET_SUM>(res, sum, sum_stride, halo, n_out, out + row_off, T_len, t0, vec4, spec.inv_n, tid);
        else
          tile_pass<C, ADD_SUM>(res, sum, sum_stride, halo, n_out, out + row_off, T_len, t0, vec4, spec.inv_n, tid);
        named_barrier_sync(1, CONSUMERS);
      }
    }
    // the tile's outputs: K2's residual, or K3's sum plus the last branch's output, times 1/n
    if (STAGE && n_br > 1)
      tile_pass<C, MEAN_OUT>(res, sum, sum_stride, halo, n_out, out + row_off, T_len, t0, vec4, spec.inv_n, tid);
    else
      tile_pass<C, OUT>(res, sum, sum_stride, halo, n_out, out + row_off, T_len, t0, vec4, spec.inv_n, tid);
  };
  if constexpr (STAGE) {
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      run_tile(tile);
      named_barrier_sync(1, CONSUMERS);  // the residual is read before the next tile's load writes it
    }
  } else {
    run_tile(blockIdx.x);
  }
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The widest tile of K2's window, unless a narrower tile finishes in fewer
// tile steps: waves of blocks over the card's SMs, times a block's M-tile
// steps per warpgroup over every conv of every branch plus its loads and
// store.
template <int C, bool STAGE>
bool plan_block(int B, int T_len, const Spec& spec, int sms, Plan* plan) {
  using G = Geo<C>;
  const int t_max = G::W_MAX - 2 * spec.halo_max;
  if (t_max < 32) return false;
  const Layout lay = layout<C>(spec.margin, spec.pairs);
  if (lay.shared > MAX_SHARED) return false;
  const int n_br = STAGE ? spec.n_branches : 1;
  auto cost = [&](int t) {
    long long steps = FIXED_STEPS * (n_br + 1);
    for (int br = 0; br < n_br; ++br) {
      int rem = spec.halo[br];
      for (int p = 0; p < spec.n_pairs[br]; ++p)
        for (int conv = 0; conv < 2; ++conv) {
          rem -= (spec.K[br] - 1) * (conv == 0 ? spec.d[br][p] : 1) / 2;
          steps += ceil_div(ceil_div(t + 2 * rem, 64), NWG);
        }
    }
    return ceil_div(static_cast<long long>(B) * ceil_div(T_len, t), sms) * steps;
  };
  const int t_min = 64 - 2 * spec.halo_max > 32 ? 64 - 2 * spec.halo_max : 32;  // the window holds one M tile
  int best = t_max;
  long long best_cost = cost(t_max);
  for (int t = t_max / 4 * 4; t >= t_min; t -= 4) {
    const long long c = cost(t);
    if (c < best_cost) {
      best_cost = c;
      best = t;
    }
  }
  *plan = {best, best + 2 * spec.halo_max, lay};
  return true;
}

// K3 (STAGE): a grid of min(tiles, sms) blocks, and with more than one branch
// ``scratch`` must hold one sum slot a block (scratch_floats floats; the
// caller sizes it with srt_mrf_stage_scratch_floats). K2: a block a tile.
template <int C, bool STAGE>
cudaError_t launch_block(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                         float* scratch, long long scratch_floats, int B, int T_len, const Spec& spec,
                         const Plan& plan, int sms, float slope, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(mrf_block_bf16_kernel<C, STAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SHARED);
  if (attr != cudaSuccess) return attr;
  const long long n_tiles = static_cast<long long>(B) * ceil_div(T_len, plan.t_tile);
  const long long grid = STAGE && n_tiles > sms ? sms : n_tiles;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  if (STAGE && spec.n_branches > 1 &&
      (scratch == nullptr || grid * C * ceil_div(plan.t_tile, 4) * 4 > scratch_floats))
    return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  int vec4 = aligned && T_len % 4 == 0 && plan.t_tile % 4 == 0;  // and every branch's first column, below
  for (int br = 0; br < spec.n_branches; ++br) vec4 = vec4 && spec.halo[br] % 4 == 0;
  mrf_block_bf16_kernel<C, STAGE><<<static_cast<unsigned>(grid), THREADS, plan.lay.shared, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(out), scratch, B, T_len,
      plan.t_tile, spec, plan.lay, vec4, slope);
  return cudaGetLastError();
}

inline cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return err;
}

}  // namespace mrf_block
