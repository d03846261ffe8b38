// Fused HiFi-GAN MRF branch (K2) for NVIDIA Hopper, sm_90a.
//
// Replaces: speech_resynth_tpu/ops/fused_mrf.py:_mrf_kernel, launched by
// mrf_branch_pallas. Same function (spec: mrf_branch_reference): for each
// dilation d of the branch,
//     x += conv_K(lrelu(conv_{K,d}(lrelu(x)) + b1)) + b2
// with SAME padding, every conv input zero outside the true sequence [0, T).
// Operands are rounded to the input dtype (bf16 on the serving path) before
// each conv, products are accumulated in f32, and the residual chain is
// carried in f32 across all six convs; the output is in the input dtype.
//
// What bounds it on this card: per launch at B=16, C=64, T=40 980, K=11 the
// six convs are 12*K*C^2*T*B = 3.5e11 FLOP (0.36 ms at the bf16 tensor-core
// peak) against 168 MB of activation in and out (0.05 ms): the operations.
// At C=16, K=3 the bytes bound it instead.
//
// What the design does about that: one block per (time tile, batch row).
// The block loads its tile plus branch_halo(K, dilations) columns on each
// side into shared memory once and runs all six convs there, so the
// activation makes one round trip through device memory per branch instead
// of six. Each conv runs over the whole window (the valid part shrinks by
// the conv's pad at each step; the central t_tile columns stay exact).
// bf16 (the serving path): each conv is an implicit GEMM on the tensor cores
// (mma.sync m16n8k16, f32 accumulate): output channels x window columns x
// (taps x input channels). Activations are held time-major [column][channel]
// so a tap's shift is a row offset, the conv's weights are staged once per
// conv as [tap][C_out][C_in], and each warp keeps its C x (window/8) outputs
// in registers. f32 (used by the card-side check against the plain version):
// the same tiling on the CUDA cores, one tap's weights staged at a time.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int WINDOW_ELEMS = 16384;  // C * window columns: 64 outputs per thread

__device__ __forceinline__ float lrelu(float x, float slope) { return x > 0.f ? x : x * slope; }

__device__ __forceinline__ int pair_dilation(int p, int d0, int d1, int d2) { return p == 0 ? d0 : p == 1 ? d1 : d2; }

// ---------------------------------------------------------------------------
// f32: CUDA cores. Channel-major [c][column]; each thread 4 channels x 16 columns.
// ---------------------------------------------------------------------------

constexpr int RC = 4;   // output channels per thread
constexpr int RT = 16;  // output columns per thread

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
__global__ void __launch_bounds__(THREADS) mrf_branch_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out,
    int T_len, int K, int n_pairs, int d0, int d1, int d2, int t_tile, int halo, int margin, float slope) {
  constexpr int W = WINDOW_ELEMS / C;
  constexpr int NTG = THREADS / (C / RC);
  static_assert(NTG * RT == W, "thread tiling must cover the window");
  const int AW = W + 2 * margin;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // C x W residual chain
  float* Wk = xs + C * W;                        // C_in x C_out weights of one tap
  float* A = Wk + C * C;                         // C x AW conv operand, `margin` zero columns each side

  const int tid = threadIdx.x;
  const int cg = tid / NTG, tg = tid % NTG;
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * t_tile - halo;  // sequence position of window column 0
  const float* xb = x + (size_t)b * C * T_len;

  for (int i = tid; i < C * W; i += THREADS) {
    const int c = i / W, col = i - c * W;
    const int g = g0 + col;
    xs[i] = (g >= 0 && g < T_len) ? xb[(size_t)c * T_len + g] : 0.f;
  }
  for (int i = tid; i < C * 2 * margin; i += THREADS) {
    const int c = i / (2 * margin), m = i - c * 2 * margin;
    A[c * AW + (m < margin ? m : W + m)] = 0.f;
  }
  __syncthreads();

  float acc[RC][RT];
  for (int p = 0; p < n_pairs; ++p) {
    const int d = pair_dilation(p, d0, d1, d2);
    for (int i = tid; i < C * W; i += THREADS) {
      const int c = i / W, col = i - c * W;
      const int g = g0 + col;
      A[c * AW + margin + col] = (g >= 0 && g < T_len) ? lrelu(xs[i], slope) : 0.f;
    }
    __syncthreads();
    conv_f32<C>(w1 + (size_t)p * K * C * C, b1 + p * C, K, d, A, AW, margin, Wk, acc, cg, tg);
    __syncthreads();  // every thread is done reading conv1's input
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int col = tg + j * NTG;
      const int g = g0 + col;
      const bool in = g >= 0 && g < T_len;
#pragma unroll
      for (int r = 0; r < RC; ++r) A[(cg * RC + r) * AW + margin + col] = in ? lrelu(acc[r][j], slope) : 0.f;
    }
    conv_f32<C>(w2 + (size_t)p * K * C * C, b2 + p * C, K, 1, A, AW, margin, Wk, acc, cg, tg);
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int col = tg + j * NTG;
#pragma unroll
      for (int r = 0; r < RC; ++r) xs[(cg * RC + r) * W + col] += acc[r][j];
    }
    __syncthreads();  // the residual chain is complete before the next pair reads it
  }

  float* ob = out + (size_t)b * C * T_len;
  for (int i = tid; i < C * t_tile; i += THREADS) {
    const int c = i / t_tile, tt = i - c * t_tile;
    const int g = blockIdx.x * t_tile + tt;
    if (g < T_len) ob[(size_t)c * T_len + g] = xs[c * W + halo + tt];
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores. Time-major [column][channel]; each warp all C channels
// x window/8 columns, as (C/16) x (window/64) m16n8 accumulator tiles.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t lds32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// c += a * b for one m16n8k16 tile. Fragment layout (g = lane/4, t = lane%4):
// a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]},
// b = {B[2t..][g], B[2t+8..][g]}, c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int C>
struct TcGeometry {
  static constexpr int W = WINDOW_ELEMS / C;  // window columns
  static constexpr int XS = C + 4;            // f32 row stride of the residual buffer [column][channel]
  static constexpr int AS = C + 8;            // bf16 row stride of the operand buffer [column][channel]
  static constexpr int WS = C + 8;            // bf16 row stride of the weights [tap][C_out][C_in]
  static constexpr int MT = C / 16;           // output-channel tiles
  static constexpr int NT = W / 64;           // 8-column tiles per warp (8 warps)
};

// The window's 8-column tile held by a warp's accumulator tile nt. The
// warps' tiles interleave (tile nt*8 + warp), so that when a conv's live
// tiles shrink toward the window's centre (K3) every warp keeps a share.
__device__ __forceinline__ int tile_index(int warp, int nt) { return nt * 8 + warp; }

// One SAME conv on the tensor cores over the window's 8-column tiles
// [lo_tile, hi_tile): acc = bias + sum_{tap, ci} Wsm[tap][co][ci] *
// Act[column + tap*d - pad][ci]. Tiles outside the range keep the bias.
template <int C>
__device__ __forceinline__ void conv_tc(const bf16* Wsm, const bf16* __restrict__ bias, int K, int d,
                                        const bf16* Act, int margin, float (&acc)[C / 16][WINDOW_ELEMS / C / 64][4],
                                        int warp, int g, int t, int lo_tile, int hi_tile) {
  using G = TcGeometry<C>;
  const int pad = (K - 1) * d / 2;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
    const float lo = __bfloat162float(bias[mt * 16 + g]), hi = __bfloat162float(bias[mt * 16 + g + 8]);
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = lo;
      acc[mt][nt][2] = acc[mt][nt][3] = hi;
    }
  }
  const bf16* act_base = Act + (margin - pad + g) * G::AS + 2 * t;
  for (int tap = 0; tap < K; ++tap) {
    const bf16* w_tap = Wsm + (tap * C + g) * G::WS + 2 * t;
    const bf16* a_tap = act_base + tap * d * G::AS;
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks) {
      uint32_t af[G::MT][4];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        const bf16* p = w_tap + mt * 16 * G::WS + ks * 16;
        af[mt][0] = lds32(p);
        af[mt][1] = lds32(p + 8 * G::WS);
        af[mt][2] = lds32(p + 8);
        af[mt][3] = lds32(p + 8 * G::WS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const int tile = tile_index(warp, nt);
        if (tile < lo_tile || tile >= hi_tile) continue;
        const bf16* p = a_tap + tile * 8 * G::AS + ks * 16;
        const uint32_t b0 = lds32(p), b1 = lds32(p + 8);
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
  }
}

template <int C>
__device__ __forceinline__ void stage_weights(bf16* Wsm, const bf16* __restrict__ w, int K) {  // (K, C_out, C_in)
  using G = TcGeometry<C>;
  for (int i = threadIdx.x; i < K * C * C / 8; i += THREADS) {
    const int row = i / (C / 8), c8 = (i - row * (C / 8)) * 8;  // row = tap * C + co
    *reinterpret_cast<uint4*>(Wsm + row * G::WS + c8) = *reinterpret_cast<const uint4*>(w + (size_t)row * C + c8);
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS) mrf_branch_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const bf16* __restrict__ w2, const bf16* __restrict__ b2, bf16* __restrict__ out,
    int T_len, int K, int n_pairs, int d0, int d1, int d2, int t_tile, int halo, int margin, float slope) {
  using G = TcGeometry<C>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);             // W x XS residual chain (f32)
  bf16* Act = reinterpret_cast<bf16*>(xs + G::W * G::XS);  // (W + 2*margin) x AS conv operand
  bf16* Wsm = Act + (G::W + 2 * margin) * G::AS;           // K x C x WS weights of one conv

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * t_tile - halo;  // sequence position of window column 0
  const bf16* xb = x + (size_t)b * C * T_len;
  const bf16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < C * G::W; i += THREADS) {  // global reads walk time: coalesced
    const int c = i / G::W, col = i - c * G::W;
    const int gp = g0 + col;
    xs[col * G::XS + c] = (gp >= 0 && gp < T_len) ? __bfloat162float(xb[(size_t)c * T_len + gp]) : 0.f;
  }
  for (int i = tid; i < 2 * margin * C; i += THREADS) {  // zero rows past both window ends
    const int r = i / C, c = i - r * C;
    Act[(r < margin ? r : G::W + r) * G::AS + c] = zero;
  }

  float acc[G::MT][G::NT][4];
  for (int p = 0; p < n_pairs; ++p) {
    const int d = pair_dilation(p, d0, d1, d2);
    __syncthreads();  // the residual chain and the previous conv's reads are complete
    for (int i = tid; i < G::W * C; i += THREADS) {  // conv1 input: lrelu(x), zero outside [0, T)
      const int col = i / C, c = i - col * C;
      const int gp = g0 + col;
      Act[(margin + col) * G::AS + c] = __float2bfloat16((gp >= 0 && gp < T_len) ? lrelu(xs[col * G::XS + c], slope) : 0.f);
    }
    stage_weights<C>(Wsm, w1 + (size_t)p * K * C * C, K);
    __syncthreads();
    conv_tc<C>(Wsm, b1 + p * C, K, d, Act, margin, acc, warp, g, t, 0, G::W / 8);
    __syncthreads();  // every warp is done reading conv1's input and weights
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {  // conv2 input: lrelu(conv1 + b1), zero outside [0, T)
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = mt * 16 + g + (e >> 1) * 8;
          const int col = tile_index(warp, nt) * 8 + 2 * t + (e & 1);
          const int gp = g0 + col;
          Act[(margin + col) * G::AS + co] = __float2bfloat16((gp >= 0 && gp < T_len) ? lrelu(acc[mt][nt][e], slope) : 0.f);
        }
      }
    }
    stage_weights<C>(Wsm, w2 + (size_t)p * K * C * C, K);
    __syncthreads();
    conv_tc<C>(Wsm, b2 + p * C, K, 1, Act, margin, acc, warp, g, t, 0, G::W / 8);
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {  // residual add; each thread owns these elements
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = mt * 16 + g + (e >> 1) * 8;
          const int col = tile_index(warp, nt) * 8 + 2 * t + (e & 1);
          xs[col * G::XS + co] += acc[mt][nt][e];
        }
      }
    }
  }
  __syncthreads();

  bf16* ob = out + (size_t)b * C * T_len;
  for (int i = tid; i < C * t_tile; i += THREADS) {
    const int c = i / t_tile, tt = i - c * t_tile;
    const int gp = blockIdx.x * t_tile + tt;
    if (gp < T_len) ob[(size_t)c * T_len + gp] = __float2bfloat16(xs[(halo + tt) * G::XS + c]);
  }
}

template <int C>
size_t shared_bytes(bool is_bf16, int K, int margin) {
  using G = TcGeometry<C>;
  if (is_bf16) return sizeof(float) * G::W * G::XS + sizeof(bf16) * ((G::W + 2 * margin) * G::AS + K * C * G::WS);
  return sizeof(float) * (C * G::W + C * C + C * (G::W + 2 * margin));
}

template <int C>
cudaError_t launch(bool is_bf16, const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                   void* out, int B, int T_len, int K, int n_pairs, int d0, int d1, int d2, int t_tile, float slope,
                   cudaStream_t stream) {
  constexpr int W = WINDOW_ELEMS / C;
  const int dil[3] = {d0, d1, d2};
  int halo = 0, margin = 0;
  for (int p = 0; p < n_pairs; ++p) {
    const int pad = (K - 1) * dil[p] / 2;
    halo += pad + (K - 1) / 2;
    margin = pad > margin ? pad : margin;
  }
  if (t_tile <= 0 || t_tile + 2 * halo > W) return cudaErrorInvalidValue;
  const size_t smem = shared_bytes<C>(is_bf16, K, margin);
  const dim3 grid((T_len + t_tile - 1) / t_tile, B);
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(mrf_branch_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    mrf_branch_bf16_kernel<C><<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
        static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(out), T_len, K, n_pairs, d0,
        d1, d2, t_tile, halo, margin, slope);
  } else {
    err = cudaFuncSetAttribute(mrf_branch_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    mrf_branch_f32_kernel<C><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out), T_len, K, n_pairs,
        d0, d1, d2, t_tile, halo, margin, slope);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3: a whole MRF stage, every branch and their mean in one launch.
//
// Replaces: speech_resynth_tpu/ops/fused_mrf.py:_mrf_stage_kernel, launched by
// mrf_stage_pallas (spec: mrf_stage_reference): mean_i(branch_i(x)), each
// branch's chain carried in f32 exactly as K2 carries it, the branch outputs
// summed in f32, multiplied by 1/n and rounded to x's dtype once.
//
// What bounds it on this card: the production stages are K2's three branches
// in one launch, 12*(3+7+11)*C^2*T*B FLOP (1.0e12 at B=16, C=64, T=40 980:
// 1.0 ms at the bf16 peak) against one read and one write of the activation
// (0.05 ms): the operations, at every stage.
//
// What the design does about that: it is K2's block (one time tile of one
// batch row, the tile plus a halo in shared memory, every conv over the whole
// window on the tensor cores in bf16 or the CUDA cores in f32), run once per
// branch, so the stage reads the activation from device memory once and
// writes it once instead of three reads, three branch writes and the
// PyTorch sum. The halo is the largest branch's (60 columns a side for
// K = 11, d = 1,3,5). As in the JAX kernel, a branch's chain starts at
// column halo_max - halo_branch and each conv's width shrinks by its pad:
// a conv computes only the 8-column tiles that the tile's outputs still
// need (halo_max -+ the pads of the branch's remaining convs), which at
// C = 64 skips about a third of the window for the K = 3 and K = 7 branches.
// So that every warp keeps a share of the live tiles, warp w holds the
// tiles w, w + 8, ... (tile_index). The f32 variant
// (checks only) runs every conv over the whole window; the columns it adds
// are never read by the tile's outputs.
//
// Shared memory is where K2's layout does not stretch: at C = 64, K = 11 it
// already takes 215 072 of the 232 448 bytes (f32 residual 256 x 68 x 4 =
// 69 632; bf16 operand (256 + 50) x 72 x 2 = 44 064; bf16 weights of one conv
// 11 x 64 x 72 x 2 = 101 376), so there is no room for a pristine copy of the
// input (69 632) or an f32 branch sum over the tile (136 x 64 x 4 = 34 816).
// K3 keeps K2's layout byte for byte and holds neither: each branch re-reads
// its window from global memory (the second and third reads hit L2), and the
// branch sum lives in registers. Every (column, channel) of the window is
// owned by one thread at the residual add of every conv, the same thread for
// every branch, so that thread adds the branch's final residual to its own
// 64 f32 sums and nobody else touches them. The mean goes back through the
// f32 residual buffer for K2's coalesced copy-out of the central columns.
// ---------------------------------------------------------------------------

constexpr int MAX_BRANCHES = 4;

struct StageSpec {
  int n_branches;
  int K[MAX_BRANCHES];
  int n_pairs[MAX_BRANCHES];
  int dil[MAX_BRANCHES][3];
  long long w_off[MAX_BRANCHES];  // element offset of the branch's (n_pairs, K, C, C) weights in w1 and w2
  int b_off[MAX_BRANCHES];        // element offset of its (n_pairs, C) biases in b1 and b2
  int halo[MAX_BRANCHES];         // the branch's halo: the pads of all its convs
  int halo_max;                   // the largest branch halo: window column of the tile's first output
  int margin;                     // the largest conv pad of any branch: zero operand rows past both window ends
  float inv_n;                    // 1 / n_branches in f32, as the JAX kernel multiplies
};

template <int C>
__global__ void __launch_bounds__(THREADS) mrf_stage_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out, int T_len, int t_tile,
    const StageSpec spec, float slope) {
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
      const int d = spec.dil[br][p];
      for (int i = tid; i < C * W; i += THREADS) {
        const int c = i / W, col = i - c * W;
        const int g = g0 + col;
        A[c * AW + margin + col] = (g >= 0 && g < T_len) ? lrelu(xs[i], slope) : 0.f;
      }
      __syncthreads();
      conv_f32<C>(w1 + spec.w_off[br] + (size_t)p * K * C * C, b1 + spec.b_off[br] + p * C, K, d, A, AW, margin,
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
      conv_f32<C>(w2 + spec.w_off[br] + (size_t)p * K * C * C, b2 + spec.b_off[br] + p * C, K, 1, A, AW, margin,
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

template <int C>
__global__ void __launch_bounds__(THREADS) mrf_stage_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const bf16* __restrict__ w2, const bf16* __restrict__ b2, bf16* __restrict__ out, int T_len, int t_tile,
    const StageSpec spec, float slope) {
  using G = TcGeometry<C>;
  const int margin = spec.margin;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);             // W x XS residual chain of the current branch (f32)
  bf16* Act = reinterpret_cast<bf16*>(xs + G::W * G::XS);  // (W + 2*margin) x AS conv operand
  bf16* Wsm = Act + (G::W + 2 * margin) * G::AS;           // K x C x WS weights of one conv

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * t_tile - spec.halo_max;  // sequence position of window column 0
  const bf16* xb = x + (size_t)b * C * T_len;
  const bf16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < 2 * margin * C; i += THREADS) {  // zero rows past both window ends
    const int r = i / C, c = i - r * C;
    Act[(r < margin ? r : G::W + r) * G::AS + c] = zero;
  }

  float acc[G::MT][G::NT][4], sum[G::MT][G::NT][4];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mt][nt][e] = 0.f;

  // conv outputs the tile's columns still need: halo_max +- the pads of the
  // branch's convs still to come (the JAX kernel's shrinking widths, which
  // start at the per-branch offset halo_max - halo_branch), in 8-column tiles
  auto live_lo = [&](int rem) { return max(0, (spec.halo_max - rem) / 8); };
  auto live_hi = [&](int rem) { return min(G::W / 8, (spec.halo_max + t_tile + rem + 7) / 8); };

  for (int br = 0; br < spec.n_branches; ++br) {
    const int K = spec.K[br], n_pairs = spec.n_pairs[br];
    const bf16* w1b = w1 + spec.w_off[br];
    const bf16* w2b = w2 + spec.w_off[br];
    int rem = spec.halo[br];
    __syncthreads();  // every thread has read its part of the previous branch's residual
    for (int i = tid; i < C * G::W; i += THREADS) {  // the branch starts from the pristine input
      const int c = i / G::W, col = i - c * G::W;
      const int gp = g0 + col;
      xs[col * G::XS + c] = (gp >= 0 && gp < T_len) ? __bfloat162float(xb[(size_t)c * T_len + gp]) : 0.f;
    }
    for (int p = 0; p < n_pairs; ++p) {
      const int d = spec.dil[br][p];
      __syncthreads();  // the residual chain and the previous conv's reads are complete
      for (int i = tid; i < G::W * C; i += THREADS) {  // conv1 input: lrelu(x), zero outside [0, T)
        const int col = i / C, c = i - col * C;
        const int gp = g0 + col;
        Act[(margin + col) * G::AS + c] =
            __float2bfloat16((gp >= 0 && gp < T_len) ? lrelu(xs[col * G::XS + c], slope) : 0.f);
      }
      stage_weights<C>(Wsm, w1b + (size_t)p * K * C * C, K);
      __syncthreads();
      rem -= (K - 1) * d / 2;
      conv_tc<C>(Wsm, b1 + spec.b_off[br] + p * C, K, d, Act, margin, acc, warp, g, t, live_lo(rem), live_hi(rem));
      __syncthreads();  // every warp is done reading conv1's input and weights
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {  // conv2 input: lrelu(conv1 + b1), zero outside [0, T)
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int co = mt * 16 + g + (e >> 1) * 8;
            const int col = tile_index(warp, nt) * 8 + 2 * t + (e & 1);
            const int gp = g0 + col;
            Act[(margin + col) * G::AS + co] =
                __float2bfloat16((gp >= 0 && gp < T_len) ? lrelu(acc[mt][nt][e], slope) : 0.f);
          }
        }
      }
      stage_weights<C>(Wsm, w2b + (size_t)p * K * C * C, K);
      __syncthreads();
      rem -= (K - 1) / 2;
      conv_tc<C>(Wsm, b2 + spec.b_off[br] + p * C, K, 1, Act, margin, acc, warp, g, t, live_lo(rem), live_hi(rem));
      const bool last = p == n_pairs - 1;
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {  // residual add; each thread owns these elements
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int co = mt * 16 + g + (e >> 1) * 8;
            const int col = tile_index(warp, nt) * 8 + 2 * t + (e & 1);
            float& res = xs[col * G::XS + co];
            if (last) {
              sum[mt][nt][e] += res + acc[mt][nt][e];  // the branch output, into this thread's own sums
            } else {
              res += acc[mt][nt][e];
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = mt * 16 + g + (e >> 1) * 8;
        const int col = tile_index(warp, nt) * 8 + 2 * t + (e & 1);
        xs[col * G::XS + co] = sum[mt][nt][e] * spec.inv_n;
      }
  __syncthreads();

  bf16* ob = out + (size_t)b * C * T_len;
  for (int i = tid; i < C * t_tile; i += THREADS) {
    const int c = i / t_tile, tt = i - c * t_tile;
    const int gp = blockIdx.x * t_tile + tt;
    if (gp < T_len) ob[(size_t)c * T_len + gp] = __float2bfloat16(xs[(spec.halo_max + tt) * G::XS + c]);
  }
}

template <int C>
cudaError_t launch_stage(bool is_bf16, const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                         void* out, int B, int T_len, int t_tile, int k_max, const StageSpec& spec, float slope,
                         cudaStream_t stream) {
  constexpr int W = WINDOW_ELEMS / C;
  if (t_tile <= 0 || t_tile + 2 * spec.halo_max > W) return cudaErrorInvalidValue;
  const size_t smem = shared_bytes<C>(is_bf16, k_max, spec.margin);  // K2's layout, sized for the widest branch
  const dim3 grid((T_len + t_tile - 1) / t_tile, B);
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(mrf_stage_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    mrf_stage_bf16_kernel<C><<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
        static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(out), T_len, t_tile, spec,
        slope);
  } else {
    err = cudaFuncSetAttribute(mrf_stage_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    mrf_stage_f32_kernel<C><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out), T_len, t_tile, spec,
        slope);
  }
  return cudaGetLastError();
}

}  // namespace

// K3. Per branch, `shapes` (host memory) holds K, n_pairs, d0, d1, d2. The
// branches' weights are concatenated, each (n_pairs, K, C_out, C_in), and so
// are their (n_pairs, C) biases; x and out are (B, C, T).
extern "C" int srt_mrf_stage(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                             int B, int C, int T_len, int n_branches, const int* shapes, int t_tile, int is_bf16,
                             float slope, void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || n_branches < 1 || n_branches > MAX_BRANCHES) return cudaErrorInvalidValue;
  StageSpec spec = {};
  spec.n_branches = n_branches;
  spec.inv_n = 1.0f / n_branches;
  long long w_off = 0;
  int b_off = 0, k_max = 0;
  for (int br = 0; br < n_branches; ++br) {
    const int* s = shapes + 5 * br;
    const int K = s[0], n_pairs = s[1];
    if (K < 1 || K % 2 == 0 || n_pairs < 1 || n_pairs > 3) return cudaErrorInvalidValue;
    spec.K[br] = K;
    spec.n_pairs[br] = n_pairs;
    spec.w_off[br] = w_off;
    spec.b_off[br] = b_off;
    w_off += (long long)n_pairs * K * C * C;
    b_off += n_pairs * C;
    k_max = K > k_max ? K : k_max;
    int halo = 0;
    for (int p = 0; p < n_pairs; ++p) {
      const int d = s[2 + p];
      if (d < 1) return cudaErrorInvalidValue;
      spec.dil[br][p] = d;
      const int pad = (K - 1) * d / 2;
      halo += pad + (K - 1) / 2;
      spec.margin = pad > spec.margin ? pad : spec.margin;
    }
    spec.halo[br] = halo;
    spec.halo_max = halo > spec.halo_max ? halo : spec.halo_max;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  switch (C) {
    case 16: return launch_stage<16>(bf, x, w1, b1, w2, b2, out, B, T_len, t_tile, k_max, spec, slope, st);
    case 32: return launch_stage<32>(bf, x, w1, b1, w2, b2, out, B, T_len, t_tile, k_max, spec, slope, st);
    case 64: return launch_stage<64>(bf, x, w1, b1, w2, b2, out, B, T_len, t_tile, k_max, spec, slope, st);
    default: return cudaErrorInvalidValue;
  }
}

// K2. Weights come as (n_pairs, K, C_out, C_in), biases as (n_pairs, C); x and out are (B, C, T).
extern "C" int srt_mrf_branch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                              void* out, int B, int C, int T_len, int K, int n_pairs, int d0, int d1, int d2,
                              int t_tile, int is_bf16, float slope, void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || K % 2 == 0 || n_pairs < 1 || n_pairs > 3) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  switch (C) {
    case 16: return launch<16>(bf, x, w1, b1, w2, b2, out, B, T_len, K, n_pairs, d0, d1, d2, t_tile, slope, s);
    case 32: return launch<32>(bf, x, w1, b1, w2, b2, out, B, T_len, K, n_pairs, d0, d1, d2, t_tile, slope, s);
    case 64: return launch<64>(bf, x, w1, b1, w2, b2, out, B, T_len, K, n_pairs, d0, d1, d2, t_tile, slope, s);
    default: return cudaErrorInvalidValue;
  }
}
