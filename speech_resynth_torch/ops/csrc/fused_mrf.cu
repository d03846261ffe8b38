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

// One SAME conv over the whole window on the tensor cores: acc = bias +
// sum_{tap, ci} Wsm[tap][co][ci] * Act[column + tap*d - pad][ci].
template <int C>
__device__ __forceinline__ void conv_tc(const bf16* Wsm, const bf16* __restrict__ bias, int K, int d,
                                        const bf16* Act, int margin, float (&acc)[C / 16][WINDOW_ELEMS / C / 64][4],
                                        int warp, int g, int t) {
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
  const bf16* act_base = Act + (margin - pad + warp * G::NT * 8 + g) * G::AS + 2 * t;
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
        const bf16* p = a_tap + nt * 8 * G::AS + ks * 16;
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
    conv_tc<C>(Wsm, b1 + p * C, K, d, Act, margin, acc, warp, g, t);
    __syncthreads();  // every warp is done reading conv1's input and weights
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {  // conv2 input: lrelu(conv1 + b1), zero outside [0, T)
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = mt * 16 + g + (e >> 1) * 8;
          const int col = warp * G::NT * 8 + nt * 8 + 2 * t + (e & 1);
          const int gp = g0 + col;
          Act[(margin + col) * G::AS + co] = __float2bfloat16((gp >= 0 && gp < T_len) ? lrelu(acc[mt][nt][e], slope) : 0.f);
        }
      }
    }
    stage_weights<C>(Wsm, w2 + (size_t)p * K * C * C, K);
    __syncthreads();
    conv_tc<C>(Wsm, b2 + p * C, K, 1, Act, margin, acc, warp, g, t);
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {  // residual add; each thread owns these elements
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = mt * 16 + g + (e >> 1) * 8;
          const int col = warp * G::NT * 8 + nt * 8 + 2 * t + (e & 1);
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

}  // namespace

// Weights come as (n_pairs, K, C_out, C_in), biases as (n_pairs, C); x and out are (B, C, T).
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
