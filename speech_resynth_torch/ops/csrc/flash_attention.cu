// Flash-attention forward (K1) for NVIDIA Hopper, sm_90a.
//
// Replaces: speech_resynth_tpu/ops/attention.py:_flash_kernel, launched by
// _flash_forward. Same function: softmax(Q K^T / sqrt(d)) V per (batch, head)
// with f32 scores and accumulation, an optional key-padding mask (B, N_k) and
// an optional causal mode in which query i sees keys up to i + (N_k - N_q).
// Masked logits take the finite NEG_INF of attention_reference, so a row
// whose keys are all masked gives the mean of V over the N_k keys, exactly as
// the reference does. Keys at or beyond N_k (tile padding) take no part.
//
// What bounds it on this card: at the serving shape (16, 2, 512, 128) bf16
// the work is 4*B*H*N^2*D = 4.3 GFLOP (4.3 us at the 989 TFLOP/s bf16 peak)
// against 16.8 MB of q/k/v/o (5.0 us at 3.35 TB/s): the bytes, barely.
//
// What the design does about that. bf16 (the serving path): one block of 4
// warps per (64-query tile, b*h); each warp owns 16 queries and keeps their Q
// fragments, the running max/sum and the O accumulator in registers. 64-key
// tiles of K (row-major) and V (transposed) are staged in shared memory once
// per block and every product runs on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 accumulate); the probabilities are rounded to bf16 for
// the PV product, as attention_reference rounds them to V's dtype. Q, K and V
// are read from device memory once per query tile and O is written once, so
// the kernel moves little more than the bytes bound; what it leaves on the
// table is wgmma/TMA pipelining (later work). f32 (used by the card-side
// check against the plain version): the same tiling on the CUDA cores.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -0.7f * 3.402823466e38f;  // attention_reference's finite mask value
constexpr int BQ = 64;                 // queries per block
constexpr int BK = 64;                 // keys per shared-memory tile

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// 0 valid, 1 masked (finite NEG_INF), 2 past N_k (no part)
__device__ __forceinline__ int key_flag(const uint8_t* mask, int b, int key, int Nk) {
  return key >= Nk ? 2 : (mask != nullptr && mask[(size_t)b * Nk + key] == 0) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores. 8 warps, 8 queries each, 4 at a time in registers.
// ---------------------------------------------------------------------------

constexpr int F_WARPS = 8;
constexpr int F_THREADS = F_WARPS * 32;
constexpr int F_QPW = BQ / F_WARPS;  // queries per warp
constexpr int F_G = 4;               // queries per register block

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (2 * BQ * (D + 4) + BK * D + F_WARPS * F_G * BK) + sizeof(int) * BK;
}

template <int D>
__global__ void __launch_bounds__(F_THREADS) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ mask, float* __restrict__ o, int H, int Nq, int Nk, int causal, float scale) {
  constexpr int DS = D + 4;    // padded row stride of the Q and K tiles: conflict-free float4 reads
  constexpr int DPL = D / 32;  // output dims owned by each lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x DS
  float* Ks = Qs + BQ * DS;                      // BK x DS
  float* Vs = Ks + BK * DS;                      // BK x D
  float* Ps = Vs + BK * D;                       // F_WARPS x F_G x BK probabilities
  int* kflag = reinterpret_cast<int*>(Ps + F_WARPS * F_G * BK);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int offset = Nk - Nq;
  const float* qb = q + (size_t)bh * Nq * D;
  const float* kb = k + (size_t)bh * Nk * D;
  const float* vb = v + (size_t)bh * Nk * D;

  for (int i = tid; i < BQ * D; i += F_THREADS) {
    const int r = i / D, c = i - r * D;
    Qs[r * DS + c] = (q0 + r < Nq) ? qb[(size_t)(q0 + r) * D + c] : 0.f;
  }

  float m[F_QPW], l[F_QPW], acc[F_QPW][DPL];
#pragma unroll
  for (int s = 0; s < F_QPW; ++s) {
    m[s] = NEG_INF;
    l[s] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[s][e] = 0.f;
  }

  const int n_tiles = (Nk + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed (and the Q tile is written)
    for (int i = tid; i < BK * D; i += F_THREADS) {
      const int r = i / D, c = i - r * D;
      const bool in = k0 + r < Nk;
      Ks[r * DS + c] = in ? kb[(size_t)(k0 + r) * D + c] : 0.f;
      Vs[r * D + c] = in ? vb[(size_t)(k0 + r) * D + c] : 0.f;
    }
    if (tid < BK) kflag[tid] = key_flag(mask, b, k0 + tid, Nk);
    __syncthreads();

    const int flag0 = kflag[lane], flag1 = kflag[lane + 32];
    const int key0 = k0 + lane, key1 = k0 + lane + 32;
#pragma unroll
    for (int g = 0; g < F_QPW / F_G; ++g) {
      const int rbase = warp * F_QPW + g * F_G;
      float s0[F_G], s1[F_G];
#pragma unroll
      for (int qq = 0; qq < F_G; ++qq) s0[qq] = s1[qq] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 ka = *reinterpret_cast<const float4*>(&Ks[lane * DS + d]);
        const float4 kc = *reinterpret_cast<const float4*>(&Ks[(lane + 32) * DS + d]);
#pragma unroll
        for (int qq = 0; qq < F_G; ++qq) {
          const float4 qv = *reinterpret_cast<const float4*>(&Qs[(rbase + qq) * DS + d]);
          s0[qq] += dot4(qv, ka);
          s1[qq] += dot4(qv, kc);
        }
      }
#pragma unroll
      for (int qq = 0; qq < F_G; ++qq) {
        const int slot = g * F_G + qq;
        const int qi = q0 + rbase + qq;
        float a = s0[qq] * scale, c = s1[qq] * scale;
        if (flag0 == 1 || (causal && key0 > qi + offset)) a = NEG_INF;
        if (flag1 == 1 || (causal && key1 > qi + offset)) c = NEG_INF;
        if (flag0 == 2) a = -INFINITY;  // key 0 of every tile is < N_k, so the max stays finite
        if (flag1 == 2) c = -INFINITY;
        const float m_new = fmaxf(m[slot], warp_max(fmaxf(a, c)));
        const float p0 = expf(a - m_new), p1 = expf(c - m_new);
        const float alpha = expf(m[slot] - m_new);
        l[slot] = l[slot] * alpha + warp_sum(p0 + p1);
        m[slot] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[slot][e] *= alpha;
        Ps[(warp * F_G + qq) * BK + lane] = p0;
        Ps[(warp * F_G + qq) * BK + lane + 32] = p1;
      }
      __syncwarp();
#pragma unroll 2
      for (int j = 0; j < BK; j += 4) {
        float4 pv[F_G];
#pragma unroll
        for (int qq = 0; qq < F_G; ++qq) pv[qq] = *reinterpret_cast<const float4*>(&Ps[(warp * F_G + qq) * BK + j]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* vrow = &Vs[(j + jj) * D + lane * DPL];
          float vv[DPL];
          if constexpr (DPL == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow);
            vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(vrow);
            vv[0] = t.x; vv[1] = t.y;
          }
#pragma unroll
          for (int qq = 0; qq < F_G; ++qq) {
            const float p = jj == 0 ? pv[qq].x : jj == 1 ? pv[qq].y : jj == 2 ? pv[qq].z : pv[qq].w;
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[g * F_G + qq][e] += p * vv[e];
          }
        }
      }
      __syncwarp();  // Ps is rewritten by the next register block
    }
  }

#pragma unroll
  for (int s = 0; s < F_QPW; ++s) {
    const int qi = q0 + warp * F_QPW + s;
    if (qi < Nq) {
      const float inv = 1.f / fmaxf(l[s], 1e-30f);
      float* orow = o + ((size_t)bh * Nq + qi) * D + lane * DPL;
#pragma unroll
      for (int e = 0; e < DPL; ++e) orow[e] = acc[s][e] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate). 4 warps x 16 queries.
// ---------------------------------------------------------------------------

constexpr int T_WARPS = 4;
constexpr int T_THREADS = T_WARPS * 32;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

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

template <int D>
constexpr size_t bf16_smem_bytes() {
  return sizeof(bf16) * (BQ * (D + 8) + BK * (D + 8) + D * (BK + 8)) + sizeof(int) * BK;
}

template <int D>
__global__ void __launch_bounds__(T_THREADS) flash_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ mask, bf16* __restrict__ o, int H, int Nq, int Nk, int causal, float scale) {
  constexpr int QS = D + 8;   // row stride (bf16) of the Q and K tiles: conflict-free fragment reads
  constexpr int VS = BK + 8;  // row stride of the transposed V tile
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = BK / 8;
  constexpr int NT_O = D / 8;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // BQ x QS
  bf16* Ks = Qs + BQ * QS;                     // BK x QS
  bf16* Vt = Ks + BK * QS;                     // D x VS (V transposed: [d][key])
  int* kflag = reinterpret_cast<int*>(Vt + D * VS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int offset = Nk - Nq;
  const bf16* qb = q + (size_t)bh * Nq * D;
  const bf16* kb = k + (size_t)bh * Nk * D;
  const bf16* vb = v + (size_t)bh * Nk * D;

  for (int i = tid; i < BQ * VPR; i += T_THREADS) {
    const int r = i / VPR, c = (i - r * VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Nq) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * QS + c) = val;
  }
  __syncthreads();
  const int row0 = warp * 16 + g;  // this thread's query rows: row0 and row0 + 8
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const bf16* p = Qs + row0 * QS + ks * 16 + 2 * t;
    qf[ks][0] = lds32(p);
    qf[ks][1] = lds32(p + 8 * QS);
    qf[ks][2] = lds32(p + 8);
    qf[ks][3] = lds32(p + 8 * QS + 8);
  }
  const int qi[2] = {q0 + row0, q0 + row0 + 8};

  float acc[NT_O][4];
#pragma unroll
  for (int dt = 0; dt < NT_O; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int n_tiles = (Nk + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * VPR; i += T_THREADS) {  // K row-major, coalesced
      const int r = i / VPR, c = (i - r * VPR) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Nk) val = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D + c);
      *reinterpret_cast<uint4*>(Ks + r * QS + c) = val;
    }
    for (int i = tid; i < BK * VPR; i += T_THREADS) {  // V transposed; lanes walk keys: conflict-free stores
      const int r = i % BK, c = (i / BK) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Nk) val = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + c);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * VS + r] = e[j];
    }
    if (tid < BK) kflag[tid] = key_flag(mask, b, k0 + tid, Nk);
    __syncthreads();

    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const bf16* p = Ks + (nt * 8 + g) * QS + ks * 16 + 2 * t;
        mma_bf16(s[nt], qf[ks], lds32(p), lds32(p + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int flag = kflag[col];
        float val = s[nt][e] * scale;
        if (flag == 1 || (causal && k0 + col > qi[e >> 1] + offset)) val = NEG_INF;
        if (flag == 2) val = -INFINITY;  // key 0 of every tile is < N_k, so each row max stays finite
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rowsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rowsum[r];  // this thread's share of the row sum
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {  // P (as the A operand, straight from the S accumulators) x V
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]), pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < NT_O; ++dt) {
        const bf16* p = Vt + (dt * 8 + g) * VS + j * 16 + 2 * t;
        mma_bf16(acc[dt], pa, lds32(p), lds32(p + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= Nq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = o + ((size_t)bh * Nq + qi[r]) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) = pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
  }
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const void* mask, void* o, int B, int H, int Nq,
                int Nk, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((Nq + BQ - 1) / BQ, B * H);
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    constexpr size_t smem = bf16_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16_kernel<D><<<grid, T_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const uint8_t*>(mask), static_cast<bf16*>(o), H, Nq, Nk, causal, scale);
  } else {
    constexpr size_t smem = f32_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_f32_kernel<D><<<grid, F_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const uint8_t*>(mask), static_cast<float*>(o), H, Nq, Nk, causal, scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int srt_flash_attention(const void* q, const void* k, const void* v, const void* mask, void* o,
                                   int B, int H, int Nq, int Nk, int D, int is_bf16, int causal, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Nq <= 0 || Nk <= 0 || B * H <= 0 || B * H > 65535) return cudaErrorInvalidValue;
  if (is_bf16) {
    if (D == 64) return run<bf16, 64>(q, k, v, mask, o, B, H, Nq, Nk, causal, scale, s);
    if (D == 128) return run<bf16, 128>(q, k, v, mask, o, B, H, Nq, Nk, causal, scale, s);
  } else {
    if (D == 64) return run<float, 64>(q, k, v, mask, o, B, H, Nq, Nk, causal, scale, s);
    if (D == 128) return run<float, 128>(q, k, v, mask, o, B, H, Nq, Nk, causal, scale, s);
  }
  return cudaErrorInvalidValue;
}
