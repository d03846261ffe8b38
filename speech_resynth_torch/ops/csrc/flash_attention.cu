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
// What bounds it on this card: at the resynthesis decoder's shape
// (16, 2, 1 499, 128) bf16, with 399-499 valid keys a row, the bytes it must
// move (q and o, 24.6 MB, plus the K and V rows of the valid keys, ~7.4 MB:
// ~9.5 us at 3.35 TB/s) and the products a row's mask leaves (4 * H * D per
// allowed (query, key) pair: ~11 GFLOP, ~11 us at 989 TFLOP/s) are of one
// size: a kernel that does only that work is near both bounds.
//
// What the design does about that.
// 1. Tile skipping. Before its key loop, each block scans its batch row's
//    mask once (16-byte loads) into per-key flags in shared memory and lists
//    the 64-key tiles it must visit: those holding a valid key, and in causal
//    mode only those at or below its last query's diagonal. Skipping is exact:
//    once a row has seen a valid allowed key, a wholly masked tile's
//    probabilities are exp(NEG_INF - m) = 0 in f32, and a masked tile seen
//    before it is wiped by alpha = exp(NEG_INF - m) = 0. A block in which some
//    query has no valid allowed key (no valid key at all, or, causal, the first
//    valid key past q0 + offset) visits every tile, so that its row stays the
//    uniform mean over all N_k keys. The resynthesis batches are padded to
//    30 s with 8-10 s of speech, so two thirds of their key tiles go.
//    One difference from the reference follows: a NaN or inf in the K or V
//    row of a masked key reaches the output only where its tile is visited
//    (0 * NaN), while the reference, which reads every key, always passes it
//    on. Finite inputs give the same result either way.
//    The flags and lists take 76 bytes of shared memory per 64-key tile, so
//    N_k is bounded (ops/attention.py:MAX_KEYS); above ~14k keys at d = 128
//    a second block no longer fits on an SM.
// 2. bf16 (the decoder, HuBERT and the LM): warp specialised. The block's Q
//    tile is loaded once, while the mask is scanned; one producer warp streams
//    the live K and V tiles with TMA (3-D tensor maps (D, N, B*H), so rows
//    past N fill zeros) into two rings of shared-memory stages, one for K and
//    one for V, guarded by mbarriers, K requested ahead of V so that no copy waits
//    behind one whose stage is still busy. The consumer warpgroup (64 queries)
//    runs S = Q K^T as wgmma with both operands in shared memory (K-major,
//    128-byte swizzle), the online softmax on the S registers, and O += P V as
//    wgmma with P from registers (rounded to bf16, as the reference rounds the
//    probabilities to V's dtype) and V read MN-major straight from its TMA
//    tile: no transpose. The softmax works in log2 units (one FFMA and one
//    ex2 an element) and tests each key only in a tile that holds a masked
//    key, a key past N_k or a causal diagonal. One consumer warpgroup a block,
//    two blocks an SM: measured faster at every path shape than blocks of two
//    warpgroups (128 queries), whose registers allow one block an SM.
//    Control flow around wgmma is warp-uniform to ptxas (mbarrier waits loop
//    inside their asm, loop bounds are broadcast from lane 0): otherwise it
//    serializes every wgmma (C7520).
// 3. f32 (the card-side checks against the plain version): the CUDA cores,
//    one block of 8 warps per 64 queries, over the same tile list.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;
constexpr float NEG_INF = -0.7f * 3.402823466e38f;  // attention_reference's finite mask value
constexpr int BK = 64;                              // keys per tile

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

// 2^x in one MUFU instruction (ex2.approx; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// ---------------------------------------------------------------------------
// The block's key tiles. Shared memory: live (n_tiles ints), holes (n_tiles
// ints), list (n_tiles ints), scratch (4 ints), flags (n_tiles * BK bytes: 0
// valid, 1 masked (finite NEG_INF), 2 past N_k (no part)).
// ---------------------------------------------------------------------------

__host__ __device__ constexpr size_t tile_list_bytes(int Nk) {
  return static_cast<size_t>((Nk + BK - 1) / BK) * (3 * sizeof(int) + BK) + 4 * sizeof(int);
}

struct TileList {
  const int* list;     // the tiles to visit, in order
  const int* holes;    // per tile (indexed by tile, not by visit): some key is masked or past N_k
  const uint8_t* flags;
  int n;
};

// Called by every thread of the block (it holds __syncthreads). Queries
// [q0, q0 + q_rows) of batch row b.
__device__ TileList build_tile_list(const uint8_t* __restrict__ mask, int b, int Nq, int Nk, int q0, int q_rows,
                                    int causal, uint8_t* smem) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int n_tiles = (Nk + BK - 1) / BK;
  int* live = reinterpret_cast<int*>(smem);
  int* holes = live + n_tiles;
  int* list = holes + n_tiles;
  int* scratch = list + n_tiles;
  uint8_t* flags = reinterpret_cast<uint8_t*>(scratch + 4);
  for (int i = tid; i < n_tiles; i += nthr) {
    live[i] = 0;
    holes[i] = i == n_tiles - 1 && Nk % BK != 0;
  }
  for (int i = Nk + tid; i < n_tiles * BK; i += nthr) flags[i] = 2;
  if (tid == 0) scratch[0] = Nk;
  __syncthreads();

  int first = Nk;  // this thread's first valid key
  auto mark = [&](int key, uint32_t byte) {
    flags[key] = byte ? 0 : 1;
    if (byte) {
      live[key / BK] = 1;
      first = min(first, key);
    } else {
      holes[key / BK] = 1;
    }
  };
  if (mask == nullptr) {
    for (int i = tid; i < Nk; i += nthr) mark(i, 1u);
  } else {
    const uint8_t* row = mask + static_cast<size_t>(b) * Nk;
    const int head = min(Nk, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15));
    const int nvec = (Nk - head) / 16;
    for (int i = tid; i < head; i += nthr) mark(i, row[i]);
    for (int v = tid; v < nvec; v += nthr) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + head + 16 * v);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) mark(head + 16 * v + j, (words[j >> 2] >> (8 * (j & 3))) & 0xffu);
    }
    for (int i = head + 16 * nvec + tid; i < Nk; i += nthr) mark(i, row[i]);
  }
  first = __reduce_min_sync(0xffffffffu, first);
  if ((tid & 31) == 0) atomicMin(&scratch[0], first);
  __syncthreads();

  first = scratch[0];
  const int offset = Nk - Nq;
  const int q_last = min(q0 + q_rows, Nq) - 1;
  // some query of the block has no valid allowed key: visit everything
  const bool full = first >= Nk || (causal && first > q0 + offset);
  if (tid < 32) {
    int count = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const int t = base + tid;
      const bool keep = t < n_tiles && (full || (live[t] && (!causal || t * BK <= q_last + offset)));
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) list[count + __popc(ballot & ((1u << tid) - 1u))] = t;
      count += __popc(ballot);
    }
    if (tid == 0) scratch[1] = count;
  }
  __syncthreads();
  return {list, holes, flags, scratch[1]};
}

// ---------------------------------------------------------------------------
// f32: CUDA cores. 8 warps, 8 queries each, 4 at a time in registers.
// ---------------------------------------------------------------------------

constexpr int BQ_F = 64;  // queries per f32 block
constexpr int F_WARPS = 8;
constexpr int F_THREADS = F_WARPS * 32;
constexpr int F_QPW = BQ_F / F_WARPS;  // queries per warp
constexpr int F_G = 4;                 // queries per register block

template <int D>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (2 * BQ_F * (D + 4) + BK * D + F_WARPS * F_G * BK);
}

template <int D>
__global__ void __launch_bounds__(F_THREADS) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ mask, float* __restrict__ o, int H, int Nq, int Nk, int causal, float scale) {
  constexpr int DS = D + 4;    // padded row stride of the Q and K tiles: conflict-free float4 reads
  constexpr int DPL = D / 32;  // output dims owned by each lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ_F x DS
  float* Ks = Qs + BQ_F * DS;                    // BK x DS
  float* Vs = Ks + BK * DS;                      // BK x D
  float* Ps = Vs + BK * D;                       // F_WARPS x F_G x BK probabilities

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BQ_F;
  const int offset = Nk - Nq;
  const float* qb = q + (size_t)bh * Nq * D;
  const float* kb = k + (size_t)bh * Nk * D;
  const float* vb = v + (size_t)bh * Nk * D;

  const TileList tiles = build_tile_list(mask, b, Nq, Nk, q0, BQ_F, causal,
                                         reinterpret_cast<uint8_t*>(smem4) + f32_smem_bytes<D>());

  for (int i = tid; i < BQ_F * D; i += F_THREADS) {
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

  for (int it = 0; it < tiles.n; ++it) {
    const int k0 = tiles.list[it] * BK;
    __syncthreads();  // the previous tile is consumed (and the Q tile is written)
    for (int i = tid; i < BK * D; i += F_THREADS) {
      const int r = i / D, c = i - r * D;
      const bool in = k0 + r < Nk;
      Ks[r * DS + c] = in ? kb[(size_t)(k0 + r) * D + c] : 0.f;
      Vs[r * D + c] = in ? vb[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    const int flag0 = tiles.flags[k0 + lane], flag1 = tiles.flags[k0 + lane + 32];
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
// bf16: TMA + wgmma, one consumer warpgroup and one producer warp.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
struct Bf16Layout {
  static constexpr int BQ = 64;                            // queries per block: one consumer warpgroup
  // ring depths: V waits on P V, the last use of a tile, so its ring is the deeper
  static constexpr int K_STAGES = D == 128 ? 2 : 3;
  static constexpr int V_STAGES = D == 128 ? 3 : 4;
  static constexpr int MIN_BLOCKS = 2;                     // blocks per SM the registers are sized for
  static constexpr int THREADS = 128 + 32;                 // the consumer warpgroup, then the producer warp
  static constexpr int Q_BYTES = BQ * D * 2;               // [D/64][BQ][64] swizzled
  static constexpr int TILE_BYTES = BK * D * 2;            // one K or V tile, [D/64][BK][64] swizzled
  static constexpr int V_OFF = Q_BYTES + K_STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = V_OFF + V_STAGES * TILE_BYTES;
  // barriers: Q, then full and empty of the K ring, then of the V ring
  static constexpr int LIST_OFF = BAR_OFF + 8 * (1 + 2 * K_STAGES + 2 * V_STAGES);
  static size_t smem_bytes(int Nk) { return 1024 + LIST_OFF + tile_list_bytes(Nk); }
};

// wgmma m64 x D x k16 with P from registers and V MN-major
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2], const uint32_t (&pa)[4], uint64_t dv) {
  if constexpr (D == 128)
    wgmma_m64n128k16_bf16_rs(acc, pa, dv, 1);
  else
    wgmma_m64n64k16_bf16_rs(acc, pa, dv, 1);
}

template <int D>
__global__ void __launch_bounds__(Bf16Layout<D>::THREADS, Bf16Layout<D>::MIN_BLOCKS) flash_fwd_bf16_kernel(
    __grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
    __grid_constant__ const CUtensorMap tv, const uint8_t* __restrict__ mask, bf16* __restrict__ o, int H, int Nq,
    int Nk, int causal, float scale) {
  using L = Bf16Layout<D>;
  constexpr int BQ = L::BQ, KST = L::K_STAGES, VST = L::V_STAGES, HALVES = D / 64, NACC = D / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  // K and V have rings of their own: a K stage is free once Q K^T has read
  // it, long before the P V product that holds the V stage of the same tile
  uint64_t* full_k = qbar + 1;
  uint64_t* empty_k = full_k + KST;
  uint64_t* full_v = empty_k + KST;
  uint64_t* empty_v = full_v + VST;
  auto k_stage = [&](int it) { return reinterpret_cast<bf16*>(smem + L::Q_BYTES + (it % KST) * L::TILE_BYTES); };
  auto v_stage = [&](int it) { return reinterpret_cast<bf16*>(smem + L::V_OFF + (it % VST) * L::TILE_BYTES); };

  const int tid = threadIdx.x;
  const int warp_id = warp_uniform(tid / 32);
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int offset = Nk - Nq;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < KST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&empty_k[s], 128);
    }
    for (int s = 0; s < VST; ++s) {
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], 128);
    }
    mbar_fence_init();
    // the Q tile does not depend on the key tiles: its load overlaps the mask scan
    mbar_expect_tx(qbar, L::Q_BYTES);
    for (int h = 0; h < HALVES; ++h) tma_load_3d(Qs + h * BQ * 64, &tq, qbar, h * 64, q0, bh);
  }
  const TileList tiles = build_tile_list(mask, b, Nq, Nk, q0, BQ, causal, smem + L::LIST_OFF);
  const int n = warp_uniform(tiles.n);

  if (warp_id == 4) {  // the producer warp: one thread starts every copy
    // The consumers free K stage j in step j - 1 (once Q K^T of tile j is
    // read) and V stage j at the end of step j (once P V is done). K runs
    // LEAD tiles ahead of V in the request order, so that every blocking wait is
    // on a release that comes after the one before it: no copy waits behind
    // another whose stage is not free yet.
    constexpr int LEAD = KST - VST + 1;
    static_assert(LEAD >= 0, "the V ring is at most one stage deeper than the K ring");
    if (tid == 128) {
      for (int i = 0; i < n + LEAD; ++i) {
        if (i < n) {
          if (i >= KST) mbar_wait(&empty_k[i % KST], ((i / KST) - 1) & 1);
          mbar_expect_tx(&full_k[i % KST], L::TILE_BYTES);
          bf16* Kst = k_stage(i);
          for (int h = 0; h < HALVES; ++h) tma_load_3d(Kst + h * BK * 64, &tk, &full_k[i % KST], h * 64, tiles.list[i] * BK, bh);
        }
        const int j = i - LEAD;
        if (j >= 0) {
          if (j >= VST) mbar_wait(&empty_v[j % VST], ((j / VST) - 1) & 1);
          mbar_expect_tx(&full_v[j % VST], L::TILE_BYTES);
          bf16* Vst = v_stage(j);
          for (int h = 0; h < HALVES; ++h) tma_load_3d(Vst + h * BK * 64, &tv, &full_v[j % VST], h * 64, tiles.list[j] * BK, bh);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: queries q0 .. q0 + 63
  const int warp = tid / 32, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;  // this thread's query rows: row0 and row0 + 8
  const int qi[2] = {q0 + row0, q0 + row0 + 8};

  float acc[NACC], sc[32];  // O, and S (then P) of the current key tile
  uint32_t pa[BK / 16][4];   // P as bf16 A fragments, read by the P V wgmma in flight
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  // the running max m is kept in log2 units of the scaled scores, so that an
  // exponent is one FFMA and one ex2; a masked score is NEG_INF in those units,
  // which is all the reference's rule needs: it is one constant far below
  // every valid score, and a row of nothing else is uniform
  const float scale_log2 = scale * 1.4426950408889634f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};

  // S = Q K^T of key tile ``it``: 64 queries x 64 keys, D / 16 steps of k16 (started, not waited)
  auto mma_s = [&](int it) {
    mbar_wait(&full_k[it % KST], (it / KST) & 1);
    const bf16* Kst = k_stage(it);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int h = ks / 4, kk = (ks % 4) * 16;  // 64-column half and element column in it
      const uint64_t da = sw128_desc(Qs + h * BQ * 64 + kk, 16, 1024);
      const uint64_t db = sw128_desc(Kst + h * BK * 64 + kk, 16, 1024);
      wgmma_m64n64k16_bf16_ss(sc, da, db, ks > 0);
    }
    wgmma_commit();
    fence_operands(sc);
  };

  // the new running max of both rows from this tile's max mx, and alpha, the
  // factor that rescales what came before
  auto update_max = [&](float (&mx)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
    }
  };

  // S of key tile ``it`` into P in place, with the running max and sum;
  // alpha rescales O once the P V product before it is done
  auto softmax = [&](int it) {
    const int tile = warp_uniform(tiles.list[it]);
    const int k0 = tile * BK;
    // only a tile with a masked key, a key past N_k or (causal) a key past
    // some query's diagonal needs the test of each key
    const bool exact = warp_uniform(tiles.holes[tile] || (causal && k0 + BK - 1 > q0 + offset));
    float mx[2] = {-INFINITY, -INFINITY}, rowsum[2] = {0.f, 0.f};
    if (!exact) {
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      mx[0] *= scale_log2;  // the scale is positive: max and scale commute exactly
      mx[1] *= scale_log2;
      update_max(mx);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2_approx(fmaf(sc[i], scale_log2, -m[(i >> 1) & 1]));
        sc[i] = p;
        rowsum[(i >> 1) & 1] += p;
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + 2 * t;
        const uint32_t f2 = *reinterpret_cast<const uint16_t*>(tiles.flags + k0 + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t flag = (f2 >> (8 * (e & 1))) & 0xffu;
          float val = sc[nt * 4 + e] * scale_log2;
          if (flag == 1u || (causal && k0 + col + (e & 1) > qi[e >> 1] + offset)) val = NEG_INF;
          if (flag == 2u) val = -INFINITY;  // key 0 of every tile is < N_k, so each row max stays finite
          sc[nt * 4 + e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
      }
      update_max(mx);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2_approx(sc[i] - m[(i >> 1) & 1]);
        sc[i] = p;
        rowsum[(i >> 1) & 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rowsum[r];  // this thread's share of the row sum
  };

  // P of the current tile as bf16 A fragments, before the step starts any
  // wgmma: S's registers then take the next tile's product
  auto pack_p = [&]() {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      pa[j][0] = pack_bf16(sc[8 * j], sc[8 * j + 1]);
      pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
      pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
      pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
    }
  };

  // O += P V of key tile ``it``: P as the register A operand, V MN-major from its TMA tile (started, not waited)
  auto mma_pv = [&](int it) {
    mbar_wait(&full_v[it % VST], (it / VST) & 1);
    const bf16* Vst = v_stage(it);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) wgmma_pv<D>(acc, pa[j], sw128_desc(Vst + j * 16 * 64, BK * 128, 1024));
    wgmma_commit();
    fence_operands(acc);
  };

  mbar_wait(qbar, 0);
  mma_s(0);
  wgmma_wait<0>();
  fence_operands(sc);
  mbar_arrive(&empty_k[0]);
  softmax(0);  // O is still 0: nothing to rescale
  // One key tile a step: P of this tile goes to the A fragments, then the next
  // tile's Q K^T and this tile's P V run back to back on the tensor cores,
  // then the next softmax. Both products are waited for before the softmax:
  // with a wgmma still in flight while plain instructions read accumulators,
  // ptxas serializes every wgmma of the kernel (C7514), which measured slower
  // than this. The softmax of one block overlaps the products of the other
  // block on the SM.
  for (int it = 0; it < n; ++it) {
    const bool more = it + 1 < n;
    pack_p();
    if (more) mma_s(it + 1);
    mma_pv(it);
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(acc);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) fence_operands(pa[j]);
    if (more) mbar_arrive(&empty_k[(it + 1) % KST]);  // the next tile's K stage is free
    mbar_arrive(&empty_v[it % VST]);                   // and so is this tile's V stage
    if (more) {
      softmax(it + 1);
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i >> 1) & 1];
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
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) = pack_bf16(acc[4 * dt + 2 * r] * inv, acc[4 * dt + 2 * r + 1] * inv);
  }
}

constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a block may use on sm_90

// lifts a kernel's dynamic shared-memory cap to the card's limit, once (the
// smem of each launch still sets its occupancy)
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(MAX_SMEM));
}

template <int D>
cudaError_t run_bf16(const void* q, const void* k, const void* v, const void* mask, void* o, int B, int H, int Nq,
                     int Nk, int causal, float scale, cudaStream_t stream) {
  using L = Bf16Layout<D>;
  CUtensorMap tq, tk, tv;
  const uint64_t bh = static_cast<uint64_t>(B) * H;
  cudaError_t err = tensor_map_3d(&tq, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, Nq, bh, 64, L::BQ);
  if (err == cudaSuccess) err = tensor_map_3d(&tk, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, Nk, bh, 64, BK);
  if (err == cudaSuccess) err = tensor_map_3d(&tv, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, Nk, bh, 64, BK);
  if (err != cudaSuccess) return err;
  const size_t smem = L::smem_bytes(Nk);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  static const cudaError_t cap = allow_max_smem(flash_fwd_bf16_kernel<D>);
  if (cap != cudaSuccess) return cap;
  const dim3 grid((Nq + L::BQ - 1) / L::BQ, B * H);
  flash_fwd_bf16_kernel<D><<<grid, L::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const uint8_t*>(mask), static_cast<bf16*>(o), H, Nq, Nk, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_f32(const void* q, const void* k, const void* v, const void* mask, void* o, int B, int H, int Nq,
                    int Nk, int causal, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<D>() + tile_list_bytes(Nk);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  static const cudaError_t cap = allow_max_smem(flash_fwd_f32_kernel<D>);
  if (cap != cudaSuccess) return cap;
  const dim3 grid((Nq + BQ_F - 1) / BQ_F, B * H);
  flash_fwd_f32_kernel<D><<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(o), H, Nq, Nk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int srt_flash_attention(const void* q, const void* k, const void* v, const void* mask, void* o,
                                   int B, int H, int Nq, int Nk, int D, int is_bf16, int causal, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Nq <= 0 || Nk <= 0 || B * H <= 0 || B * H > 65535) return cudaErrorInvalidValue;
  if (is_bf16) {
    if (D == 64) return run_bf16<64>(q, k, v, mask, o, B, H, Nq, Nk, causal, scale, s);
    if (D == 128) return run_bf16<128>(q, k, v, mask, o, B, H, Nq, Nk, causal, scale, s);
  } else {
    if (D == 64) return run_f32<64>(q, k, v, mask, o, B, H, Nq, Nk, causal, scale, s);
    if (D == 128) return run_f32<128>(q, k, v, mask, o, B, H, Nq, Nk, causal, scale, s);
  }
  return cudaErrorInvalidValue;
}
