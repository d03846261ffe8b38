// K4: k-means codebook assignment, id = argmax_c (x . c - |c|^2 / 2), in f32.
//
// Replaces speech_resynth_tpu/ops/codebook.py:_assign_kernel (launched by
// assign_pallas), which keeps the whole padded codebook in VMEM and runs one
// (frames x D) @ (D x K) MXU product plus a lane argmax per frame tile.
//
// What bounds it on an H100: operations. At the resynthesis shape (23 984
// frames x 768 x 2 000 centers) the product is 73.7 GFLOP against ~80 MB of
// inputs. The scores must be f32-accurate: plain TF32 keeps 10 mantissa bits
// of each operand, an error of ~1e-3 relative on a score, enough to flip the
// near-ties that the f32 reference resolves. So the products run as split
// TF32 (3xTF32) on the tensor cores: each operand v is split into
// hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi) (a non-finite v is all
// hi), and x.c is accumulated in f32 as x_lo.c_hi + x_hi.c_lo + x_hi.c_hi.
// The dropped x_lo.c_lo term and the rounding of lo are ~2^-21 relative per
// product, the size of f32's own rounding: f32 accuracy at three TF32 products,
// whose 495 TFLOP/s bound the kernel at 3 x 2 N D K / 495e12 (0.447 ms there),
// against 1.100 ms for exact f32 on the CUDA cores. A bf16 x widens exactly
// into TF32 (x_lo = 0), so it takes two products.
//
// Design. A block owns 64 (one warpgroup) or 128 (two) frames and walks a
// range of center tiles of TN centers; for each it streams 32-deep slabs of
// x and of the codebook's hi and lo halves through a 4-stage ring of 16-byte
// cp.async copies. The codebook halves arrive in the 128-byte-swizzled
// K-major layout that wgmma reads from shared memory; x lands in padded rows
// from which each thread loads its A fragment (conflict-free), splits it in
// registers and feeds wgmma (m64 x TN x k8, tf32) from registers. The
// codebook halves c_hi, c_lo (K, D) are made once per quantizer
// (ops/codebook.py:codebook_operands); x is read as it is, f32 or bf16, with
// no per-call copy.
//
// The scores never leave registers. Each score is compared as its
// order-preserving bits (larger float -> larger uint32), with -0.0 read as
// +0.0 and every NaN as one NaN above +inf, so that a NaN wins as it does in
// torch.argmax / jnp.argmax. Each thread carries a running (best key, best id)
// for its 2 frames across the center tiles of its block, seeded by its first
// valid center, so a frame always gets an id in [0, K) even when every score
// is -inf or NaN; the 4 threads that share a frame reduce with warp shuffles;
// blocks that cover other center ranges of the same frames (grid.y) meet in a
// 64-bit atomicMax on (key << 32 | ~id), so the larger score wins and, on
// exactly equal scores, the lower id, as in torch.argmax / jnp.argmax. The
// maximum does not depend on the order of the atomics, so the result is
// deterministic. A last small kernel unpacks the ids.
//
// Nothing is padded: copies past N, K or D fill zeros (cp.async's src-size 0),
// centers >= K are skipped, and frames >= N are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int TD = 32;      // depths per pipeline stage: one 128-byte row of f32 per center
constexpr int STAGES = 4;   // shared-memory ring depth

// order-preserving map of an f32 onto uint32 (larger float -> larger uint);
// -0.0 maps as +0.0, and every NaN onto one key above +inf's
__device__ __forceinline__ uint32_t score_key(float f) {
  if (f != f) return 0xffffffffu;
  const uint32_t u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// better (key, id): larger key, then lower id; id < 0 is no candidate
__device__ __forceinline__ bool better(uint32_t key, int id, uint32_t best_key, int best_id) {
  if (id < 0) return false;
  return best_id < 0 || key > best_key || (key == best_key && id < best_id);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

template <typename XT, int NWG, int TN>
struct AssignLayout {
  static constexpr int THREADS = NWG * 128;
  static constexpr int TM = 64 * NWG;                            // frames per block
  static constexpr int XV = 16 / sizeof(XT);                     // x elements per 16-byte copy
  static constexpr int XS = TD + XV;                             // padded x row (elements): conflict-free fragments
  static constexpr int C_BYTES = TN * TD * 4;                    // one codebook half's slab, swizzled
  static constexpr int X_BYTES = TM * XS * static_cast<int>(sizeof(XT));
  static constexpr int STAGE_BYTES = 2 * C_BYTES + X_BYTES;      // c_hi, c_lo, x
  static constexpr size_t SMEM = 1024 + static_cast<size_t>(STAGES) * STAGE_BYTES;
  static_assert(C_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0, "swizzle atoms must stay 1024-byte aligned");
};

template <int TN>
__device__ __forceinline__ void wgmma_tf32(float (&acc)[TN / 2], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  if constexpr (TN == 128)
    wgmma_m64n128k8_tf32_rs(acc, a, db, accumulate);
  else
    wgmma_m64n32k8_tf32_rs(acc, a, db, accumulate);
}

template <typename XT, int NWG, int TN>
__global__ void __launch_bounds__(NWG * 128, 1) codebook_assign_kernel(
    const XT* __restrict__ x, const float* __restrict__ c_hi, const float* __restrict__ c_lo,
    const float* __restrict__ half_sq, unsigned long long* __restrict__ packed, int N, int D, int K,
    int tiles_per_split) {
  using L = AssignLayout<XT, NWG, TN>;
  constexpr int THREADS = L::THREADS, TM = L::TM, XV = L::XV, XS = L::XS, NACC = TN / 2;
  constexpr int C_COPIES = TN * (TD / 4) / THREADS;   // 16-byte copies per thread per codebook half per stage
  constexpr int X_COPIES = TM * (TD / XV) / THREADS;  // and of x
  constexpr bool SPLIT_X = sizeof(XT) == 4;           // a bf16 x is exact in TF32: no x_lo
  static_assert(C_COPIES >= 1 && X_COPIES >= 1, "every thread copies");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TM;
  const int row0 = wg * 64 + warp * 16 + g;  // this thread's frames in the tile: row0 and row0 + 8

  uint32_t best_key[2] = {0u, 0u};
  int best_id[2] = {-1, -1};  // -1 until the thread's first valid center

  const int num_ctiles = (K + TN - 1) / TN;
  const int ct_begin = blockIdx.y * tiles_per_split;
  const int ct_end = min(num_ctiles, ct_begin + tiles_per_split);
  const int num_slices = (D + TD - 1) / TD;

  for (int ct = ct_begin; ct < ct_end; ++ct) {
    const int c0 = ct * TN;
    // depths [slice * TD, slice * TD + TD) of the codebook halves (swizzled)
    // and of x (padded rows) into stage ``stage``
    auto load_slice = [&](int slice, int stage) {
      uint8_t* st = smem + stage * L::STAGE_BYTES;
      float* chs = reinterpret_cast<float*>(st);
      float* cls = reinterpret_cast<float*>(st + L::C_BYTES);
      XT* xs = reinterpret_cast<XT*>(st + 2 * L::C_BYTES);
      const int d0 = slice * TD;
#pragma unroll
      for (int e = 0; e < C_COPIES; ++e) {
        const int idx = tid + e * THREADS;
        const int r = idx / (TD / 4), ch = idx % (TD / 4);
        const int d = d0 + ch * 4;
        const bool valid = c0 + r < K && d < D;
        const size_t src = valid ? static_cast<size_t>(c0 + r) * D + d : 0;
        const int dst = sw128_chunk(r, ch, 4);
        cp_async16(chs + dst, c_hi + src, valid);
        cp_async16(cls + dst, c_lo + src, valid);
      }
#pragma unroll
      for (int e = 0; e < X_COPIES; ++e) {
        const int idx = tid + e * THREADS;
        const int r = idx / (TD / XV), ch = idx % (TD / XV);
        const int d = d0 + ch * XV;
        const bool valid = n0 + r < N && d < D;
        cp_async16(xs + r * XS + ch * XV, x + (valid ? static_cast<size_t>(n0 + r) * D + d : 0), valid);
      }
    };

    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

    __syncthreads();  // every thread is done with the ring of the previous center tile
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < num_slices) load_slice(st, st);
      cp_async_commit();
    }
    for (int s = 0; s < num_slices; ++s) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of slice s have landed
      fence_async_shared();         // and are visible to wgmma's reads
      __syncthreads();              // everyone's have, and slice s - 1 is no longer read
      if (s + STAGES - 1 < num_slices) load_slice(s + STAGES - 1, (s + STAGES - 1) % STAGES);
      cp_async_commit();
      const uint8_t* st = smem + (s % STAGES) * L::STAGE_BYTES;
      const float* chs = reinterpret_cast<const float*>(st);
      const float* cls = reinterpret_cast<const float*>(st + L::C_BYTES);
      const XT* xs = reinterpret_cast<const XT*>(st + 2 * L::C_BYTES);

      // A fragments of the 4 k8 steps: (row0, k), (row0 + 8, k), (row0, k + 4), (row0 + 8, k + 4), k = 8 ks + t
      // (a_mid: a_hi with inf and NaN zeroed, for the c_lo product: a non-finite
      // value stays whole in hi, and its inf times a c_lo of 0 would make a NaN
      // that the f32 product inf * c does not)
      uint32_t a_hi[TD / 8][4], a_mid[TD / 8][4], a_lo[TD / 8][4];
#pragma unroll
      for (int ks = 0; ks < TD / 8; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = widen(xs[(row0 + 8 * (i & 1)) * XS + ks * 8 + t + 4 * (i >> 1)]);
          const float hi = __uint_as_float(tf32_rna(v));
          const bool finite = isfinite(hi);
          a_hi[ks][i] = __float_as_uint(hi);
          a_mid[ks][i] = finite ? a_hi[ks][i] : 0u;
          a_lo[ks][i] = SPLIT_X && finite ? tf32_rna(v - hi) : 0u;
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TD / 8; ++ks) {
        const uint64_t dhi = sw128_desc(chs + ks * 8, 16, 1024);
        const uint64_t dlo = sw128_desc(cls + ks * 8, 16, 1024);
        // the small terms first; the tile's first product overwrites acc
        if constexpr (SPLIT_X) wgmma_tf32<TN>(acc, a_lo[ks], dhi, s > 0 || ks > 0);
        wgmma_tf32<TN>(acc, a_mid[ks], dlo, SPLIT_X || s > 0 || ks > 0);
        wgmma_tf32<TN>(acc, a_hi[ks], dhi, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
    }
    cp_async_wait<0>();

    // epilogue of this center tile: score = x.c - |c|^2/2, masked past K; a
    // thread visits its columns in ascending id, so a strict > keeps the lower id
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + j * 8 + 2 * t + (e & 1);
        if (c >= K) continue;
        const int r = e >> 1;
        const uint32_t key = score_key(acc[4 * j + e] - half_sq[c]);
        if (best_id[r] < 0 || key > best_key[r]) {
          best_key[r] = key;
          best_id[r] = c;
        }
      }
    }
  }

  // reduce across the 4 threads (lanes 4g .. 4g + 3) that share these frames
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t key = best_key[r];
    int id = best_id[r];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const uint32_t okey = __shfl_xor_sync(0xffffffffu, key, off);
      const int oid = __shfl_xor_sync(0xffffffffu, id, off);
      if (better(okey, oid, key, id)) {
        key = okey;
        id = oid;
      }
    }
    const int n = n0 + row0 + 8 * r;
    if (t == 0 && id >= 0 && n < N) {
      // every key is above the zeroed word: the -inf score's is 0x007fffff
      const unsigned long long word =
          (static_cast<unsigned long long>(key) << 32) | (0xffffffffu - static_cast<uint32_t>(id));
      atomicMax(packed + n, word);
    }
  }
}

__global__ void unpack_ids_kernel(const unsigned long long* __restrict__ packed, int* __restrict__ ids, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < N) ids[n] = static_cast<int>(0xffffffffu - static_cast<uint32_t>(packed[n] & 0xffffffffull));
}

template <typename XT, int NWG, int TN>
struct Launch {
  using L = AssignLayout<XT, NWG, TN>;

  // lifts the shared-memory cap once, then reads how many blocks of this tile an SM holds
  static cudaError_t blocks_per_sm(int* n) {
    static int per_sm = 0;
    static const cudaError_t err = [] {
      cudaError_t e = cudaFuncSetAttribute(codebook_assign_kernel<XT, NWG, TN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::SMEM));
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, codebook_assign_kernel<XT, NWG, TN>, L::THREADS, L::SMEM);
      return e;
    }();
    *n = per_sm;
    return err;
  }

  // the split (blocks sharing the center tiles of one frame tile) that fills
  // the card's slots best over whole waves, then the fewest splits; and the launch
  static cudaError_t run(const void* x, const void* c_hi, const void* c_lo, const void* half_sq,
                         unsigned long long* packed, int N, int D, int K, int sms, cudaStream_t s) {
    int per_sm = 0;
    cudaError_t err = blocks_per_sm(&per_sm);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long rows = (N + L::TM - 1) / L::TM, tiles = (K + TN - 1) / TN, slots = static_cast<long long>(sms) * per_sm;
    int tiles_per_split = static_cast<int>(tiles);
    double best = -1.0;
    for (long long splits = 1; splits <= tiles; ++splits) {
      const long long per_block = (tiles + splits - 1) / splits;
      const long long blocks = rows * ((tiles + per_block - 1) / per_block);
      const double share = static_cast<double>(rows * tiles) / (static_cast<double>((blocks + slots - 1) / slots) * slots * per_block);
      if (share > best + 1e-9) {
        best = share;
        tiles_per_split = static_cast<int>(per_block);
      }
    }
    const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>((tiles + tiles_per_split - 1) / tiles_per_split));
    codebook_assign_kernel<XT, NWG, TN><<<grid, L::THREADS, L::SMEM, s>>>(
        static_cast<const XT*>(x), static_cast<const float*>(c_hi), static_cast<const float*>(c_lo),
        static_cast<const float*>(half_sq), packed, N, D, K, tiles_per_split);
    return cudaGetLastError();
  }
};

template <typename XT>
cudaError_t run(const void* x, const void* c_hi, const void* c_lo, const void* half_sq, unsigned long long* packed,
                int N, int D, int K, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // the wide 128-frame x 128-center block tile where its grid covers the card,
  // else the narrow 64 x 32 one, which gives a small input more blocks
  using Wide = Launch<XT, 2, 128>;
  const long long wide_blocks = static_cast<long long>((N + Wide::L::TM - 1) / Wide::L::TM) * ((K + 127) / 128);
  if (wide_blocks >= sms) return Wide::run(x, c_hi, c_lo, half_sq, packed, N, D, K, sms, s);
  return Launch<XT, 1, 32>::run(x, c_hi, c_lo, half_sq, packed, N, D, K, sms, s);
}

}  // namespace

// x (N, D) f32 or bf16 row-major; c_hi, c_lo (K, D) f32, the codebook's TF32
// halves; half_sq (K,) f32; packed (N,) 64-bit scratch; ids (N,) int32 out.
// D % 8 == 0. The block tile and the split of the centers are chosen here,
// from N, K, the card's SM count and the kernel's occupancy. Returns the
// cudaError_t of the launches.
extern "C" int srt_codebook_assign(const void* x, const void* c_hi, const void* c_lo, const void* half_sq,
                                   void* packed, void* ids, int N, int D, int K, int x_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || D <= 0 || D % 8 != 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(packed, 0, static_cast<size_t>(N) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* out = static_cast<unsigned long long*>(packed);
  err = x_is_bf16 ? run<bf16>(x, c_hi, c_lo, half_sq, out, N, D, K, s) : run<float>(x, c_hi, c_lo, half_sq, out, N, D, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unpack_ids_kernel<<<(N + 255) / 256, 256, 0, s>>>(out, static_cast<int*>(ids), N);
  return static_cast<int>(cudaGetLastError());
}
