// K4: k-means codebook assignment, id = argmax_c (x . c - |c|^2 / 2), in f32.
//
// Replaces speech_resynth_tpu/ops/codebook.py:_assign_kernel (launched by
// assign_pallas), which keeps the whole padded codebook in VMEM and runs one
// (frames x D) @ (D x K) MXU product plus a lane argmax per frame tile.
//
// What bounds it on an H100: operations. At the encoder's shape (7 984 frames
// x 768 x 2000 centers) the product is 24.5 GFLOP against ~31 MB of inputs,
// ~800 flops per byte. The scores must be exact f32 (TF32 or bf16 tensor cores
// round them and flip near-ties), so the work runs on the CUDA cores:
// an SGEMM-style tiling, 128 frames x 128 centers per block tile, 8 x 8
// outputs per thread. The wrapper hands both operands over k-major, x^T (D, N)
// and c^T (D, K) (the TPU wrapper transposes the codebook the same way), so a
// slice of 8 depths of either tile is 8 contiguous rows of 128 floats:
// cp.async copies them straight into a 4-stage shared-memory ring, with no
// staging registers, and two blocks fit on an SM.
//
// The scores never leave registers. Each score is compared as its
// order-preserving bits (larger float -> larger uint32), with -0.0 read as
// +0.0 and every NaN as one NaN above +inf, so that a NaN wins as it does in
// torch.argmax / jnp.argmax. Each thread carries a running (best key, best id)
// for its 8 frames across the center tiles of its block, seeded by its first
// valid center, so a frame always gets an id in [0, K) even when every score
// is -inf or NaN; the 16 threads that share a frame reduce with warp shuffles;
// blocks that cover other center ranges of the same frames (grid.y) meet in a
// 64-bit atomicMax on (key << 32 | ~id), so the larger score wins and, on
// exactly equal scores, the lower id, as in torch.argmax / jnp.argmax. The
// maximum does not depend on the order of the atomics, so the result is
// deterministic. A last small kernel unpacks the ids.
//
// Nothing is padded: copies past N, K or D fill zeros (cp.async's src-size 0),
// centers >= K are skipped, and frames >= N are never written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;       // frames per block tile
constexpr int TC = 128;       // centers per block tile
constexpr int TD = 8;         // depths per pipeline stage
constexpr int STAGES = 4;     // shared-memory ring: 4 x (8 x 128) floats per operand, 32 KB in all
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int COPIES = TD * TN / THREADS;  // 4-byte copies per thread per operand per stage

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING)); }

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

__global__ void __launch_bounds__(THREADS, 2) codebook_assign_kernel(
    const float* __restrict__ xt, const float* __restrict__ ct, const float* __restrict__ half_sq,
    unsigned long long* __restrict__ packed, int N, int D, int K, int tiles_per_split) {
  __shared__ __align__(16) float xs[STAGES][TD][TN];
  __shared__ __align__(16) float cs[STAGES][TD][TC];

  const int tid = threadIdx.x;
  const int tr = tid / 16;  // frame group: frames tr*4 + {0..3} and 64 + tr*4 + {0..3}
  const int tc = tid % 16;  // center group: the same pattern over centers
  const int n0 = blockIdx.x * TN;

  uint32_t best_key[8];
  int best_id[8];  // -1 until the thread's first valid center
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_key[i] = 0u;
    best_id[i] = -1;
  }

  const int num_ctiles = (K + TC - 1) / TC;
  const int ct_begin = blockIdx.y * tiles_per_split;
  const int ct_end = min(num_ctiles, ct_begin + tiles_per_split);
  const int num_slices = (D + TD - 1) / TD;

  for (int t = ct_begin; t < ct_end; ++t) {
    const int c0 = t * TC;
    // copy depths [slice*TD, slice*TD + TD) of both tiles into stage ``stage``;
    // consecutive threads copy consecutive columns (coalesced)
    auto load_slice = [&](int slice, int stage) {
#pragma unroll
      for (int e = 0; e < COPIES; ++e) {
        const int idx = tid + e * THREADS;
        const int dd = idx / TN, col = idx % TN;
        const int d = slice * TD + dd;
        const bool dv = d < D;
        const bool xv = dv && n0 + col < N, cv = dv && c0 + col < K;
        cp_async4(&xs[stage][dd][col], xv ? xt + static_cast<size_t>(d) * N + n0 + col : xt, xv);
        cp_async4(&cs[stage][dd][col], cv ? ct + static_cast<size_t>(d) * K + c0 + col : ct, cv);
      }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    __syncthreads();  // every thread is done with the ring of the previous center tile
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < num_slices) load_slice(st, st);
      cp_async_commit();
    }
    for (int s = 0; s < num_slices; ++s) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of slice s have landed
      __syncthreads();              // everyone's have, and slice s - 1 is no longer read
      if (s + STAGES - 1 < num_slices) load_slice(s + STAGES - 1, (s + STAGES - 1) % STAGES);
      cp_async_commit();
      const int stage = s % STAGES;
#pragma unroll
      for (int k = 0; k < TD; ++k) {
        float a[8], b[8];
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[stage][k][tr * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xs[stage][k][64 + tr * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&cs[stage][k][tc * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&cs[stage][k][64 + tc * 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();

    // epilogue of this center tile: score = x.c - |c|^2/2, masked past K; the
    // columns are visited in ascending id, so a strict > keeps the lower id
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + (j < 4 ? tc * 4 + j : 64 + tc * 4 + (j - 4));
      if (c >= K) continue;
      const float hs = half_sq[c];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t key = score_key(acc[i][j] - hs);
        if (best_id[i] < 0 || key > best_key[i]) {
          best_key[i] = key;
          best_id[i] = c;
        }
      }
    }
  }

  // reduce across the 16 threads (consecutive lanes) that share these frames
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t key = best_key[i];
    int id = best_id[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const uint32_t okey = __shfl_xor_sync(0xffffffffu, key, off);
      const int oid = __shfl_xor_sync(0xffffffffu, id, off);
      if (better(okey, oid, key, id)) {
        key = okey;
        id = oid;
      }
    }
    const int n = n0 + (i < 4 ? tr * 4 + i : 64 + tr * 4 + (i - 4));
    if (tc == 0 && id >= 0 && n < N) {
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

}  // namespace

// xt (D, N) and ct (D, K) f32, k-major; half_sq (K,) f32; packed (N,) 64-bit
// scratch; ids (N,) int32 out. ``splits`` blocks share the center tiles of one
// frame tile. Returns the cudaError_t of the launches.
extern "C" int srt_codebook_assign(const void* xt, const void* ct, const void* half_sq, void* packed, void* ids,
                                   int N, int D, int K, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || D <= 0 || K <= 0 || splits <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(packed, 0, static_cast<size_t>(N) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_ctiles = (K + TC - 1) / TC;
  const int tiles_per_split = (num_ctiles + splits - 1) / splits;
  const dim3 grid((N + TN - 1) / TN, (num_ctiles + tiles_per_split - 1) / tiles_per_split);
  auto* out = static_cast<unsigned long long*>(packed);
  codebook_assign_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(xt), static_cast<const float*>(ct),
                                                  static_cast<const float*>(half_sq), out, N, D, K, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unpack_ids_kernel<<<(N + 255) / 256, 256, 0, s>>>(out, static_cast<int*>(ids), N);
  return static_cast<int>(cudaGetLastError());
}
