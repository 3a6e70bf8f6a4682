// The board digest of bit-packed words for Hopper (sm_90a): one pass over
// the board, no host sync.
//
// Replaces no Pallas kernel.  The JAX package computes this digest
// (akka_game_of_life_tpu/ops/digest.py:111 digest_packed) as one fused XLA
// expression; the port's eager version (ops/digest.py:_digest_packed, kept as
// the plain version for CPU tensors) took ~15,000 whole-block int64 passes and
// 16 host syncs over a 65536^2 board.  This kernel computes the same
// definition, bit for bit, in native uint32 arithmetic, whose wrap-around is
// the definition's mod 2^32:
//
//   idx    = (r + row0) * width + 32 * (c + wordcol0) + j
//   D_lane = sum of fmix32(idx ^ seed_lane) over the set bits j of words (r, c)
//
// for seed_lane = 0x9E3779B9, 0x7F4A7C15 (ops/digest.py:LANE_SEEDS).
//
// What bounds it on the H100.  The board is read once (536.9 MB at 65536^2,
// 0.16 ms at 3.35 TB/s), but every cell mixes two murmur3 keys: about 21
// int32 operations a cell as the definition writes them (two fmix32 of three
// xor-shifts and two multiplies each, the seed xors, the masked adds), so
// 9.0e10 at 65536^2, 5.4 ms at 132 SMs x 64 int32/clock x 1.98 GHz
// = 16.73e12/s.  Operations, not bytes, bound it, so the design spends
// nothing on staging memory and everything on fewer instructions a cell:
//
// - Loads: four words (16 bytes) a thread, coalesced, straight into
//   registers, over a grid of a few blocks per SM that walks the board with a
//   grid-stride loop.  The row stride is an argument, so a tile of a larger
//   board (the mesh's word tiles) needs no copy; a view that is not 16-byte
//   aligned loads word by word.
// - Hoisting: where a word's first index is a multiple of 32 (every word of a
//   board whose width is), idx = base | j, so j changes only idx's low five
//   bits and (idx ^ seed) >> 16 is the word's constant.  Per word and lane
//   u = t ^ (t >> 16) with t = base ^ seed; per cell fmix32's first
//   xor-shift is then u ^ j, one instruction where the definition has four
//   (add, xor with the seed, shift, xor).  A word whose first index is not a
//   multiple of 32 (a width that is not) takes the definition as written.
// - Accumulating: a word's 32 bits unrolled, two uint32 lane accumulators in
//   registers, each pair of keys added under one predicate, the bit's.
// - Zero words add nothing and are skipped, so a sparse board costs its set
//   words, with no host sync.
// - Reduction: warp shuffles, then shared memory across the block's warps,
//   then one atomicAdd per block and lane into the low halves of the caller's
//   zeroed int64[2] (addition mod 2^32 is associative and commutative, so the
//   order cannot change the lanes, and the high halves stay 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kSeed0 = 0x9E3779B9u;
constexpr uint32_t kSeed1 = 0x7F4A7C15u;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// murmur3's 32-bit finalizer after its first xor-shift.
__device__ __forceinline__ uint32_t fmix32_tail(uint32_t h) {
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  return fmix32_tail(h ^ (h >> 16));
}

// a0 += k0 and a1 += k1 where `bit` (one bit of the word) is set: one
// predicate for both adds, so the bit costs one instruction and no branch.
__device__ __forceinline__ void add_if(uint32_t bit, uint32_t k0, uint32_t k1,
                                       uint32_t &a0, uint32_t &a1) {
  asm("{\n\t"
      ".reg .pred p;\n\t"
      "setp.ne.u32 p, %2, 0;\n\t"
      "@p add.u32 %0, %0, %3;\n\t"
      "@p add.u32 %1, %1, %4;\n\t"
      "}"
      : "+r"(a0), "+r"(a1)
      : "r"(bit), "r"(k0), "r"(k1));
}

// The keys of word w's set bits, cells base .. base + 31, into a0 and a1.
__device__ __forceinline__ void add_word(uint32_t w, uint32_t base,
                                         uint32_t &a0, uint32_t &a1) {
  if (w == 0u) return;
  if ((base & 31u) == 0u) {
    const uint32_t t0 = base ^ kSeed0, t1 = base ^ kSeed1;
    const uint32_t u0 = t0 ^ (t0 >> 16), u1 = t1 ^ (t1 >> 16);
#pragma unroll
    for (uint32_t j = 0; j < 32; ++j) {
      add_if(w & (1u << j), fmix32_tail(u0 ^ j), fmix32_tail(u1 ^ j), a0, a1);
    }
  } else {
#pragma unroll 4
    for (uint32_t j = 0; j < 32; ++j) {
      const uint32_t idx = base + j;
      add_if(w & (1u << j), fmix32(idx ^ kSeed0), fmix32(idx ^ kSeed1), a0, a1);
    }
  }
}

// Each thread takes groups of four words of a row (the row's last group may
// be short), groups numbered row by row, and strides over the board by the
// grid's thread count.
__global__ void __launch_bounds__(kThreads)
    digest_kernel(const uint32_t *__restrict__ words, long long ld, long long h,
                  int nwords, uint32_t width, uint32_t row0, uint32_t wordcol0,
                  bool vec, uint32_t *__restrict__ lanes) {
  const long long groups = (nwords + 3) / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride_r = stride / groups, stride_c = stride % groups;
  long long r = first / groups, g = first % groups;
  uint32_t a0 = 0u, a1 = 0u;
  while (r < h) {
    const uint32_t *row = words + r * ld;
    const int c = (int)g * 4;
    uint32_t w[4];
    if (vec) {
      const uint4 v = __ldg(reinterpret_cast<const uint4 *>(row + c));
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = c + q < nwords ? __ldg(row + c + q) : 0u;
    }
    const uint32_t base =
        ((uint32_t)r + row0) * width + 32u * ((uint32_t)c + wordcol0);
#pragma unroll
    for (int q = 0; q < 4; ++q) add_word(w[q], base + 32u * q, a0, a1);
    g += stride_c;
    r += stride_r;
    if (g >= groups) g -= groups, ++r;
  }

  __shared__ uint32_t part[2][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a0 += __shfl_down_sync(0xFFFFFFFFu, a0, o);
    a1 += __shfl_down_sync(0xFFFFFFFFu, a1, o);
  }
  if (lane == 0) part[0][warp] = a0, part[1][warp] = a1;
  __syncthreads();
  if (warp == 0) {
    a0 = lane < kWarps ? part[0][lane] : 0u;
    a1 = lane < kWarps ? part[1][lane] : 0u;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      a0 += __shfl_down_sync(0xFFFFFFFFu, a0, o);
      a1 += __shfl_down_sync(0xFFFFFFFFu, a1, o);
    }
    if (lane == 0) atomicAdd(lanes, a0), atomicAdd(lanes + 2, a1);
  }
}

}  // namespace

// Blocks of digest_kernel that card `device` (the current device) holds at
// once, the grid's cap; a CUDA error is returned negated.  The caller asks
// once per card.
extern "C" int digest_resident_blocks(int device) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, digest_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return -(int)err;
  return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

// Add the digest lanes of the (h, nwords) uint32 words at `words`, rows `ld`
// words apart, to the zeroed int64[2] `lanes` on `stream` (atomics into each
// int64's low half), over at most `max_blocks` blocks
// (digest_resident_blocks).  `width`, `row0` and `wordcol0` are the
// definition's, taken mod 2^32.  Returns cudaGetLastError() after the
// launch, 0 with no launch for an empty board, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int digest_packed_launch(const void *words, long long ld, int h,
                                    int nwords, unsigned width, unsigned row0,
                                    unsigned wordcol0, int max_blocks,
                                    void *lanes, void *stream) {
  if (h < 0 || nwords < 0 || ld < nwords || max_blocks < 1 || !lanes ||
      (uintptr_t)lanes % alignof(long long)) {
    return (int)cudaErrorInvalidValue;
  }
  if (h == 0 || nwords == 0) return 0;
  const bool vec = nwords % 4 == 0 && ld % 4 == 0 && (uintptr_t)words % 16 == 0;
  const long long items = (long long)h * ((nwords + 3) / 4);
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  digest_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)words, ld, h, nwords, width, row0, wordcol0, vec,
      (uint32_t *)lanes);
  return (int)cudaGetLastError();
}
