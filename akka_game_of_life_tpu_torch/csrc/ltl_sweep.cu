// One Larger-than-Life generation on an (H, W) uint8 torus, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel akka_game_of_life_tpu/ops/pallas_ltl.py:ltl_sweep_fn:
// the (2R+1)^2 box sum of the live cells (state 1), minus the centre, with
// birth/survive sets over 0..(2R+1)^2-1 applied, R <= 10; one read and one
// write of the board per generation.
//
// Design.  A block of kTileW threads owns kTileH x kTileW output cells.  It
// loads the (kTileH + 2R) x (kTileW + 2R) window of the board into shared
// memory as 0/1 bytes, with rows wrapped modulo H and columns modulo W, so
// any H and W are taken (also W < 2R + 1, whose window is the board's
// periodic extension, as the plain version's wrap pad gives it).  Each
// thread then walks down one or two columns of the window with a running
// (2R+1)-row sum (add the row entering, subtract the row leaving), writes it
// to a row buffer, and after one barrier sums 2R+1 neighbouring entries of
// that buffer for its own output column.  All counts are integers, exact
// (they equal the JAX package's bf16/f32 counts).  The row buffer is double
// buffered by row parity, so one barrier per output row suffices.  A warp's
// byte reads of the buffer are consecutive addresses (no bank conflicts).
//
// The rule is data: two bitsets of 14 words (441 bits, counts 0..440 at
// R = 10) copied to shared memory once per block; the next state is bit n of
// the survive set for a live centre and of the birth set otherwise.
//
// Bound on the H100: a generation reads and writes the board once (2 B per
// cell, 0.16 ms at 16384^2 and 3.35 TB/s) and needs about 9 integer
// operations per cell at any R (ops/ltl_sweep.py:ops_per_cell: running sums
// along both axes, 2 adds each, 1 for the centre, 4 for the rule), 0.14 ms at
// 16384^2, so the bytes bound it.  This first kernel is simple and does more:
// the horizontal sum re-adds 2R+1 entries per cell where a running sum along
// the row would need 2, and the tile load wraps every index.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 256;  // output columns per block = threads per block
constexpr int kTileH = 64;  // output rows per block
constexpr int kMaxRadius = 10;
constexpr int kRuleWords = ((2 * kMaxRadius + 1) * (2 * kMaxRadius + 1) + 31) / 32;
static_assert(kTileW >= 2 * kMaxRadius, "one extra column per thread holds the halo");

struct RuleBits {
  uint32_t birth[kRuleWords];
  uint32_t survive[kRuleWords];
};

constexpr size_t smem_bytes(int r) {
  return (size_t)(kTileH + 2 * r) * (kTileW + 2 * r) + 2 * (kTileW + 2 * r);
}
static_assert(smem_bytes(kMaxRadius) <= 48 * 1024, "tile needs an opt-in");

// g modulo n for g in [-n, 2n) in two compares, else by division.
__device__ __forceinline__ int wrap(int g, int n) {
  if (g < 0) g += n;
  else if (g >= n) g -= n;
  if (g < 0 || g >= n) g = ((g % n) + n) % n;
  return g;
}

__global__ void __launch_bounds__(kTileW)
ltl_sweep_kernel(const uint8_t *__restrict__ in, uint8_t *__restrict__ out,
                 int H, int W, int R, RuleBits rule) {
  extern __shared__ uint8_t smem[];
  __shared__ uint32_t rule_s[2 * kRuleWords];
  const int D = 2 * R + 1;
  const int EW = kTileW + 2 * R;  // window columns
  const int EH = kTileH + 2 * R;  // window rows
  uint8_t *tile = smem;
  uint8_t *rowbuf = smem + EH * EW;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kTileH;
  const int col0 = blockIdx.x * kTileW;
  if (tid < kRuleWords) {
    rule_s[tid] = rule.birth[tid];
    rule_s[kRuleWords + tid] = rule.survive[tid];
  }

  // The window: thread tid loads columns c0 = tid and, for the 2R columns
  // past kTileW, c1 = tid + kTileW, of every row.
  const int c0 = tid, c1 = tid + kTileW;
  const bool has1 = c1 < EW;
  const int g0 = wrap(col0 - R + c0, W);
  const int g1 = has1 ? wrap(col0 - R + c1, W) : 0;
  for (int r = 0; r < EH; ++r) {
    const uint8_t *src = in + (size_t)wrap(row0 - R + r, H) * W;
    tile[r * EW + c0] = src[g0] == 1;
    if (has1) tile[r * EW + c1] = src[g1] == 1;
  }
  __syncthreads();

  int v0 = 0, v1 = 0;  // running (2R+1)-row sums of columns c0, c1
  for (int r = 0; r < D; ++r) {
    v0 += tile[r * EW + c0];
    if (has1) v1 += tile[r * EW + c1];
  }
  const int out_col = col0 + tid;
  for (int y = 0; y < kTileH; ++y) {
    if (y > 0) {
      v0 += tile[(y + 2 * R) * EW + c0] - tile[(y - 1) * EW + c0];
      if (has1) v1 += tile[(y + 2 * R) * EW + c1] - tile[(y - 1) * EW + c1];
    }
    uint8_t *buf = rowbuf + (y & 1) * EW;
    buf[c0] = (uint8_t)v0;
    if (has1) buf[c1] = (uint8_t)v1;
    __syncthreads();
    int sum = 0;
    for (int dx = 0; dx < D; ++dx) sum += buf[tid + dx];
    const int alive = tile[(y + R) * EW + tid + R];
    const int n = sum - alive;
    const uint32_t *bits = rule_s + (alive ? kRuleWords : 0);
    const int grow = row0 + y;
    if (grow < H && out_col < W) {
      out[(size_t)grow * W + out_col] = (uint8_t)((bits[n >> 5] >> (n & 31)) & 1u);
    }
  }
}

}  // namespace

// Launch one generation of the (H, W) board `in` into the distinct buffer
// `out` on `stream`; `birth` and `survive` are bitsets of 14 words over the
// neighbour count.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int ltl_sweep_launch(const void *in, void *out, int H, int W, int R,
                                const unsigned *birth, const unsigned *survive,
                                void *stream) {
  if (in == out || H < 1 || W < 1 || R < 1 || R > kMaxRadius || !birth ||
      !survive || (H + kTileH - 1) / kTileH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  RuleBits rule;
  for (int i = 0; i < kRuleWords; ++i) {
    rule.birth[i] = birth[i];
    rule.survive[i] = survive[i];
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  ltl_sweep_kernel<<<grid, kTileW, smem_bytes(R), (cudaStream_t)stream>>>(
      (const uint8_t *)in, (uint8_t *)out, H, W, R, rule);
  return (int)cudaGetLastError();
}

// The bitset length the launch reads, for the wrapper to check against.
extern "C" int ltl_sweep_rule_words(void) { return kRuleWords; }
