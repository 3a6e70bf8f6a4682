// Temporally blocked packed Life sweep for Hopper (sm_90a): a register
// wavefront, one library per rule.
//
// Replaces the TPU kernel akka_game_of_life_tpu/ops/pallas_stencil.py:
// packed_sweep_fn, i.e. temporal_sweep_planes_fn at one plane with body
// bitpack.step_padded_rows: k generations of a binary outer-totalistic rule on
// an (H, W/32) torus of LSB-first 32-bit words, one read and one write of the
// board per sweep.
//
// What bounds it on the H100.  A sweep reads and writes the board once (2 x
// 512 MiB at 65536^2, 0.32 ms at 3.35 TB/s) and needs, per word per
// generation, 12 instructions for Conway in LOP3/SHF form (2 funnel shifts and
// 2 LOP3 for the row sums, 6 LOP3 for the count bits, 2 for the combine;
// ops/packed_sweep.py:ops_per_word_step); from k = 4 on the integer pipe, not
// the bytes, bounds it.  So the design spends little beyond those instructions:
//
// - The rule is compiled in.  The library is built with -DRULE_BIRTH and
//   -DRULE_SURVIVE1 (10-bit masks over the 9-cell count, centre included:
//   birth at n, survive at n + 1) and, where one of at most two LOP3
//   exists, the rule's fewest-LOP3 combine (-DRULE_COMBINE: two for
//   Conway); a rule that needs more combines by two lookup tables over the
//   low three count bits selected by the centre (three LOP3, one or two
//   more for the rare rule that tells a count of 8 from 0, or 9 from 1).
//   The runtime masks' ten predicates are gone.  The JAX kernel is traced
//   per rule in the same way (pallas_stencil.py closes step_padded_rows
//   over the rule).
// - No shared memory, no barrier.  A block is one warp that streams down a
//   strip of TILE_ROWS output rows: a wavefront of k levels, level j turning
//   rows of generation j-1 into generation j, each level keeping in
//   registers the row sums (s, c) of the two rows above its output and that
//   row's own word, five registers per level.  Each board row is read once
//   per strip and written once; the vertical halo costs rows, not steps.
// - Two words a lane at shallow depths, skewed levels at deep ones.  At
//   k <= 12 a lane holds two consecutive words (the carries between them
//   are funnel shifts, and one shuffle pair serves two words; the register
//   file holds 5 x 2 x 12 per lane), so a warp holds 64 words, writes 62.
//   Deeper, a lane holds one word (30 written of 32) and the levels run
//   skewed: level j takes the row level j-1 emitted one step (one input
//   row) earlier, so the k levels of a step are independent and their
//   shuffles and logic chains overlap instead of waiting on one another;
//   the pipeline's fill grows from 2k to 3k - 1 rows per strip.  The outer
//   word on each side of a warp is halo: one word holds the k <= 31 steps
//   of the garbage front of an unfed edge.  k is a template parameter (one
//   kernel per depth, dispatched at launch) and the row loop is unrolled by
//   three, so every level lives in registers and the rotation of its rows
//   is renaming.
// - Every three-input function is one LOP3 written in PTX: as and/or
//   terms, ptxas split a majority into four.  Per word and generation that
//   is 2 funnel shifts and 10 LOP3 for Conway (the bound's 12), and one or
//   two shuffles.
// - 32-bit indices, wraps by compare.  Every index is taken modulo the torus
//   once per strip (so any H >= 1 and any W/32 >= 1, even 1, evolve as the
//   periodic extension of the torus); each next row wraps by a compare.  Three
//   input rows are loaded ahead into registers, so a load has three steps of
//   k levels of work to arrive behind.
//
// Tiles: TILE_ROWS output rows per block (a strip), default 192, chosen by
// `tune` (runtime/autotune.py) on an H100 at 700 W (PERF.md).  `tune` and
// `run --pallas-block-rows B` rebuild with -DTILE_ROWS=B; the launch refuses
// a board whose strips would pass the grid's 65535 rows of blocks
// (ops/packed_sweep.py:tile_fits says which).

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#ifndef TILE_ROWS
#define TILE_ROWS 192  // output rows per block
#endif
#if !defined(RULE_BIRTH) || !defined(RULE_SURVIVE1)
#error "build with -DRULE_BIRTH=<mask> -DRULE_SURVIVE1=<mask> (ops/packed_sweep.py:library_defines)"
#endif

namespace {

constexpr int kMaxSteps = 31;  // one halo word per side holds k <= 31
constexpr int kMaxGridRows = 65535;
constexpr unsigned kBirth = RULE_BIRTH;
constexpr unsigned kSurvive1 = RULE_SURVIVE1;
static_assert(TILE_ROWS >= 1, "tile variant out of range");
static_assert(kBirth < 1024 && kSurvive1 < 1024 && (kSurvive1 & 1u) == 0,
              "rule masks out of range");

// The design's two thresholds, each chosen against other values on an H100
// at 700 W (PERF.md, "designs tried"): a lane holds two words at depths up
// to 12, and the levels run skewed from depth 13 on.
__host__ __device__ constexpr int words_per_lane(int k) { return k <= 12 ? 2 : 1; }
__host__ __device__ constexpr bool skewed(int k) { return k >= 13; }
__host__ __device__ constexpr int span(int k) { return 32 * words_per_lane(k) - 2; }

__host__ __device__ constexpr unsigned bit(unsigned mask, int n) { return (mask >> n) & 1u; }
// LOP3 tables over (b2, b1, b0): bit t is the next state at count t mod 8.
// A live cell's count is 1..9, so entry 0 stands for 8.
__host__ __device__ constexpr unsigned birth_lut() {
  unsigned lut = 0;
  for (int t = 0; t < 8; ++t) lut |= bit(kBirth, t) << t;
  return lut;
}
__host__ __device__ constexpr unsigned survive_lut() {
  unsigned lut = bit(kSurvive1, 8);
  for (int t = 1; t < 8; ++t) lut |= bit(kSurvive1, t) << t;
  return lut;
}
// Where the table's alias differs: a dead cell with 8 neighbours (reads as
// 0), a live one with 8 (9-cell count 9, reads as 1).
constexpr bool kBirthEight = bit(kBirth, 8) != bit(kBirth, 0);
constexpr bool kSurviveNine = bit(kSurvive1, 9) != bit(kSurvive1, 1);
// The rule's fewest-LOP3 combine, where one of at most two LOP3 exists
// (ops/packed_sweep.py:combine_define finds it): a first LOP3 (table bits
// 0-7) over signals i, j, k (bits 8, 11, 14; 0-3 the count bits b0-b3, 4
// the cell) and, if bit 31 is set, a second (table bits 17-24) over the
// first and signals a, b (bits 25, 28).
#ifdef RULE_COMBINE
constexpr bool kNetwork = true;
constexpr uint32_t kNet = RULE_COMBINE;
#else
constexpr bool kNetwork = false;
constexpr uint32_t kNet = 0;
#endif

// One three-input logic function by its LOP3 table (a -> 0xF0, b -> 0xCC,
// c -> 0xAA), as one instruction: written as and/or terms, ptxas splits a
// majority into four.
template <unsigned L>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(r) : "r"(a), "r"(b), "r"(c), "n"(L));
  return r;
}

// The next state of a word from the row sums of its rows N, C, S (s + 2c
// per cell, centre included) and its own bits x.
__device__ __forceinline__ uint32_t next_state(uint32_t x, uint32_t sN,
                                               uint32_t cN, uint32_t sC,
                                               uint32_t cC, uint32_t sS,
                                               uint32_t cS) {
  const uint32_t b0 = lop3<0x96>(sN, sC, sS);  // xor
  const uint32_t p1 = lop3<0xE8>(sN, sC, sS);  // majority: the s carry
  const uint32_t q0 = lop3<0x96>(cN, cC, cS);
  const uint32_t q1 = lop3<0xE8>(cN, cC, cS);
  const uint32_t b1 = p1 ^ q0;
  const uint32_t b2 = lop3<0x78>(q1, p1, q0);  // q1 ^ (p1 & q0)
  const uint32_t b3 = lop3<0x80>(q1, p1, q0);
  if constexpr (kNetwork) {
    const uint32_t signal[5] = {b0, b1, b2, b3, x};
    const uint32_t first = lop3<kNet & 0xFF>(
        signal[(kNet >> 8) & 7], signal[(kNet >> 11) & 7], signal[(kNet >> 14) & 7]);
    if constexpr (!(kNet >> 31)) {
      return first;
    } else {
      return lop3<(kNet >> 17) & 0xFF>(first, signal[(kNet >> 25) & 7],
                                       signal[(kNet >> 28) & 7]);
    }
  } else {
    uint32_t born = lop3<birth_lut()>(b2, b1, b0);
    if (kBirthEight) born ^= b3;
    uint32_t stays = lop3<survive_lut()>(b2, b1, b0);
    if (kSurviveNine) stays ^= b3 & b0;
    return lop3<0xCA>(x, stays, born);  // x ? stays : born
  }
}

// One step of the wavefront for every level: level j takes a row of
// generation j-1 and emits generation j of the row above it.  Unskewed,
// level j takes level j-1's row of the same step.  Skewed, it takes the row
// level j-1 emitted one step earlier (`pend`), so the K levels of a step
// depend on nothing of each other and their shuffles and logic chains
// overlap; the levels run deepest first so that each reads `pend` before
// the level below refills it.  `v` brings the input row and takes
// generation K.  Slot U of each level's three-row ring takes its incoming
// row; (U+1)%3 holds the row two above, (U+2)%3 the row above.
template <int K, int W, int U>
__device__ __forceinline__ void advance(uint32_t (&v)[W], uint32_t (&pend)[K][W],
                                        uint32_t (&s)[3][K][W],
                                        uint32_t (&c)[3][K][W],
                                        uint32_t (&x)[3][K][W]) {
  constexpr int A = (U + 1) % 3, B = (U + 2) % 3;
  constexpr bool SKEW = skewed(K);
  uint32_t in[W];
#pragma unroll
  for (int i = 0; i < W; ++i) in[i] = v[i];
#pragma unroll
  for (int level = 0; level < K; ++level) {
    const int j = SKEW ? K - 1 - level : level;
    uint32_t row[W];
#pragma unroll
    for (int i = 0; i < W; ++i) row[i] = j == 0 ? in[i] : SKEW ? pend[j][i] : v[i];
    // Lane 0's west and lane 31's east neighbours are their own words: the
    // unfed halo edge, whose garbage never reaches a written word.
    const uint32_t prev = __shfl_up_sync(0xffffffffu, row[W - 1], 1);
    const uint32_t next = __shfl_down_sync(0xffffffffu, row[0], 1);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t west = i == 0 ? prev : row[i - 1];
      const uint32_t east = i == W - 1 ? next : row[i + 1];
      const uint32_t w = __funnelshift_l(west, row[i], 1);
      const uint32_t e = __funnelshift_r(row[i], east, 1);
      const uint32_t sv = lop3<0x96>(row[i], w, e);
      const uint32_t cv = lop3<0xE8>(row[i], w, e);
      const uint32_t nv = next_state(x[B][j][i], s[A][j][i], c[A][j][i],
                                     s[B][j][i], c[B][j][i], sv, cv);
      s[U][j][i] = sv;
      c[U][j][i] = cv;
      x[U][j][i] = row[i];
      if (SKEW && j < K - 1) {
        pend[j + 1][i] = nv;
      } else {
        v[i] = nv;
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(32)
packed_sweep_kernel(const uint32_t *__restrict__ in, uint32_t *__restrict__ out,
                    int H, int NW) {
  constexpr int W = words_per_lane(K);
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * span(K);  // first written word of the strip
  const int r0 = blockIdx.y * TILE_ROWS;
  const int rows = min(TILE_ROWS, H - r0);
  constexpr int kDelay = skewed(K) ? 3 * K - 1 : 2 * K;  // step of output row r0
  const int steps = rows + kDelay;

  // The lane's words: torus columns (wrapped once) and whether it writes
  // them (not a halo word, not past the board).
  int col[W];
  bool writes[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int word = c0 - 1 + lane * W + i;
    const int wrapped = word % NW;
    col[i] = wrapped < 0 ? wrapped + NW : wrapped;
    writes[i] = lane * W + i >= 1 && lane * W + i <= span(K) && word < NW;
  }
  int g = (r0 - K) % H;  // next input row
  if (g < 0) g += H;

  uint32_t s[3][K][W] = {}, c[3][K][W] = {}, x[3][K][W] = {};
  uint32_t pend[K][W] = {};
  uint32_t ahead[3][W];
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const uint32_t *row = in + (size_t)g * NW;
#pragma unroll
    for (int i = 0; i < W; ++i) ahead[u][i] = row[col[i]];
    if (++g == H) g = 0;
  }

  // Step t takes input row r0 - K + t and emits generation K of row
  // r0 + t - kDelay, written from t = kDelay on.
  for (int t = 0; t < steps; t += 3) {
    uint32_t v[3][W];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
#pragma unroll
      for (int i = 0; i < W; ++i) v[u][i] = ahead[u][i];
      const uint32_t *row = in + (size_t)g * NW;
#pragma unroll
      for (int i = 0; i < W; ++i) ahead[u][i] = row[col[i]];
      if (++g == H) g = 0;
    }
#define GOL_STEP(U)                                                   \
  advance<K, W, U>(v[U], pend, s, c, x);                              \
  if (t + U >= kDelay) {                                              \
    uint32_t *row = out + (size_t)(r0 + t + U - kDelay) * NW;         \
    _Pragma("unroll") for (int i = 0; i < W; ++i) if (writes[i])      \
        row[c0 - 1 + lane * W + i] = v[U][i];                         \
  }
    GOL_STEP(0)
    if (t + 1 >= steps) break;
    GOL_STEP(1)
    if (t + 2 >= steps) break;
    GOL_STEP(2)
#undef GOL_STEP
  }
}

using Kernel = void (*)(const uint32_t *, uint32_t *, int, int);

template <size_t... I>
Kernel kernel_of_depth(int k, std::index_sequence<I...>) {
  static const Kernel table[] = {packed_sweep_kernel<int(I) + 1>...};
  return table[k - 1];
}

}  // namespace

// Launch one k-generation sweep on `stream`.  `in` and `out` are distinct
// (H, NW) device buffers.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take (a board
// whose strips would pass the grid's rows of blocks included).
extern "C" int packed_sweep_launch(const void *in, void *out, int H, int NW,
                                   int k, void *stream) {
  if (in == out || H < 1 || NW < 1 || k < 1 || k > kMaxSteps ||
      (H + TILE_ROWS - 1) / TILE_ROWS > kMaxGridRows) {
    return (int)cudaErrorInvalidValue;
  }
  const Kernel kernel =
      kernel_of_depth(k, std::make_index_sequence<kMaxSteps>());
  const dim3 grid((NW + span(k) - 1) / span(k), (H + TILE_ROWS - 1) / TILE_ROWS);
  kernel<<<grid, 32, 0, (cudaStream_t)stream>>>((const uint32_t *)in,
                                                (uint32_t *)out, H, NW);
  return (int)cudaGetLastError();
}

// The rule and tile this library was built for, for the wrapper to check
// against the rule it launches.
extern "C" void packed_sweep_variant(unsigned *birth, unsigned *survive1,
                                     int *tile_rows) {
  *birth = kBirth;
  *survive1 = kSurvive1;
  *tile_rows = TILE_ROWS;
}
