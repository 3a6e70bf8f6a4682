// Temporally blocked Generations / WireWorld plane sweep for Hopper (sm_90a):
// a register wavefront, one library per rule.
//
// Replaces the TPU kernel akka_game_of_life_tpu/ops/pallas_gen.py:gen_sweep_fn,
// i.e. ops/pallas_stencil.py:temporal_sweep_planes_fn at m = ceil(log2 S)
// planes with body bitpack_gen.step_gen_padded_rows_planes: k generations of
// m lock-step (H, W/32) planes of LSB-first 32-bit words, one read and one
// write of every plane per sweep.
//
// The step is the plane formulas of bitpack_gen, not a per-cell state
// machine, so plane values that encode no state of the rule evolve exactly
// as in the plain version:
//   alive = (state == 1), the Moore count t of alive (centre included, 0..9);
//   Generations: to_one = dead & birth(t) | alive & survive(t),
//     advance = ~dead & ~to_one & ~(state == S-1), next = to_one ? 1 :
//     advance ? state + 1 : 0 (ripple carry over the planes);
//   WireWorld: p0' = p1, p1' = (p0 ^ p1) | (p0 & p1 & ~excite(t)), where
//     excite has no self term (a conductor is not a head).
//
// What bounds it on the H100.  A sweep reads and writes the m planes once
// (2 planes x 32 MiB each way for the WireWorld run's 16384^2 board, 0.04
// ms at 3.35 TB/s) and needs, per word per generation, 13 LOP3/SHF instructions for
// WireWorld and 14 for Brian's Brain (the alive plane, its row sums, the
// count bits, the rule's combine and the planes' update;
// ops/gen_sweep.py:ops_per_word_step), so from k of a few on the integer
// pipe bounds it; the kernel issues just those (cuobjdump -sass), plus the
// halo's rows and words.  The design is csrc/packed_sweep.cu's carried to
// m planes:
//
// - The rule is compiled in.  The library is built with -DRULE_BIRTH,
//   -DRULE_SURVIVE1 (10-bit masks over the 9-cell count: birth at n, survive
//   at n + 1), -DRULE_STATES and -DRULE_WIREWORLD, and the rule's
//   fewest-LOP3 network over the count bits and plane 0 (-DRULE_COMBINE,
//   ops/packed_sweep.py:combine_define; plane 0 stands for the cell's
//   liveness, since a dead or live cell has every higher plane clear).  The
//   network gives `net`: birth(t) on a dead cell, survive(t) on a live one
//   (birth alone where the rule has no survival, and WireWorld's excite).
//   At m = 2 each next plane is then one LOP3 of (net, p0, p1) whose table
//   is computed at compile time from the formulas above for all four plane
//   encodings; deeper, y1 = inc1 & ~to_one, y0 = to_one | (~p0 & ~z & ~wrap)
//   and y_j = (p_j ^ carry_j) & ~wrap (z: planes 1.. clear), each ~wrap
//   dropped where the increment of S-1 clears that plane by itself.
// - A wavefront, no barrier.  A block is one warp that streams down a strip
//   of TILE_ROWS output rows, one word a lane (30 of its 32 written; the
//   outer word on each side is halo, and one word holds the k <= 31 steps
//   of the garbage front of an unfed edge): a wavefront of k levels, level
//   j turning rows of generation j-1 into generation j, each level keeping
//   the alive plane's row sums (s, c) of the two rows above its output and
//   the m plane words of that row.  Only the alive plane is shuffled.
// - Skewed levels in registers, or a ring in shared memory, by depth and m.
//   While the levels fit (4 + 2m registers each: m = 2 to k = 20, m = 8 to
//   k = 6) they run skewed: level j takes the row level j-1 emitted one
//   step earlier, so the k levels of a step are independent and their
//   shuffles and logic chains overlap instead of waiting on one another (a
//   warp has no other word to hide them behind); the pipeline's fill grows
//   from 2k to 3k - 1 rows per strip.  Deeper, the levels run in order and
//   each level's centre planes sit in a ring in shared memory that only
//   its own lane reads and refills, one step later, so no barrier is
//   needed: 200 registers a thread at m = 2, k = 31, no spill.  k is a
//   template parameter (one kernel per depth, dispatched at launch) and
//   the row loop is unrolled by three, so the rotation of the rows is
//   renaming.
// - Every three-input function is one LOP3 written in PTX.
// - 32-bit indices, wraps by compare: every index is taken modulo the torus
//   once per strip (any H >= 1 and W/32 >= 1 evolve as the periodic
//   extension of the torus), each next row wraps by a compare, and three
//   input rows of every plane are loaded ahead into registers.
//
// Tiles: TILE_ROWS output rows per block (a strip), default 192, chosen by
// `tune` (runtime/autotune.py) on an H100 at 700 W (PERF.md).  `tune` and
// `run --pallas-block-rows B` rebuild with -DTILE_ROWS=B; the launch refuses
// a board whose strips would pass the grid's 65535 rows of blocks
// (ops/gen_sweep.py:tile_fits says which).

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#ifndef TILE_ROWS
#define TILE_ROWS 192  // output rows per block
#endif
#if !defined(RULE_BIRTH) || !defined(RULE_SURVIVE1) || !defined(RULE_STATES)
#error "build with -DRULE_BIRTH=<mask> -DRULE_SURVIVE1=<mask> -DRULE_STATES=<S> (ops/gen_sweep.py:library_defines)"
#endif
#ifndef RULE_WIREWORLD
#define RULE_WIREWORLD 0
#endif

namespace {

// The design's threshold: the levels run skewed, every one in registers,
// while they and the rows loaded ahead take at most kSkewRegs registers,
// (4 + 2m) k + 6m.  It was chosen against other values on an H100 at 700 W
// (PERF.md, "designs tried").
constexpr int kSkewRegs = 172;

constexpr int kMaxSteps = 31;  // one halo word per side holds k <= 31
constexpr int kMaxGridRows = 65535;
constexpr unsigned kBirth = RULE_BIRTH;
constexpr unsigned kSurvive1 = RULE_SURVIVE1;
constexpr unsigned kStates = RULE_STATES;
constexpr bool kWire = RULE_WIREWORLD != 0;

__host__ __device__ constexpr int planes_for(unsigned states) {
  int m = 0;
  while ((1u << m) < states) ++m;
  return m;
}
constexpr int kM = planes_for(kStates);
static_assert(TILE_ROWS >= 1, "tile variant out of range");
static_assert(kStates >= 3 && kStates <= 255, "the plane sweep takes 3..255 states");
static_assert(!kWire || (kStates == 4 && kSurvive1 == 0), "WireWorld is 4 states, no survival");
static_assert(kBirth < 1024 && kSurvive1 < 1024 && (kSurvive1 & 1u) == 0,
              "rule masks out of range");
// `net` is needed on dead cells only: no live cell survives (or WireWorld).
constexpr bool kDeadOnly = kWire || kSurvive1 == 0;

// Skewed, with every level in registers (m = 2: k <= 20, m = 8: k <= 6);
// deeper, unskewed with the centre planes in the lane's shared-memory ring.
__host__ __device__ constexpr bool skewed(int k) {
  return (4 + 2 * kM) * k + 6 * kM <= kSkewRegs;
}
__host__ __device__ constexpr int ring_words(int k) { return skewed(k) ? 1 : k * kM * 32; }
constexpr int kSpan = 30;  // words a warp writes: its 32 less a halo word a side

__host__ __device__ constexpr unsigned bit(unsigned mask, int n) { return (mask >> n) & 1u; }
// LOP3 tables over (b2, b1, b0): bit t is birth / survival at count t mod 8.
// A live cell's count is 1..9, so survival's entry 0 stands for 8.
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
constexpr bool kBirthEight = bit(kBirth, 8) != bit(kBirth, 0);
constexpr bool kSurviveNine = bit(kSurvive1, 9) != bit(kSurvive1, 1);
// The rule's fewest-LOP3 network, as csrc/packed_sweep.cu reads it: a
// first LOP3 (table bits 0-7) over signals i, j, k (bits 8, 11, 14; 0-3 the
// count bits b0-b3, 4 plane 0) and, if bit 31 is set, a second (table bits
// 17-24) over the first and signals a, b (bits 25, 28).
#ifdef RULE_COMBINE
constexpr bool kNetwork = true;
constexpr uint32_t kNet = RULE_COMBINE;
#else
constexpr bool kNetwork = false;
constexpr uint32_t kNet = 0;
#endif

// Bit `plane` of a cell's next state from its state and `net`, by the
// plane formulas (every m-bit encoding, valid or not).
__host__ __device__ constexpr unsigned next_bit(int plane, unsigned state, bool net) {
  const bool dead = state == 0;
  const bool to_one = (dead || (state == 1 && !kDeadOnly)) && net;
  const bool advance = !dead && !to_one && state != kStates - 1;
  const unsigned next = to_one ? 1u : advance ? state + 1 : 0u;
  return (next >> plane) & 1u;
}
// At m = 2: the LOP3 table of next plane `plane` over (net, p0, p1).
__host__ __device__ constexpr unsigned table2(int plane) {
  unsigned lut = 0;
  for (int n = 0; n < 2; ++n)
    for (int p0 = 0; p0 < 2; ++p0)
      for (int p1 = 0; p1 < 2; ++p1)
        lut |= next_bit(plane, p0 | p1 << 1, n) << (4 * n + 2 * p0 + p1);
  return lut;
}
// Deeper: does the increment of S-1 leave plane j set, so that plane j
// needs the wrap mask?
__host__ __device__ constexpr bool wraps(int j) { return bit(kStates, j) != 0; }

// One three-input logic function by its LOP3 table (a -> 0xF0, b -> 0xCC,
// c -> 0xAA), as one instruction: written as and/or terms, ptxas splits a
// majority into four.
template <unsigned L>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(r) : "r"(a), "r"(b), "r"(c), "n"(L));
  return r;
}

// Bits where the m-bit state equals V.
template <unsigned V>
__device__ __forceinline__ uint32_t eq_const(const uint32_t (&p)[kM]) {
  if constexpr (kM == 2) {
    constexpr unsigned l0 = (V & 1u) ? 0xF0 : 0x0F, l1 = (V & 2u) ? 0xCC : 0x33;
    return lop3<l0 & l1>(p[0], p[1], p[1]);
  } else {
    uint32_t t = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < kM; ++j) t &= ((V >> j) & 1u) ? p[j] : ~p[j];
    return t;
  }
}

// `net` from the count bits and plane 0 of the centre.
__device__ __forceinline__ uint32_t combine(uint32_t b0, uint32_t b1, uint32_t b2,
                                            uint32_t b3, uint32_t p0) {
  if constexpr (kNetwork) {
    const uint32_t signal[5] = {b0, b1, b2, b3, p0};
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
    if constexpr (kDeadOnly) {
      return born;
    } else {
      uint32_t stays = lop3<survive_lut()>(b2, b1, b0);
      if (kSurviveNine) stays ^= b3 & b0;
      return lop3<0xCA>(p0, stays, born);  // p0 ? stays : born
    }
  }
}

// The next planes y of a word from its centre planes x and the alive
// plane's row sums of its rows N, C, S (s + 2c per cell, centre included).
__device__ __forceinline__ void next_planes(const uint32_t (&x)[kM], uint32_t sN,
                                            uint32_t cN, uint32_t sC, uint32_t cC,
                                            uint32_t sS, uint32_t cS,
                                            uint32_t (&y)[kM]) {
  const uint32_t b0 = lop3<0x96>(sN, sC, sS);  // xor
  const uint32_t p1 = lop3<0xE8>(sN, sC, sS);  // majority: the s carry
  const uint32_t q0 = lop3<0x96>(cN, cC, cS);
  const uint32_t q1 = lop3<0xE8>(cN, cC, cS);
  const uint32_t b1 = p1 ^ q0;
  const uint32_t b2 = lop3<0x78>(q1, p1, q0);  // q1 ^ (p1 & q0)
  const uint32_t b3 = lop3<0x80>(q1, p1, q0);
  const uint32_t net = combine(b0, b1, b2, b3, x[0]);
  if constexpr (kWire) {
    y[0] = x[1];
    y[1] = lop3<0x7C>(x[0], x[1], net);  // (p0 ^ p1) | (p0 & p1 & ~excite)
  } else if constexpr (kM == 2) {
    y[0] = lop3<table2(0)>(net, x[0], x[1]);
    y[1] = lop3<table2(1)>(net, x[0], x[1]);
  } else {
    uint32_t z = ~x[1];
#pragma unroll
    for (int j = 2; j < kM; ++j) z &= ~x[j];
    const uint32_t wrap = eq_const<kStates - 1>(x);
    const uint32_t to_one = kDeadOnly ? (z & ~x[0] & net) : (z & net);
    uint32_t rest = ~x[0] & ~z;
    if (wraps(0)) rest &= ~wrap;
    y[0] = to_one | rest;
    uint32_t inc = x[1] ^ x[0];
    if (wraps(1)) inc &= ~wrap;
    y[1] = kDeadOnly ? inc : inc & ~to_one;
    uint32_t carry = x[0] & x[1];
#pragma unroll
    for (int j = 2; j < kM; ++j) {
      inc = x[j] ^ carry;
      if (wraps(j)) inc &= ~wrap;
      y[j] = inc;
      carry &= x[j];
    }
  }
}

// One step of the wavefront for every level: level j takes a row of
// generation j-1 and emits generation j of the row above it.  Skewed, it
// takes the row level j-1 emitted one step earlier (`pend`), so the K
// levels of a step depend on nothing of each other and their shuffles and
// logic chains overlap; the levels run deepest first so that each reads
// `pend` before the level below refills it.  Unskewed, it takes the row
// level j-1 emitted this step (in `v`).  `v` brings the input row and
// takes generation K.  Slot U of each level's three-row ring takes its
// incoming row; (U+1)%3 holds the alive row sums of the row two above,
// (U+2)%3 those of the row above and its planes (in `x`, or unskewed in the
// lane's shared ring, which the level reads and refills in one go).
template <int K, int U>
__device__ __forceinline__ void advance(uint32_t (&v)[kM], uint32_t (&pend)[K][kM],
                                        uint32_t (&s)[3][K], uint32_t (&c)[3][K],
                                        uint32_t (&x)[3][K][kM], uint32_t *lane_ring) {
  constexpr int A = (U + 1) % 3, B = (U + 2) % 3;
  constexpr bool SKEW = skewed(K);
  uint32_t in[kM];
#pragma unroll
  for (int p = 0; p < kM; ++p) in[p] = v[p];
#pragma unroll
  for (int level = 0; level < K; ++level) {
    const int j = SKEW ? K - 1 - level : level;
    uint32_t row[kM], centre[kM], out[kM];
#pragma unroll
    for (int p = 0; p < kM; ++p) row[p] = j == 0 ? in[p] : SKEW ? pend[j][p] : v[p];
    const uint32_t live = eq_const<1u>(row);
    // Lane 0's west and lane 31's east neighbours are their own words: the
    // unfed halo edge, whose garbage never reaches a written word.
    const uint32_t west = __shfl_up_sync(0xffffffffu, live, 1);
    const uint32_t east = __shfl_down_sync(0xffffffffu, live, 1);
    const uint32_t w = __funnelshift_l(west, live, 1);
    const uint32_t e = __funnelshift_r(live, east, 1);
    const uint32_t sv = lop3<0x96>(live, w, e);
    const uint32_t cv = lop3<0xE8>(live, w, e);
#pragma unroll
    for (int p = 0; p < kM; ++p) {
      if constexpr (SKEW) {
        centre[p] = x[B][j][p];
        x[U][j][p] = row[p];
      } else {
        centre[p] = lane_ring[(j * kM + p) * 32];
        lane_ring[(j * kM + p) * 32] = row[p];
      }
    }
    next_planes(centre, s[A][j], c[A][j], s[B][j], c[B][j], sv, cv, out);
    s[U][j] = sv;
    c[U][j] = cv;
#pragma unroll
    for (int p = 0; p < kM; ++p) {
      if (SKEW && j < K - 1) {
        pend[j + 1][p] = out[p];
      } else {
        v[p] = out[p];
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(32)
gen_sweep_kernel(const uint32_t *__restrict__ in, uint32_t *__restrict__ out,
                 int H, int NW) {
  static_assert(ring_words(K) * 4 <= 48 * 1024, "ring past static shared memory");
  __shared__ uint32_t shared_ring[ring_words(K)];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kSpan;  // first written word of the strip
  const int r0 = blockIdx.y * TILE_ROWS;
  const int rows = min(TILE_ROWS, H - r0);
  constexpr int kDelay = skewed(K) ? 3 * K - 1 : 2 * K;  // step of output row r0
  const int steps = rows + kDelay;
  const size_t plane = (size_t)H * NW;

  // The lane's word: its torus column (wrapped once) and whether it writes
  // it (not a halo word, not past the board).
  const int word = c0 - 1 + lane;
  int col = word % NW;
  if (col < 0) col += NW;
  const bool writes = lane >= 1 && lane <= kSpan && word < NW;
  int g = (r0 - K) % H;  // next input row
  if (g < 0) g += H;

  uint32_t s[3][K] = {}, c[3][K] = {};
  uint32_t x[3][K][kM] = {}, pend[K][kM] = {};  // unused, and dropped, unskewed
  uint32_t *lane_ring = shared_ring + lane;
  if constexpr (!skewed(K)) {
    for (int e = 0; e < K * kM; ++e) lane_ring[e * 32] = 0;
  }
  uint32_t ahead[3][kM];
#pragma unroll
  for (int u = 0; u < 3; ++u) {
#pragma unroll
    for (int p = 0; p < kM; ++p) ahead[u][p] = in[p * plane + (size_t)g * NW + col];
    if (++g == H) g = 0;
  }

  // Step t takes input row r0 - K + t and emits generation K of row
  // r0 + t - kDelay, written from t = kDelay on.
  for (int t = 0; t < steps; t += 3) {
    uint32_t v[3][kM];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
#pragma unroll
      for (int p = 0; p < kM; ++p) {
        v[u][p] = ahead[u][p];
        ahead[u][p] = in[p * plane + (size_t)g * NW + col];
      }
      if (++g == H) g = 0;
    }
#define GEN_STEP(U)                                                         \
  advance<K, U>(v[U], pend, s, c, x, lane_ring);                            \
  if (t + U >= kDelay && writes) {                                          \
    uint32_t *cell = out + (size_t)(r0 + t + U - kDelay) * NW + word;       \
    _Pragma("unroll") for (int p = 0; p < kM; ++p) cell[p * plane] = v[U][p]; \
  }
    GEN_STEP(0)
    if (t + 1 >= steps) break;
    GEN_STEP(1)
    if (t + 2 >= steps) break;
    GEN_STEP(2)
#undef GEN_STEP
  }
}

using Kernel = void (*)(const uint32_t *, uint32_t *, int, int);

template <size_t... I>
Kernel kernel_of_depth(int k, std::index_sequence<I...>) {
  static const Kernel table[] = {gen_sweep_kernel<int(I) + 1>...};
  return table[k - 1];
}

}  // namespace

// Launch one k-generation sweep of the (m, H, NW) planes `in` into the
// distinct buffer `out` on `stream`.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take
// (m not this library's plane count, k out of range, a board whose strips
// would pass the grid's rows of blocks).
extern "C" int gen_sweep_launch(const void *in, void *out, int m, int H, int NW,
                                int k, void *stream) {
  if (in == out || m != kM || H < 1 || NW < 1 || k < 1 || k > kMaxSteps ||
      (H + TILE_ROWS - 1) / TILE_ROWS > kMaxGridRows) {
    return (int)cudaErrorInvalidValue;
  }
  const Kernel kernel = kernel_of_depth(k, std::make_index_sequence<kMaxSteps>());
  const dim3 grid((NW + kSpan - 1) / kSpan, (H + TILE_ROWS - 1) / TILE_ROWS);
  kernel<<<grid, 32, 0, (cudaStream_t)stream>>>((const uint32_t *)in,
                                                (uint32_t *)out, H, NW);
  return (int)cudaGetLastError();
}

// The rule and tile this library was built for, for the wrapper to check
// against the rule it launches.
extern "C" void gen_sweep_variant(unsigned *birth, unsigned *survive1,
                                  unsigned *states, int *wire, int *tile_rows) {
  *birth = kBirth;
  *survive1 = kSurvive1;
  *states = kStates;
  *wire = kWire;
  *tile_rows = TILE_ROWS;
}
