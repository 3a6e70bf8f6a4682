// One Larger-than-Life generation on an (H, W) uint8 torus, for Hopper
// (sm_90a): running sums in SIMD-within-a-register lanes, no barrier.
//
// Replaces the TPU kernel akka_game_of_life_tpu/ops/pallas_ltl.py:ltl_sweep_fn:
// the (2R+1)^2 box sum of the live cells (state 1), minus the centre, with
// birth/survive sets over 0..(2R+1)^2-1 applied, R <= 10; one read and one
// write of the board per generation.
//
// What bounds it on the H100.  A generation reads and writes the board once:
// 2 B per cell, 0.16 ms at 16384^2 and 3.35 TB/s.  The box sum as running
// sums along both axes needs about 9 integer operations per cell at any R
// (ops/ltl_sweep.py:ops_per_cell), 0.14 ms at 16384^2, so the bytes bound it,
// with the integer pipe close behind.  So every cell is touched as a lane of
// a 32-bit word, and nothing waits on a barrier:
//
// - A block is one warp; each lane owns a run of 16 consecutive cells of a
//   row (one 16-byte load and store) and streams down TILE_ROWS rows.  The
//   warp holds 512 columns, of which the outer run on each side is halo
//   (16 >= R) and 480 are written.
// - Vertical: the lane keeps the (2R+1)-row column sums of its 16 cells in
//   four words of byte lanes (a column sum is at most 21), so one add of the
//   entering row and one subtract of the leaving row advance 4 columns.  The
//   rows in the window are kept, already turned into 0/1 bytes of "state 1",
//   in a ring of 2R+1 slots in shared memory that only the lane itself reads
//   (no barrier), so each board row is loaded once per strip.
// - Horizontal: the R column sums past each end of the run come from the
//   neighbouring lanes by __shfl; the (2R+1)-wide sums are built by doubling
//   (widths 1, 2, 4, 8, 16: one funnel shift and one add per word each) and
//   the binary digits of 2R+1 add up the box.  Lanes are bytes while the box
//   stays below 128 (R <= 5, bugs included) and 16 bits past that.
// - The rule as ranges: birth and survive sets are runs of counts, compared
//   per lane with two subtracts on words whose lane tops are set (count >= lo
//   and not count >= hi + 1), read from a small table the wrapper uploads,
//   so bugs' one run each costs three operations per word and set.
// - 32-bit indices, each wrapped modulo the torus once per strip and each
//   next row by a compare, so any H and any W work (also W < 2R+1, whose
//   window is the periodic extension); a row whose width or addresses are not
//   a multiple of 16 bytes loads and stores byte by byte.
//
// R is a template parameter (one kernel per radius and alignment, picked at
// launch).  Tiles: TILE_ROWS output rows per block, default 48, chosen by
// `tune` (runtime/autotune.py) on an H100 at 700 W (PERF.md); `tune` and
// `run --pallas-block-rows B` rebuild with -DTILE_ROWS=B, and the launch
// refuses a board whose strips would pass the grid's 65535 rows of blocks
// (ops/ltl_sweep.py:tile_fits).

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#ifndef TILE_ROWS
#define TILE_ROWS 48  // output rows per block
#endif

namespace {

constexpr int kRun = 16;            // cells per lane
constexpr int kSpan = 30 * kRun;    // written columns per warp
constexpr int kMaxRadius = 10;
constexpr int kMaxGridRows = 65535;
static_assert(TILE_ROWS >= 1, "tile variant out of range");
static_assert(kRun >= kMaxRadius, "one neighbouring lane holds the halo");

// The lanes of radius R: LB bits each, CPW per word, NOWN words per run, L
// halo words a side from the neighbouring lanes, NE words in all.
template <int R>
struct Lanes {
  static constexpr int D = 2 * R + 1;
  static constexpr int LB = D * D < 128 ? 8 : 16;
  static constexpr int CPW = 32 / LB;
  static constexpr int NOWN = kRun / CPW;
  static constexpr int L = (R + CPW - 1) / CPW;
  static constexpr int NE = NOWN + 2 * L;
  static constexpr uint32_t ONES = LB == 8 ? 0x01010101u : 0x00010001u;
  static constexpr uint32_t HIGH = ONES << (LB - 1);
  static constexpr int TOP = D >= 16 ? 4 : D >= 8 ? 3 : D >= 4 ? 2 : D >= 2 ? 1 : 0;
};

// Byte-wise (v == 1): 1 where a byte is 1, else 0.
__device__ __forceinline__ uint32_t ones_of(uint32_t v) {
  const uint32_t z = v ^ 0x01010101u;
  const uint32_t nonzero = ((z & 0x7f7f7f7fu) + 0x7f7f7f7fu) | z;
  return (~nonzero >> 7) & 0x01010101u;
}

// The word whose first lane is lane p of the stream a (zero past its end).
template <int LB, int N>
__device__ __forceinline__ uint32_t lanes_at(const uint32_t (&a)[N], int p) {
  constexpr int CPW = 32 / LB;
  const int q = p / CPW, r = p % CPW;
  const uint32_t lo = q < N ? a[q] : 0u;
  const uint32_t hi = q + 1 < N ? a[q + 1] : 0u;
  return r == 0 ? lo : __funnelshift_r(lo, hi, r * LB);
}

template <bool kAligned>
__device__ __forceinline__ void load_run(const uint8_t *row, int col, int W,
                                         uint32_t (&v)[4]) {
  if (kAligned) {
    const uint4 q = *reinterpret_cast<const uint4 *>(row + col);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t w = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int c = col + 4 * i + b;
        while (c >= W) c -= W;
        w |= uint32_t(row[c]) << (8 * b);
      }
      v[i] = w;
    }
  }
}

template <bool kAligned>
__device__ __forceinline__ void store_run(uint8_t *row, int col, int W,
                                          const uint32_t (&v)[4]) {
  if (kAligned) {
    uint4 q;
    q.x = v[0]; q.y = v[1]; q.z = v[2]; q.w = v[3];
    *reinterpret_cast<uint4 *>(row + col) = q;
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (col + i < W) row[col + i] = uint8_t(v[i / 4] >> (8 * (i % 4)));
    }
  }
}

// The next states of the lane's run from its column sums (bytes), its
// centre cells (0/1 bytes) and the rule's ranges over the box count
// (centre included): [n_birth, n_survive, then lo, hi + 1 per range].
template <int R>
__device__ __forceinline__ void next_run(const uint32_t (&colsum)[4],
                                         const uint32_t (&centre)[4],
                                         const int *__restrict__ ranges,
                                         int n_birth, int n_survive,
                                         uint32_t (&res)[4]) {
  using Ln = Lanes<R>;
  constexpr int LB = Ln::LB, CPW = Ln::CPW, NOWN = Ln::NOWN, L = Ln::L,
                NE = Ln::NE, D = Ln::D, TOP = Ln::TOP;
  uint32_t own[NOWN], alive[NOWN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (LB == 8) {
      own[i] = colsum[i];
      alive[i] = centre[i] << 7;
    } else {
      own[2 * i] = __byte_perm(colsum[i], 0, 0x4140);
      own[2 * i + 1] = __byte_perm(colsum[i], 0, 0x4342);
      alive[2 * i] = __byte_perm(centre[i], 0, 0x4140) << 15;
      alive[2 * i + 1] = __byte_perm(centre[i], 0, 0x4342) << 15;
    }
  }
  // The stream: L words of the lane before, the run, L words of the lane
  // after (lane 0's and lane 31's outer neighbours are their own: halo).
  uint32_t win[TOP + 1][NE];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    win[0][i] = __shfl_up_sync(0xffffffffu, own[NOWN - L + i], 1);
    win[0][L + NOWN + i] = __shfl_down_sync(0xffffffffu, own[i], 1);
  }
#pragma unroll
  for (int i = 0; i < NOWN; ++i) win[0][L + i] = own[i];
  // win[m][j]: lane q holds the sum of 2^m column sums from lane j*CPW + q.
#pragma unroll
  for (int m = 1; m <= TOP; ++m) {
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      win[m][j] = win[m - 1][j] + lanes_at<LB>(win[m - 1], j * CPW + (1 << (m - 1)));
    }
  }
  uint32_t box[NOWN];
#pragma unroll
  for (int o = 0; o < NOWN; ++o) {
    uint32_t acc = 0;
    int off = L * CPW + o * CPW - R;
#pragma unroll
    for (int m = TOP; m >= 0; --m) {
      if ((D >> m) & 1) {
        acc += lanes_at<LB>(win[m], off);
        off += 1 << m;
      }
    }
    box[o] = acc | Ln::HIGH;
  }
  uint32_t born[NOWN] = {}, stays[NOWN] = {};
  for (int i = 0; i < n_birth; ++i) {
    const uint32_t lo = uint32_t(ranges[2 + 2 * i]) * Ln::ONES;
    const uint32_t hi = uint32_t(ranges[3 + 2 * i]) * Ln::ONES;
#pragma unroll
    for (int o = 0; o < NOWN; ++o) born[o] |= (box[o] - lo) & ~(box[o] - hi);
  }
  const int *survive = ranges + 2 + 2 * n_birth;
  for (int i = 0; i < n_survive; ++i) {
    const uint32_t lo = uint32_t(survive[2 * i]) * Ln::ONES;
    const uint32_t hi = uint32_t(survive[2 * i + 1]) * Ln::ONES;
#pragma unroll
    for (int o = 0; o < NOWN; ++o) stays[o] |= (box[o] - lo) & ~(box[o] - hi);
  }
#pragma unroll
  for (int o = 0; o < NOWN; ++o) {
    born[o] = (((alive[o] & stays[o]) | (~alive[o] & born[o])) & Ln::HIGH) >> (LB - 1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (LB == 8) {
      res[i] = born[i];
    } else {
      res[i] = __byte_perm(born[2 * i], born[2 * i + 1], 0x6420);
    }
  }
}

template <int R, bool kAligned>
__global__ void __launch_bounds__(32)
ltl_sweep_kernel(const uint8_t *__restrict__ in, uint8_t *__restrict__ out,
                 int H, int W, const int *__restrict__ ranges) {
  constexpr int D = 2 * R + 1;
  extern __shared__ uint4 ring[];  // D slots of 32 lanes; each lane its own
  const int lane = threadIdx.x;
  const int x0 = blockIdx.x * kSpan;  // first written column of the strip
  const int r0 = blockIdx.y * TILE_ROWS;
  const int rows = min(TILE_ROWS, H - r0);
  const int run = x0 - kRun + lane * kRun;  // the lane's first column
  int col = run % W;
  if (col < 0) col += W;
  const bool writes = lane >= 1 && lane <= 30 && run < W;
  const int n_birth = ranges[0], n_survive = ranges[1];
  uint4 *slot = ring + lane;
  int g = (r0 - R) % H;  // next input row
  if (g < 0) g += H;

  // The window of output row 0: rows r0-R .. r0+R into slots 0 .. 2R.
  uint32_t colsum[4] = {};
  for (int s = 0; s < D; ++s) {
    uint32_t v[4];
    load_run<kAligned>(in + (size_t)g * W, col, W, v);
    if (++g == H) g = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = ones_of(v[i]);
      colsum[i] += v[i];
    }
    uint4 q;
    q.x = v[0]; q.y = v[1]; q.z = v[2]; q.w = v[3];
    slot[s * 32] = q;
  }
  uint32_t enter[4];  // row r0+y+R+1, loaded one row ahead
  load_run<kAligned>(in + (size_t)g * W, col, W, enter);
  if (++g == H) g = 0;
  int leave = 0, centre = R;  // slots of rows r0+y-R and r0+y
  for (int y = 0; y < rows; ++y) {
    const uint4 cq = slot[centre * 32];
    const uint32_t cw[4] = {cq.x, cq.y, cq.z, cq.w};
    uint32_t res[4];
    next_run<R>(colsum, cw, ranges, n_birth, n_survive, res);
    if (writes) store_run<kAligned>(out + (size_t)(r0 + y) * W, run, W, res);
    // Slide the window one row down.
    const uint4 lq = slot[leave * 32];
    const uint32_t lw[4] = {lq.x, lq.y, lq.z, lq.w};
    uint32_t e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = ones_of(enter[i]);
      colsum[i] += e[i] - lw[i];
    }
    uint4 q;
    q.x = e[0]; q.y = e[1]; q.z = e[2]; q.w = e[3];
    slot[leave * 32] = q;
    leave = leave + 1 == D ? 0 : leave + 1;
    centre = centre + 1 == D ? 0 : centre + 1;
    load_run<kAligned>(in + (size_t)g * W, col, W, enter);
    if (++g == H) g = 0;
  }
}

using Kernel = void (*)(const uint8_t *, uint8_t *, int, int, const int *);

template <size_t... I>
Kernel kernel_of(int R, bool aligned, std::index_sequence<I...>) {
  static const Kernel table[2][sizeof...(I)] = {
      {ltl_sweep_kernel<int(I) + 1, false>...},
      {ltl_sweep_kernel<int(I) + 1, true>...}};
  return table[aligned][R - 1];
}

}  // namespace

// Launch one generation of the (H, W) board `in` into the distinct buffer
// `out` on `stream`.  `ranges` is a device array: the number of birth and of
// survive ranges, then each range's lowest box count and one past its
// highest (box counts include the centre, so a survive count n is n + 1).
// `aligned` says that W and both buffers' addresses are multiples of 16.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int ltl_sweep_launch(const void *in, void *out, int H, int W, int R,
                                const void *ranges, int aligned, void *stream) {
  if (in == out || H < 1 || W < 1 || R < 1 || R > kMaxRadius || !ranges ||
      (H + TILE_ROWS - 1) / TILE_ROWS > kMaxGridRows ||
      (aligned && (W % 16 || (uintptr_t)in % 16 || (uintptr_t)out % 16))) {
    return (int)cudaErrorInvalidValue;
  }
  const Kernel kernel =
      kernel_of(R, aligned != 0, std::make_index_sequence<kMaxRadius>());
  const dim3 grid((W + kSpan - 1) / kSpan, (H + TILE_ROWS - 1) / TILE_ROWS);
  const size_t smem = (size_t)(2 * R + 1) * 32 * sizeof(uint4);
  kernel<<<grid, 32, smem, (cudaStream_t)stream>>>(
      (const uint8_t *)in, (uint8_t *)out, H, W, (const int *)ranges);
  return (int)cudaGetLastError();
}

// The tile this library was built for.
extern "C" int ltl_sweep_tile_rows(void) { return TILE_ROWS; }
