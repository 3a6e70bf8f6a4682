// Temporally blocked packed Life sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel akka_game_of_life_tpu/ops/pallas_stencil.py:
// packed_sweep_fn, i.e. temporal_sweep_planes_fn at one plane with body
// bitpack.step_padded_rows: k generations of a binary outer-totalistic rule on
// an (H, W/32) torus of LSB-first 32-bit words, one read and one write of the
// board per sweep.
//
// Design.  The TPU block spans whole rows; a 65536-wide row is 8 KiB, so
// b + 2k rows do not fit a useful block in 227 KB of shared memory.  Here a
// thread block owns a tile of TILE_ROWS x 30 output words.  It loads
// (TILE_ROWS + 2k) rows x 32 words (one halo word each side, enough for
// k <= 31 because the garbage front at an unfed edge moves one bit per step)
// with every index wrapped modulo H and modulo W/32, so any H and any W/32
// (even 1) evolve as the periodic extension of the torus.  The block then
// steps k times in shared memory, ping-ponging two buffers with
// __syncthreads() between steps; the valid slab shrinks by one row per side
// per step, and the centre TILE_ROWS x 30 words are written back.
//
// Threads: blockDim = (32, STRIPS).  A warp holds one row of the 32-word
// tile, lane = word column, so the west/east words come from the neighbouring
// lanes by __shfl (edge lanes see their own word: that is the unfed halo
// edge).  Each warp walks a strip of rows top to bottom and keeps the row
// triple sums (s, c) of rows r-1, r, r+1 in registers, so each row's sums are
// computed once and feed three output rows, as in bitpack.step_padded_rows.
//
// The rule is data: bit n of `birth` is set iff a dead cell with n live
// neighbours is born, bit n of `survive1` iff a live cell whose 9-cell count
// (centre included) is n survives.  One build serves every binary rule.
//
// Bound on the H100: a sweep reads and writes the board once (2 x 512 MiB at
// 65536^2, 0.32 ms at 3.35 TB/s) and needs, per word per generation, 12
// instructions for Conway in LOP3/SHF form (2 funnel shifts and 2 LOP3 for
// the row sums, 6 LOP3 for the count bits, 2 for the combine; 134M words x k
// generations at 64 per clock per SM); from k = 4 on the operations, not the
// bytes, bound it.  This first kernel is simple: the combine evaluates all ten
// count predicates from the rule masks where a rule-specialised one needs two
// LOP3 for Conway, and only 30 of a warp's 32 lanes produce output words.
//
// Tiles (chosen by the tile sweep in akka_game_of_life_tpu_torch/bench.py on
// an H100 at 700 W, see PERF.md): TILE_ROWS = 256 output rows and STRIPS = 8
// warps by default; the sweep rebuilds with -DTILE_ROWS=.. -DSTRIPS=.. .

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#ifndef TILE_ROWS
#define TILE_ROWS 256  // output rows per block
#endif
#ifndef STRIPS
#define STRIPS 8  // warps per block; each walks a strip of the tile's rows
#endif

namespace {

constexpr int kTileCols = 32;     // words per shared-memory row (one warp)
constexpr int kOutCols = kTileCols - 2;
constexpr int kMaxSteps = 31;     // one halo word per side holds k <= 31
static_assert(TILE_ROWS >= 1 && STRIPS >= 1 && STRIPS * kTileCols <= 1024,
              "tile variant out of range");

constexpr size_t smem_bytes(int k) {
  return 2ull * (TILE_ROWS + 2 * k) * kTileCols * sizeof(uint32_t);
}

__device__ __forceinline__ void row_sums(uint32_t x, uint32_t &s, uint32_t &c) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  uint32_t prev = __shfl_up_sync(full, x, 1);
  uint32_t next = __shfl_down_sync(full, x, 1);
  if (lane == 0) prev = x;
  if (lane == kTileCols - 1) next = x;
  const uint32_t w = (x << 1) | (prev >> 31);
  const uint32_t e = (x >> 1) | (next << 31);
  const uint32_t xw = x ^ w;
  s = xw ^ e;
  c = (x & w) | (e & xw);
}

__device__ __forceinline__ uint32_t next_state(
    uint32_t x, uint32_t sN, uint32_t cN, uint32_t sC, uint32_t cC,
    uint32_t sS, uint32_t cS, const uint32_t (&bmask)[10],
    const uint32_t (&smask)[10]) {
  const uint32_t sNC = sN ^ sC;
  const uint32_t b0 = sNC ^ sS;
  const uint32_t p1 = (sN & sC) | (sS & sNC);
  const uint32_t cNC = cN ^ cC;
  const uint32_t q0 = cNC ^ cS;
  const uint32_t q1 = (cN & cC) | (cS & cNC);
  const uint32_t b1 = p1 ^ q0;
  const uint32_t r2 = p1 & q0;
  const uint32_t b2 = q1 ^ r2;
  const uint32_t b3 = q1 & r2;
  // One-hot count planes from two 2-bit decoders (count <= 9, so the high
  // pair never reads 11).
  const uint32_t lo[4] = {~b1 & ~b0, ~b1 & b0, b1 & ~b0, b1 & b0};
  const uint32_t hi[3] = {~b3 & ~b2, ~b3 & b2, b3 & ~b2};
  const uint32_t nx = ~x;
  uint32_t alive = 0;
#pragma unroll
  for (int n = 0; n < 10; ++n) {
    alive |= hi[n >> 2] & lo[n & 3] & ((nx & bmask[n]) | (x & smask[n]));
  }
  return alive;
}

__global__ void packed_sweep_kernel(const uint32_t *__restrict__ in,
                                    uint32_t *__restrict__ out, int H, int NW,
                                    int k, uint32_t birth,
                                    uint32_t survive1) {
  extern __shared__ uint32_t smem[];
  const int R = TILE_ROWS + 2 * k;
  uint32_t *cur = smem;
  uint32_t *nxt = smem + R * kTileCols;

  const int lane = threadIdx.x;
  const int strip = threadIdx.y;
  const long long row0 = (long long)blockIdx.x * TILE_ROWS;
  const long long col0 = (long long)blockIdx.y * kOutCols;

  uint32_t bmask[10], smask[10];
#pragma unroll
  for (int n = 0; n < 10; ++n) {
    bmask[n] = ((birth >> n) & 1u) ? 0xffffffffu : 0u;
    smask[n] = ((survive1 >> n) & 1u) ? 0xffffffffu : 0u;
  }

  // Load with wrap: row row0-k+r, word column col0-1+lane, both modulo the
  // torus.
  const int gcol = (int)(((col0 - 1 + lane) % NW + NW) % NW);
  for (int r = strip; r < R; r += STRIPS) {
    const long long grow = ((row0 - k + r) % H + H) % H;
    cur[r * kTileCols + lane] = in[grow * NW + gcol];
  }
  __syncthreads();

  for (int step = 0; step < k; ++step) {
    // Rows valid before this step: [step, R-1-step]; compute
    // [step+1, R-2-step] into nxt, split in contiguous strips.
    const int first = step + 1;
    const int count = R - 2 - 2 * step;
    const int per = (count + STRIPS - 1) / STRIPS;
    const int a = first + strip * per;
    const int b = min(a + per, first + count);
    if (a < b) {
      uint32_t sN, cN, sC, cC, sS, cS;
      row_sums(cur[(a - 1) * kTileCols + lane], sN, cN);
      uint32_t x = cur[a * kTileCols + lane];
      row_sums(x, sC, cC);
      for (int r = a; r < b; ++r) {
        const uint32_t below = cur[(r + 1) * kTileCols + lane];
        row_sums(below, sS, cS);
        nxt[r * kTileCols + lane] =
            next_state(x, sN, cN, sC, cC, sS, cS, bmask, smask);
        sN = sC; cN = cC; sC = sS; cC = cS; x = below;
      }
    }
    __syncthreads();
    uint32_t *t = cur; cur = nxt; nxt = t;
  }

  // Centre rows [k, k+TILE_ROWS), centre lanes [1, 31).
  const long long out_col = col0 - 1 + lane;
  if (lane == 0 || lane == kTileCols - 1 || out_col >= NW) return;
  for (int r = strip; r < TILE_ROWS; r += STRIPS) {
    const long long grow = row0 + r;
    if (grow >= H) break;
    out[grow * NW + out_col] = cur[(k + r) * kTileCols + lane];
  }
}

// Per-device flags of the shared-memory opt-in, under one lock.
constexpr int kMaxDevices = 64;
std::mutex opt_in_lock;
bool opted_in_on[kMaxDevices];

cudaError_t opt_in_on_current_device() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(opt_in_lock);
  if (!opted_in_on[dev]) {
    const cudaError_t set = cudaFuncSetAttribute(
        packed_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxSteps));
    if (set != cudaSuccess) return set;
    opted_in_on[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

// Launch one k-generation sweep on `stream`.  `in` and `out` are distinct
// (H, NW) device buffers.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int packed_sweep_launch(const void *in, void *out, int H, int NW,
                                   int k, unsigned birth, unsigned survive1,
                                   void *stream) {
  if (in == out || H < 1 || NW < 1 || k < 1 || k > kMaxSteps) {
    return (int)cudaErrorInvalidValue;
  }
  // Shared memory past 48 KB is opted into for the deepest sweep, once per
  // device: cudaFuncSetAttribute applies to the current device only, and a
  // mesh launches on every card it spans.
  const cudaError_t opted_in = opt_in_on_current_device();
  if (opted_in != cudaSuccess) return (int)opted_in;
  const dim3 grid((H + TILE_ROWS - 1) / TILE_ROWS,
                  (NW + kOutCols - 1) / kOutCols);
  const dim3 block(kTileCols, STRIPS);
  packed_sweep_kernel<<<grid, block, smem_bytes(k), (cudaStream_t)stream>>>(
      (const uint32_t *)in, (uint32_t *)out, H, NW, k, birth, survive1);
  return (int)cudaGetLastError();
}
