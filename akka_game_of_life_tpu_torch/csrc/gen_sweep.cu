// Temporally blocked Generations / WireWorld plane sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel akka_game_of_life_tpu/ops/pallas_gen.py:gen_sweep_fn,
// i.e. ops/pallas_stencil.py:temporal_sweep_planes_fn at m = ceil(log2 S)
// planes with body bitpack_gen.step_gen_padded_rows_planes: k generations of
// m lock-step (H, W/32) planes of LSB-first 32-bit words, one read and one
// write of every plane per sweep.
//
// Design: csrc/packed_sweep.cu's tile carried to m planes.  A block owns
// tile_rows(m) x 30 output words of every plane.  It loads (tile_rows(m) + 2k)
// rows x 32 words of each plane, every index wrapped modulo H and W/32 (one
// halo word per side holds k <= 31: the garbage front at an unfed edge moves
// one bit per generation), steps k generations in shared memory with two
// buffers, and writes the centre rows and words of each plane back.  A warp
// holds one 32-word row (lane = word column, west/east words by __shfl) and
// walks a strip of rows, keeping the row triple sums of the alive plane of
// rows r-1, r, r+1 and the m centre words in registers.
//
// Shared memory is 2 buffers x m planes x (tile_rows(m) + 2k) rows x 128 B, so
// the tile shrinks with m: tile_rows(m) = kRowBudget / m keeps a block near
// 76 KB at k = 10 for every m (three blocks per SM) and lets the deepest
// sweep, k = 31, fit the 227 KB a block may opt into at every m <= 8 (a
// static_assert per instance holds it).  The launch refuses k > 31.
//
// The step is the plane formulas of bitpack_gen, not a per-cell state
// machine, so plane values that encode no state of the rule evolve exactly
// as in the plain version:
//   alive = (state == 1), the Moore count of alive (centre included, 0..9);
//   Generations: to_one = dead & birth(count) | alive & survive(count),
//     advance = ~dead & ~to_one & ~(state == S-1), next = to_one ? 1 :
//     advance ? state + 1 : 0 (ripple carry over the planes);
//   WireWorld: p0' = p1, p1' = (p0 ^ p1) | (p0 & p1 & ~excite(count)),
//     where excite has no self term (a conductor is not a head).
// The rule is data: bit n of `birth` (excite) is set iff count n gives a
// birth, bit n of `survive1` iff a live cell whose count (self included) is
// n survives; S and a WireWorld flag complete it.  One build serves every
// rule; a template instance per m = 2..8 keeps the planes in registers.
//
// Bound on the H100: per sweep the m planes are read and written once
// (2 x 2 x 512 MiB for Brian's Brain at 65536^2, 0.64 ms at 3.35 TB/s);
// per word per generation the step costs some 15-25 LOP3/SHF instructions
// (ops/gen_sweep.py:ops_per_word_step), so from k of a few on the
// operations bound it, as for the binary sweep.  This first kernel is simple:
// the count predicates are evaluated from the rule masks for all ten counts,
// and 2 of a warp's 32 lanes produce no output word.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kRowBudget = 256;  // output rows per block times planes
constexpr int kStrips = 8;  // warps per block; each walks a strip of the tile's rows
constexpr int kTileCols = 32;  // words per shared-memory row (one warp)
constexpr int kOutCols = kTileCols - 2;
constexpr int kMaxSteps = 31;  // one halo word per side holds k <= 31
constexpr size_t kSmemLimit = 232448;  // 227 KB: a block's opt-in maximum

__host__ __device__ constexpr int tile_rows(int m) { return kRowBudget / m; }

__host__ __device__ constexpr size_t smem_bytes(int m, int k) {
  return 2ull * m * (tile_rows(m) + 2 * k) * kTileCols * sizeof(uint32_t);
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

// Bits where the m-bit state equals `value`.
template <int M>
__device__ __forceinline__ uint32_t eq_const(const uint32_t (&p)[M], uint32_t value) {
  uint32_t t = 0xffffffffu;
#pragma unroll
  for (int j = 0; j < M; ++j) t &= ((value >> j) & 1u) ? p[j] : ~p[j];
  return t;
}

template <int M>
__device__ __forceinline__ void load_row(const uint32_t *buf, size_t plane_elems,
                                         int r, uint32_t (&p)[M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) p[j] = buf[j * plane_elems + r * kTileCols + threadIdx.x];
}

// Next planes of one row from its centre planes x and the row sums of the
// alive plane in rows r-1 (N), r (C), r+1 (S).
template <int M>
__device__ __forceinline__ void step_row(
    const uint32_t (&x)[M], uint32_t sN, uint32_t cN, uint32_t sC, uint32_t cC,
    uint32_t sS, uint32_t cS, const uint32_t (&bmask)[10],
    const uint32_t (&smask)[10], uint32_t wrap_state, int wire,
    uint32_t (&y)[M]) {
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
  // One-hot count planes from two 2-bit decoders (count <= 9).
  const uint32_t lo[4] = {~b1 & ~b0, ~b1 & b0, b1 & ~b0, b1 & b0};
  const uint32_t hi[3] = {~b3 & ~b2, ~b3 & b2, b3 & ~b2};
  uint32_t born = 0, kept = 0;
#pragma unroll
  for (int n = 0; n < 10; ++n) {
    const uint32_t t = hi[n >> 2] & lo[n & 3];
    born |= t & bmask[n];
    kept |= t & smask[n];
  }
  if constexpr (M == 2) {
    if (wire) {
      y[0] = x[1];
      y[1] = (x[0] ^ x[1]) | (x[0] & x[1] & ~born);
      return;
    }
  }
  const uint32_t alive = eq_const<M>(x, 1u);
  const uint32_t dead = eq_const<M>(x, 0u);
  const uint32_t wrap = eq_const<M>(x, wrap_state);
  const uint32_t to_one = (dead & born) | (alive & kept);
  const uint32_t advance = ~dead & ~to_one & ~wrap;
  uint32_t carry = x[0];
  y[0] = to_one | (advance & ~x[0]);
#pragma unroll
  for (int j = 1; j < M; ++j) {
    y[j] = advance & (x[j] ^ carry);
    carry &= x[j];
  }
}

template <int M>
__global__ void __launch_bounds__(kTileCols * kStrips)
gen_sweep_kernel(const uint32_t *__restrict__ in, uint32_t *__restrict__ out,
                 int H, int NW, int k, uint32_t birth, uint32_t survive1,
                 uint32_t wrap_state, int wire) {
  constexpr int T = tile_rows(M);
  extern __shared__ uint32_t smem[];
  const int R = T + 2 * k;
  const size_t plane_elems = (size_t)R * kTileCols;
  uint32_t *cur = smem;
  uint32_t *nxt = smem + M * plane_elems;

  const int lane = threadIdx.x;
  const int strip = threadIdx.y;
  const long long row0 = (long long)blockIdx.x * T;
  const long long col0 = (long long)blockIdx.y * kOutCols;
  const size_t plane_stride = (size_t)H * NW;

  uint32_t bmask[10], smask[10];
#pragma unroll
  for (int n = 0; n < 10; ++n) {
    bmask[n] = ((birth >> n) & 1u) ? 0xffffffffu : 0u;
    smask[n] = ((survive1 >> n) & 1u) ? 0xffffffffu : 0u;
  }

  // Load with wrap: row row0-k+r, word column col0-1+lane, modulo the torus.
  const long long gcol = ((col0 - 1 + lane) % NW + NW) % NW;
  for (int r = strip; r < R; r += kStrips) {
    const long long grow = ((row0 - k + r) % H + H) % H;
    const size_t src = (size_t)grow * NW + gcol;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      cur[j * plane_elems + r * kTileCols + lane] = in[j * plane_stride + src];
    }
  }
  __syncthreads();

  for (int step = 0; step < k; ++step) {
    // Rows valid before this step: [step, R-1-step]; compute
    // [step+1, R-2-step] into nxt, split in contiguous strips.
    const int first = step + 1;
    const int count = R - 2 - 2 * step;
    const int per = (count + kStrips - 1) / kStrips;
    const int a = first + strip * per;
    const int b = min(a + per, first + count);
    if (a < b) {
      uint32_t x[M], below[M], y[M];
      uint32_t sN, cN, sC, cC, sS, cS;
      load_row<M>(cur, plane_elems, a - 1, below);
      row_sums(eq_const<M>(below, 1u), sN, cN);
      load_row<M>(cur, plane_elems, a, x);
      row_sums(eq_const<M>(x, 1u), sC, cC);
      for (int r = a; r < b; ++r) {
        load_row<M>(cur, plane_elems, r + 1, below);
        row_sums(eq_const<M>(below, 1u), sS, cS);
        step_row<M>(x, sN, cN, sC, cC, sS, cS, bmask, smask, wrap_state, wire, y);
#pragma unroll
        for (int j = 0; j < M; ++j) {
          nxt[j * plane_elems + r * kTileCols + lane] = y[j];
          x[j] = below[j];
        }
        sN = sC; cN = cC; sC = sS; cC = cS;
      }
    }
    __syncthreads();
    uint32_t *t = cur; cur = nxt; nxt = t;
  }

  // Centre rows [k, k+T), centre lanes [1, 31), every plane.
  const long long out_col = col0 - 1 + lane;
  if (lane == 0 || lane == kTileCols - 1 || out_col >= NW) return;
  for (int r = strip; r < T; r += kStrips) {
    const long long grow = row0 + r;
    if (grow >= H) break;
    const size_t dst = (size_t)grow * NW + out_col;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      out[j * plane_stride + dst] = cur[j * plane_elems + (k + r) * kTileCols + lane];
    }
  }
}

// Per-instance, per-device flags of the shared-memory opt-in, under one
// lock.
constexpr int kMaxDevices = 64;
std::mutex opt_in_lock;

template <int M>
cudaError_t opt_in_on_current_device() {
  static bool opted_in_on[kMaxDevices];
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(opt_in_lock);
  if (!opted_in_on[dev]) {
    const cudaError_t set = cudaFuncSetAttribute(
        gen_sweep_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(M, kMaxSteps));
    if (set != cudaSuccess) return set;
    opted_in_on[dev] = true;
  }
  return cudaSuccess;
}

template <int M>
int launch(const void *in, void *out, int H, int NW, int k, unsigned birth,
           unsigned survive1, unsigned wrap_state, int wire, cudaStream_t stream) {
  static_assert(smem_bytes(M, kMaxSteps) <= kSmemLimit,
                "the deepest sweep does not fit this plane count");
  if (k > kMaxSteps) return (int)cudaErrorInvalidValue;
  // Shared memory past 48 KB is opted into for the deepest sweep, once per
  // instance and device: cudaFuncSetAttribute applies to the current device
  // only, and a mesh launches on every card it spans.
  const cudaError_t opted_in = opt_in_on_current_device<M>();
  if (opted_in != cudaSuccess) return (int)opted_in;
  constexpr int T = tile_rows(M);
  const dim3 grid((H + T - 1) / T, (NW + kOutCols - 1) / kOutCols);
  const dim3 block(kTileCols, kStrips);
  gen_sweep_kernel<M><<<grid, block, smem_bytes(M, k), stream>>>(
      (const uint32_t *)in, (uint32_t *)out, H, NW, k, birth, survive1,
      wrap_state, wire);
  return (int)cudaGetLastError();
}

int planes_for(unsigned states) {
  int m = 0;
  while ((1u << m) < states) ++m;
  return m;
}

}  // namespace

// Launch one k-generation sweep of the (m, H, NW) planes `in` into the
// distinct buffer `out` on `stream`.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take
// (m != ceil(log2 states), WireWorld not on 2 planes, k out of range).
extern "C" int gen_sweep_launch(const void *in, void *out, int m, int H, int NW,
                                int k, unsigned birth, unsigned survive1,
                                unsigned states, int wire, void *stream) {
  if (in == out || H < 1 || NW < 1 || k < 1 || states < 3 || states > 256 ||
      m != planes_for(states) || (wire && (m != 2 || states != 4))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned wrap = states - 1;
  switch (m) {
    case 2: return launch<2>(in, out, H, NW, k, birth, survive1, wrap, wire, s);
    case 3: return launch<3>(in, out, H, NW, k, birth, survive1, wrap, wire, s);
    case 4: return launch<4>(in, out, H, NW, k, birth, survive1, wrap, wire, s);
    case 5: return launch<5>(in, out, H, NW, k, birth, survive1, wrap, wire, s);
    case 6: return launch<6>(in, out, H, NW, k, birth, survive1, wrap, wire, s);
    case 7: return launch<7>(in, out, H, NW, k, birth, survive1, wrap, wire, s);
    case 8: return launch<8>(in, out, H, NW, k, birth, survive1, wrap, wire, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
