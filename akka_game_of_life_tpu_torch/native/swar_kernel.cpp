// Native SWAR stepper for binary life-like rules — the host-CPU twin of the
// device bit-packed kernel (ops/bitpack.py): 64 cells per uint64 lane,
// carry-save-adder Moore counts over shared per-row triple sums, B/S rule as
// count-equality predicate planes.
//
// Reference capability note: this is the same collapse of the per-cell actor
// protocol (the reference's CellActor.scala:63-89,
// NextStateCellGathererActor.scala:32-45) into pure arithmetic that the device
// kernels perform, compiled for the host so the cluster's CPU engine matches
// the reference's JVM-native runtime with machine code instead of actor
// message storms.
//
// Contract (mirrors runtime/backend._np_chunk): `swar_chunk` takes a
// width-`halo` padded slab (ph, pw) = (h + 2*halo, w + 2*halo) of 0/1 uint8
// cells and advances the (h, w) interior by `steps` <= halo generations,
// treating everything beyond the slab as dead.  Each step's garbage front
// moves one cell inward from the slab edge, so after `steps` steps the
// interior slice is exact — the same peeling argument as step_padded_np.
//
// Build: compiled into the shared native .so by native/__init__.py (g++ -O2,
// no external deps).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Planes {
  // Per-row bit planes with one guard word on each side (kept zero) so the
  // west/east cross-word shifts need no edge branches.
  int rows, words;
  std::vector<uint64_t> data;  // rows * (words + 2)

  Planes(int r, int w) : rows(r), words(w), data((size_t)r * (w + 2), 0) {}
  uint64_t* row(int r) { return data.data() + (size_t)r * (words + 2) + 1; }
  void clear() { std::fill(data.begin(), data.end(), 0); }
};

// Horizontal 3-cell full-adder planes for one row: s + 2c = west+center+east
// (center included — survive thresholds shift by +1, as in ops/bitpack.py).
inline void row_triple(const uint64_t* x, uint64_t* s, uint64_t* c, int words) {
  for (int i = 0; i < words; ++i) {
    uint64_t w = (x[i] << 1) | (x[i - 1] >> 63);
    uint64_t e = (x[i] >> 1) | (x[i + 1] << 63);
    uint64_t xw = x[i] ^ w;
    s[i] = xw ^ e;
    c[i] = (x[i] & w) | (e & xw);
  }
}

// Assemble count = (sN+sC+sS) + 2*(cN+cC+cS) — the 9-cell Moore sum as
// bit planes (b3, b2, b1, b0) — shared by both chunk kernels' combine
// loops (the C++ twin of ops/bitpack.py _count_bits).
inline void nine_sum(uint64_t sN, uint64_t sC, uint64_t sS, uint64_t cN,
                     uint64_t cC, uint64_t cS, uint64_t& b3, uint64_t& b2,
                     uint64_t& b1, uint64_t& b0) {
  uint64_t sNC = sN ^ sC;
  b0 = sNC ^ sS;
  uint64_t p1 = (sN & sC) | (sS & sNC);
  uint64_t cNC = cN ^ cC;
  uint64_t q0 = cNC ^ cS;
  uint64_t q1 = (cN & cC) | (cS & cNC);
  b1 = p1 ^ q0;
  uint64_t r2 = p1 & q0;
  b2 = q1 ^ r2;
  b3 = q1 & r2;
}

// Row-band parallelism: both per-step phases (triple sums; combine) are
// row-local over read-only inputs, so bands need no locks — only the join
// between phases (phase B reads neighbor rows' phase-A output).  Threads
// are (re)spawned per phase; at the slab sizes where threading is enabled
// the spawn cost is noise next to the band compute.

// Concurrent swar_chunk callers in this process (the in-process cluster
// harness runs several workers as threads): each sizes its pool against
// its share of the cores so N tiles don't spawn N * cores threads.
std::atomic<int> g_active_chunks{0};

inline int thread_count(int rows, int words) {
  if ((int64_t)rows * words < (1 << 14)) return 1;  // small slabs: spawn cost wins
  int t = (int)std::thread::hardware_concurrency();
  if (const char* env = std::getenv("GOL_SWAR_THREADS")) {
    int v = std::atoi(env);
    if (v > 0) t = v;
  }
  int sharers = std::max(1, g_active_chunks.load(std::memory_order_relaxed));
  return std::max(1, std::min({t / sharers, 16, rows / 8}));
}

template <typename Fn>
inline void parallel_rows(int rows, int threads, const Fn& fn) {
  if (threads <= 1) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  int band = (rows + threads - 1) / threads;
  try {
    // Bands 1..n on spawned threads; band 0 runs on the calling thread
    // below, so no core idles in join.
    for (int t = 1; t < threads; ++t) {
      int r0 = t * band, r1 = std::min(rows, r0 + band);
      if (r0 >= r1) break;
      pool.emplace_back([&, r0, r1] { fn(r0, r1); });
    }
  } catch (...) {
    // Thread creation failed (e.g. cgroup task limits): join whatever
    // started, then recompute everything serially — both phases write
    // deterministic values from read-only inputs, so overlapping
    // recomputation is idempotent and an exception never escapes the
    // extern "C" boundary.
    for (auto& th : pool) th.join();
    fn(0, rows);
    return;
  }
  fn(0, std::min(rows, band));
  for (auto& th : pool) th.join();
}


// Which counts the rule actually tests, mirroring ops/bitpack.py: birth
// tests count n directly; survive tests count n+1 (the live center is
// inside the 9-sum); a count in BOTH sets needs no center masking.
struct Need {
  int n;
  enum { ALWAYS, BIRTH, SURVIVE } kind;
};

struct NeedSet {
  std::vector<Need> needs;
  bool any_birth = false, any_survive = false;
};

inline NeedSet build_needs(uint32_t birth_mask, uint32_t survive_mask) {
  NeedSet ns;
  for (int n = 0; n <= 9; ++n) {
    bool b = (birth_mask >> n) & 1;
    bool s = n > 0 && ((survive_mask >> (n - 1)) & 1);
    if (b && s)
      ns.needs.push_back({n, Need::ALWAYS});
    else if (b) {
      ns.needs.push_back({n, Need::BIRTH});
      ns.any_birth = true;
    } else if (s) {
      ns.needs.push_back({n, Need::SURVIVE});
      ns.any_survive = true;
    }
  }
  return ns;
}

// RAII counter of concurrent chunk callers (thread_count divides the core
// budget by it).
struct ActiveGuard {
  ActiveGuard() { g_active_chunks.fetch_add(1, std::memory_order_relaxed); }
  ~ActiveGuard() { g_active_chunks.fetch_sub(1, std::memory_order_relaxed); }
};

}  // namespace

extern "C" void swar_chunk(const uint8_t* padded, int32_t ph, int32_t pw,
                           int32_t steps, int32_t halo,
                           uint32_t birth_mask, uint32_t survive_mask,
                           uint8_t* out) {
  const int words = (pw + 63) / 64;
  Planes cur(ph, words), next(ph, words);
  Planes S(ph, words), C(ph, words);

  // Pack the uint8 slab into LSB-first bitboards (bit i of word k = column
  // 64k + i), zeros beyond pw.
  for (int r = 0; r < ph; ++r) {
    const uint8_t* src = padded + (size_t)r * pw;
    uint64_t* dst = cur.row(r);
    for (int x = 0; x < pw; ++x)
      if (src[x]) dst[x >> 6] |= (uint64_t)1 << (x & 63);
  }

  // Predicate planes are only needed for counts the rule actually tests
  // (mirroring ops/bitpack.py, which builds eq(n) per masked count): for
  // Conway that is {3, 4} instead of all ten — roughly halving the hottest
  // loop's ALU work.  Precomputed once; the inner loop never consults the
  // runtime masks.
  // A count in BOTH sets makes the cell alive regardless of its current
  // state (count n = n neighbors when dead, n-1 when alive), so those
  // predicate planes skip the x masking entirely — for Conway the combine
  // collapses to eq3 | (x & eq4), mirroring ops/bitpack.py _combine_rows.
  const NeedSet ns = build_needs(birth_mask, survive_mask);
  const std::vector<Need>& needs = ns.needs;
  const bool any_birth = ns.any_birth, any_survive = ns.any_survive;

  std::vector<uint64_t> zero(words + 2, 0);
  ActiveGuard guard;
  const int threads = thread_count(ph, words);
  for (int step = 0; step < steps; ++step) {
    parallel_rows(ph, threads, [&](int r0, int r1) {
      for (int r = r0; r < r1; ++r)
        row_triple(cur.row(r), S.row(r), C.row(r), words);
    });
    parallel_rows(ph, threads, [&](int band0, int band1) {
    for (int r = band0; r < band1; ++r) {
      const uint64_t* sN = r > 0 ? S.row(r - 1) : zero.data() + 1;
      const uint64_t* cN = r > 0 ? C.row(r - 1) : zero.data() + 1;
      const uint64_t* sS = r < ph - 1 ? S.row(r + 1) : zero.data() + 1;
      const uint64_t* cS = r < ph - 1 ? C.row(r + 1) : zero.data() + 1;
      const uint64_t* sC = S.row(r);
      const uint64_t* cC = C.row(r);
      const uint64_t* x = cur.row(r);
      uint64_t* o = next.row(r);
      for (int i = 0; i < words; ++i) {
        uint64_t b3, b2, b1, b0;
        nine_sum(sN[i], sC[i], sS[i], cN[i], cC[i], cS[i], b3, b2, b1, b0);
        uint64_t always = 0, birth = 0, survive = 0;
        for (const Need& nd : needs) {
          // Predicate plane: count == nd.n.
          uint64_t t = (nd.n & 8 ? b3 : ~b3) & (nd.n & 4 ? b2 : ~b2) &
                       (nd.n & 2 ? b1 : ~b1) & (nd.n & 1 ? b0 : ~b0);
          if (nd.kind == Need::ALWAYS)
            always |= t;
          else if (nd.kind == Need::BIRTH)
            birth |= t;
          else
            survive |= t;
        }
        uint64_t v = always;
        // Loop-invariant branches: hoisted by the compiler, so rules with
        // no birth-only / survive-only counts pay nothing for the masks.
        if (any_birth) v |= ~x[i] & birth;
        if (any_survive) v |= x[i] & survive;
        o[i] = v;
      }
      // Keep the out-of-slab columns dead (shift guards must stay zero and
      // bits >= pw must not become fake neighbors through later steps).
      if (pw & 63) o[words - 1] &= ((uint64_t)1 << (pw & 63)) - 1;
    }
    });
    std::swap(cur.data, next.data);
  }

  // Extract the exact (h, w) interior.
  const int h = ph - 2 * halo, w = pw - 2 * halo;
  for (int r = 0; r < h; ++r) {
    const uint64_t* src = cur.row(r + halo);
    uint8_t* dst = out + (size_t)r * w;
    for (int x = 0; x < w; ++x) {
      int col = x + halo;
      dst[x] = (src[col >> 6] >> (col & 63)) & 1;
    }
  }
}

// WireWorld chunk: the 4-state digital-logic CA as TWO bit planes with the
// state's binary encoding (empty=00, head=01, tail=10, conductor=11), the
// same layout as the device plane kernel (ops/bitpack_gen.py).  Heads
// (p0 & ~p1) feed the shared carry-save adders; the transition collapses to
//
//   next_p0 = p1                                  // tail|conductor gain p0
//   next_p1 = (p0 ^ p1) | (p0 & p1 & ~excite)     // head|tail | calm conductor
//
// where `excite` is the head-count-in-birth predicate with NO +1 shift (a
// conductor center is never a head, so it cannot self-count).  Everything
// beyond the slab is empty (00) — the same peeling contract as swar_chunk.
extern "C" void swar_wire_chunk(const uint8_t* padded, int32_t ph, int32_t pw,
                                int32_t steps, int32_t halo,
                                uint32_t birth_mask, uint8_t* out) {
  const int words = (pw + 63) / 64;
  Planes p0(ph, words), p1(ph, words), n0(ph, words), n1(ph, words);
  Planes H(ph, words), S(ph, words), C(ph, words);

  for (int r = 0; r < ph; ++r) {
    const uint8_t* src = padded + (size_t)r * pw;
    uint64_t* d0 = p0.row(r);
    uint64_t* d1 = p1.row(r);
    for (int x = 0; x < pw; ++x) {
      uint8_t v = src[x];
      if (v & 1) d0[x >> 6] |= (uint64_t)1 << (x & 63);
      if (v & 2) d1[x >> 6] |= (uint64_t)1 << (x & 63);
    }
  }

  // Counts the birth mask actually tests ({1, 2} for standard wireworld).
  std::vector<int> excite_counts;
  for (int n = 0; n <= 9; ++n)
    if ((birth_mask >> n) & 1) excite_counts.push_back(n);

  std::vector<uint64_t> zero(words + 2, 0);
  ActiveGuard guard;
  const int threads = thread_count(ph, words);
  for (int step = 0; step < steps; ++step) {
    parallel_rows(ph, threads, [&](int r0, int r1) {
      for (int r = r0; r < r1; ++r) {
        const uint64_t* a = p0.row(r);
        const uint64_t* b = p1.row(r);
        uint64_t* hrow = H.row(r);
        for (int i = 0; i < words; ++i) hrow[i] = a[i] & ~b[i];  // heads
        row_triple(hrow, S.row(r), C.row(r), words);
      }
    });
    parallel_rows(ph, threads, [&](int band0, int band1) {
      for (int r = band0; r < band1; ++r) {
        const uint64_t* sN = r > 0 ? S.row(r - 1) : zero.data() + 1;
        const uint64_t* cN = r > 0 ? C.row(r - 1) : zero.data() + 1;
        const uint64_t* sS = r < ph - 1 ? S.row(r + 1) : zero.data() + 1;
        const uint64_t* cS = r < ph - 1 ? C.row(r + 1) : zero.data() + 1;
        const uint64_t* sC = S.row(r);
        const uint64_t* cC = C.row(r);
        const uint64_t* a = p0.row(r);
        const uint64_t* b = p1.row(r);
        uint64_t* o0 = n0.row(r);
        uint64_t* o1 = n1.row(r);
        for (int i = 0; i < words; ++i) {
          uint64_t b3, b2, b1, b0;
          nine_sum(sN[i], sC[i], sS[i], cN[i], cC[i], cS[i], b3, b2, b1, b0);
          uint64_t excite = 0;
          for (int n : excite_counts)
            excite |= (n & 8 ? b3 : ~b3) & (n & 4 ? b2 : ~b2) &
                      (n & 2 ? b1 : ~b1) & (n & 1 ? b0 : ~b0);
          o0[i] = b[i];
          o1[i] = (a[i] ^ b[i]) | (a[i] & b[i] & ~excite);
        }
        // Out-of-slab columns stay empty (00) through later steps.
        if (pw & 63) {
          uint64_t m = ((uint64_t)1 << (pw & 63)) - 1;
          o0[words - 1] &= m;
          o1[words - 1] &= m;
        }
      }
    });
    std::swap(p0.data, n0.data);
    std::swap(p1.data, n1.data);
  }

  const int h = ph - 2 * halo, w = pw - 2 * halo;
  for (int r = 0; r < h; ++r) {
    const uint64_t* s0 = p0.row(r + halo);
    const uint64_t* s1 = p1.row(r + halo);
    uint8_t* dst = out + (size_t)r * w;
    for (int x = 0; x < w; ++x) {
      int col = x + halo;
      dst[x] = (uint8_t)(((s0[col >> 6] >> (col & 63)) & 1) |
                         (((s1[col >> 6] >> (col & 63)) & 1) << 1));
    }
  }
}

// Generations chunk: m = ceil(log2(states)) bit planes, decay semantics as
// in ops/bitpack_gen.py — dead -> 1 on birth-hit; alive -> 1 on
// survive-hit else state+1; refractory -> state+1 wrapping S-1 -> 0.  The
// counted plane is state==1; survive thresholds shift by +1 (the live
// center is inside the 9-sum).  Beyond-slab cells stay dead (00..0), the
// same peeling contract as the other chunks.
extern "C" void swar_gen_chunk(const uint8_t* padded, int32_t ph, int32_t pw,
                               int32_t steps, int32_t halo,
                               uint32_t birth_mask, uint32_t survive_mask,
                               int32_t states, uint8_t* out) {
  const int words = (pw + 63) / 64;
  int m = 1;
  while ((1 << m) < states) ++m;
  std::vector<Planes> cur, nxt;
  for (int k = 0; k < m; ++k) {
    cur.emplace_back(ph, words);
    nxt.emplace_back(ph, words);
  }
  Planes A(ph, words), S(ph, words), C(ph, words);

  for (int r = 0; r < ph; ++r) {
    const uint8_t* src = padded + (size_t)r * pw;
    for (int k = 0; k < m; ++k) {
      uint64_t* dst = cur[k].row(r);
      for (int x = 0; x < pw; ++x)
        if ((src[x] >> k) & 1) dst[x >> 6] |= (uint64_t)1 << (x & 63);
    }
  }

  const NeedSet ns = build_needs(birth_mask, survive_mask);
  const std::vector<Need>& needs = ns.needs;
  const bool any_birth = ns.any_birth, any_survive = ns.any_survive;
  const uint32_t last = (uint32_t)states - 1;  // the wrapping state

  std::vector<uint64_t> zero(words + 2, 0);
  ActiveGuard guard;
  const int threads = thread_count(ph, words);
  for (int step = 0; step < steps; ++step) {
    parallel_rows(ph, threads, [&](int r0, int r1) {
      for (int r = r0; r < r1; ++r) {
        uint64_t* arow = A.row(r);
        // alive = state == 1 = p0 & ~p1 & ... & ~p_{m-1}
        const uint64_t* q0 = cur[0].row(r);
        for (int i = 0; i < words; ++i) arow[i] = q0[i];
        for (int k = 1; k < m; ++k) {
          const uint64_t* qk = cur[k].row(r);
          for (int i = 0; i < words; ++i) arow[i] &= ~qk[i];
        }
        row_triple(arow, S.row(r), C.row(r), words);
      }
    });
    parallel_rows(ph, threads, [&](int band0, int band1) {
      for (int r = band0; r < band1; ++r) {
        const uint64_t* sN = r > 0 ? S.row(r - 1) : zero.data() + 1;
        const uint64_t* cN = r > 0 ? C.row(r - 1) : zero.data() + 1;
        const uint64_t* sS = r < ph - 1 ? S.row(r + 1) : zero.data() + 1;
        const uint64_t* cS = r < ph - 1 ? C.row(r + 1) : zero.data() + 1;
        const uint64_t* sC = S.row(r);
        const uint64_t* cC = C.row(r);
        const uint64_t* alive = A.row(r);
        for (int i = 0; i < words; ++i) {
          uint64_t b3, b2, b1, b0;
          nine_sum(sN[i], sC[i], sS[i], cN[i], cC[i], cS[i], b3, b2, b1, b0);
          uint64_t always = 0, birth = 0, survive = 0;
          for (const Need& nd : needs) {
            uint64_t t = (nd.n & 8 ? b3 : ~b3) & (nd.n & 4 ? b2 : ~b2) &
                         (nd.n & 2 ? b1 : ~b1) & (nd.n & 1 ? b0 : ~b0);
            if (nd.kind == Need::ALWAYS)
              always |= t;
            else if (nd.kind == Need::BIRTH)
              birth |= t;
            else
              survive |= t;
          }
          uint64_t dead = ~(uint64_t)0, wrap = ~(uint64_t)0;
          uint64_t p[8], inc[8];
          for (int k = 0; k < m; ++k) {
            p[k] = cur[k].row(r)[i];
            dead &= ~p[k];
            wrap &= ((last >> k) & 1) ? p[k] : ~p[k];
          }
          // state+1 over the planes (ripple carry; the wrap mask zeroes
          // the only state that can overflow).
          uint64_t carry = 0;
          for (int k = 0; k < m; ++k) {
            inc[k] = k == 0 ? ~p[0] : p[k] ^ carry;
            carry = k == 0 ? p[0] : (p[k] & carry);
          }
          uint64_t to_one = always;
          if (any_birth) to_one |= dead & birth;
          if (any_survive) to_one |= alive[i] & survive;
          // ALWAYS counts still require a live-or-dead center (refractory
          // cells neither survive nor give birth).
          to_one &= dead | alive[i];
          uint64_t advance = ~dead & ~to_one & ~wrap;
          for (int k = 0; k < m; ++k)
            nxt[k].row(r)[i] = (k == 0 ? to_one : 0) | (advance & inc[k]);
        }
        // Out-of-slab columns stay dead through later steps.
        if (pw & 63) {
          uint64_t mask = ((uint64_t)1 << (pw & 63)) - 1;
          for (int k = 0; k < m; ++k) nxt[k].row(r)[words - 1] &= mask;
        }
      }
    });
    for (int k = 0; k < m; ++k) std::swap(cur[k].data, nxt[k].data);
  }

  const int h = ph - 2 * halo, w = pw - 2 * halo;
  for (int r = 0; r < h; ++r) {
    uint8_t* dst = out + (size_t)r * w;
    for (int x = 0; x < w; ++x) dst[x] = 0;
    for (int k = 0; k < m; ++k) {
      const uint64_t* src = cur[k].row(r + halo);
      for (int x = 0; x < w; ++x) {
        int col = x + halo;
        dst[x] |= (uint8_t)(((src[col >> 6] >> (col & 63)) & 1) << k);
      }
    }
  }
}
