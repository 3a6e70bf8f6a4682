// Native per-cell actor engine — C++ twin of runtime/actor_engine.py.
//
// Implements the reference's compute-layer protocol (CellActor.scala +
// NextStateCellGathererActor.scala, see SURVEY.md §2-§3) as a deterministic
// FIFO event loop over per-cell actors:
//   - epoch-keyed state history seeded {0: initial} (CellActor.scala:34)
//   - lazy advance gated by a waiting latch (CellActor.scala:41-47)
//   - per-step gatherer asking all 8 Moore neighbors
//     (NextStateCellGathererActor.scala:32-36)
//   - requests for not-yet-computed epochs queue and flush on set
//     (CellActor.scala:71-77, 82-88)
//   - crash -> history reset to epoch 0, replay forward out of neighbor
//     histories (SURVEY.md §3.3)
//   - tile mode: out-of-bounds neighbors are ghost cells fed per-epoch from
//     the cluster halo (the remote cells' served history).
//
// The rule is data: birth/survive bitmasks + state count (Generations decay),
// exactly as in ops/rules.py.  Exposed as a C ABI for ctypes; no Python.h
// dependency so it builds with a bare `g++ -shared -fPIC`.

#include <cstdint>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

struct Cell {
  std::unordered_map<int32_t, uint8_t> history;
  std::unordered_map<int32_t, std::vector<int64_t>> queued;  // epoch -> gids
  uint8_t initial = 0;
  bool waiting = false;
  bool is_ghost = false;  // ghosts serve history only; they never step
  int32_t epoch = 0;      // max key of history (tracked incrementally)
};

struct Gatherer {
  int32_t cell_index;  // owner cell (flat index)
  int32_t epoch;       // gathering neighbor states AT this epoch
  uint8_t current_state;
  int32_t pending;                 // distinct neighbors still unanswered
  std::vector<int32_t> neighbors;  // flat indices, with multiplicity
  std::vector<uint8_t> states;     // per-neighbor replies (by slot)
  std::vector<uint8_t> answered;   // per-slot flag
};

enum MsgKind : uint8_t {
  MSG_CURRENT_EPOCH,
  MSG_GET_TO_NEXT,
  MSG_GET_STATE,
  MSG_STATE_REPLY,
  MSG_SET_STATE,
};

struct Msg {
  MsgKind kind;
  int32_t a;  // cell index (or requestee index for GET_STATE)
  int64_t b;  // gatherer id
  int32_t c;  // epoch (GET_STATE/SET_STATE) or neighbor slot (STATE_REPLY)
  uint8_t d;  // state payload
};

struct Board {
  int32_t h = 0, w = 0;            // interior shape
  int32_t fh = 0, fw = 0;          // full shape incl. ghost ring (tile mode)
  bool tile_mode = false;          // ghosts vs torus
  uint32_t birth_mask = 0, survive_mask = 0;
  int32_t states = 2;
  int32_t kind = 0;  // 0 totalistic, 1 wireworld (ops/rules.py Rule.kind)
  int32_t global_epoch = 0;
  int64_t next_gid = 0;
  int64_t messages = 0;
  std::vector<Cell> cells;  // fh*fw entries (== h*w when not tiled)
  std::unordered_map<int64_t, Gatherer> gatherers;
  // neighbor slot table: per interior cell, 8 flat indices
  std::vector<int32_t> nbr;
  std::deque<Msg> mailbox;

  int32_t flat(int32_t y, int32_t x) const {
    if (tile_mode) return (y + 1) * fw + (x + 1);  // ghost ring offset
    return y * fw + x;
  }
  bool ghost(int32_t idx) const { return cells[idx].is_ghost; }
};

void build_neighbors(Board& b) {
  b.nbr.assign(static_cast<size_t>(b.h) * b.w * 8, 0);
  for (int32_t y = 0; y < b.h; ++y) {
    for (int32_t x = 0; x < b.w; ++x) {
      int32_t* out = &b.nbr[(static_cast<size_t>(y) * b.w + x) * 8];
      int k = 0;
      for (int32_t dy = -1; dy <= 1; ++dy) {
        for (int32_t dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          int32_t ny = y + dy, nx = x + dx;
          if (!b.tile_mode) {
            ny = (ny + b.h) % b.h;
            nx = (nx + b.w) % b.w;
          }
          out[k++] = b.flat(ny, nx);
        }
      }
    }
  }
}

uint8_t apply_rule(const Board& b, uint8_t current, int32_t alive) {
  if (b.kind == 1) {
    // Wireworld: head -> tail, tail -> conductor, conductor -> head iff the
    // head count hits the birth mask, empty stays (ops/stencil.apply_rule).
    if (current == 1) return 2;
    if (current == 2) return 3;
    if (current == 3 && ((b.birth_mask >> alive) & 1u)) return 1;
    return current;
  }
  if (b.states == 2) {
    uint32_t mask = current == 1 ? b.survive_mask : b.birth_mask;
    return static_cast<uint8_t>((mask >> alive) & 1u);
  }
  // Generations CA: dead -> birth?, alive -> survive? else decay, refractory
  // states count down to dead (ops/rules.py semantics).
  if (current == 0) return static_cast<uint8_t>((b.birth_mask >> alive) & 1u);
  if (current == 1) {
    if ((b.survive_mask >> alive) & 1u) return 1;
    return static_cast<uint8_t>(2 % b.states);
  }
  return static_cast<uint8_t>((current + 1) % b.states);
}

void set_history(Cell& c, int32_t epoch, uint8_t state) {
  c.history[epoch] = state;
  if (epoch > c.epoch) c.epoch = epoch;
}

void drain(Board& b) {
  while (!b.mailbox.empty()) {
    Msg m = b.mailbox.front();
    b.mailbox.pop_front();
    ++b.messages;
    switch (m.kind) {
      case MSG_CURRENT_EPOCH: {
        Cell& c = b.cells[m.a];
        if (!c.is_ghost && c.epoch < b.global_epoch && !c.waiting) {
          c.waiting = true;
          b.mailbox.push_back({MSG_GET_TO_NEXT, m.a, 0, 0, 0});
        }
        break;
      }
      case MSG_GET_TO_NEXT: {
        Cell& c = b.cells[m.a];
        int64_t gid = b.next_gid++;
        Gatherer g;
        g.cell_index = m.a;
        g.epoch = c.epoch;
        g.current_state = c.history[c.epoch];
        // interior slot table lookup needs interior coords
        int32_t iy, ix;
        if (b.tile_mode) {
          iy = m.a / b.fw - 1;
          ix = m.a % b.fw - 1;
        } else {
          iy = m.a / b.fw;
          ix = m.a % b.fw;
        }
        const int32_t* nb = &b.nbr[(static_cast<size_t>(iy) * b.w + ix) * 8];
        g.neighbors.assign(nb, nb + 8);
        g.states.assign(8, 0);
        g.answered.assign(8, 0);
        // Distinct-target asks (GatheredData set semantics): one GET_STATE
        // per distinct neighbor; the reply fills every slot of that target.
        int32_t distinct = 0;
        for (int s = 0; s < 8; ++s) {
          bool first = true;
          for (int t = 0; t < s; ++t)
            if (g.neighbors[t] == g.neighbors[s]) { first = false; break; }
          if (first) {
            ++distinct;
            b.mailbox.push_back({MSG_GET_STATE, g.neighbors[s], gid, g.epoch, 0});
          }
        }
        g.pending = distinct;
        b.gatherers.emplace(gid, std::move(g));
        break;
      }
      case MSG_GET_STATE: {
        Cell& c = b.cells[m.a];
        auto it = c.history.find(m.c);
        if (it != c.history.end()) {
          b.mailbox.push_back({MSG_STATE_REPLY, m.a, m.b, 0, it->second});
        } else {
          c.queued[m.c].push_back(m.b);
        }
        break;
      }
      case MSG_STATE_REPLY: {
        auto git = b.gatherers.find(m.b);
        if (git == b.gatherers.end()) break;
        Gatherer& g = git->second;
        bool newly = false;
        for (int s = 0; s < 8; ++s) {
          if (g.neighbors[s] == m.a && !g.answered[s]) {
            g.answered[s] = 1;
            g.states[s] = m.d;
            newly = true;
          }
        }
        if (newly && --g.pending == 0) {
          int32_t alive = 0;
          for (int s = 0; s < 8; ++s) alive += g.states[s] == 1;
          uint8_t next = apply_rule(b, g.current_state, alive);
          Msg set{MSG_SET_STATE, g.cell_index, 0, g.epoch + 1, next};
          b.gatherers.erase(git);
          b.mailbox.push_back(set);
        }
        break;
      }
      case MSG_SET_STATE: {
        Cell& c = b.cells[m.a];
        // guard: previous epoch must exist (CellActor.scala:29-30,79)
        if (c.history.find(m.c - 1) == c.history.end()) break;
        set_history(c, m.c, m.d);
        c.waiting = false;
        auto q = c.queued.find(m.c);
        if (q != c.queued.end()) {
          for (int64_t gid : q->second)
            b.mailbox.push_back({MSG_STATE_REPLY, m.a, gid, 0, m.d});
          c.queued.erase(q);
        }
        b.mailbox.push_back({MSG_CURRENT_EPOCH, m.a, 0, 0, 0});
        break;
      }
    }
  }
}

}  // namespace

extern "C" {

void* ae_create(int32_t h, int32_t w, const uint8_t* board,
                uint32_t birth_mask, uint32_t survive_mask, int32_t states,
                int32_t tile_mode, int32_t kind) {
  // Flat cell indices are int32 throughout (Msg.a, nbr table); reject boards
  // whose (ghost-ring-padded) index space would overflow.  The per-cell
  // engine is the small-board parity path, so this is not a real limit.
  if (h <= 0 || w <= 0) return nullptr;
  int64_t fh = static_cast<int64_t>(h) + (tile_mode ? 2 : 0);
  int64_t fw = static_cast<int64_t>(w) + (tile_mode ? 2 : 0);
  if (fh * fw > INT32_MAX) return nullptr;
  Board* b = new Board();
  b->h = h;
  b->w = w;
  b->tile_mode = tile_mode != 0;
  b->fh = tile_mode ? h + 2 : h;
  b->fw = tile_mode ? w + 2 : w;
  b->birth_mask = birth_mask;
  b->survive_mask = survive_mask;
  b->states = states;
  b->kind = kind;
  b->cells.assign(static_cast<size_t>(b->fh) * b->fw, Cell());
  for (int32_t y = 0; y < b->fh; ++y) {
    for (int32_t x = 0; x < b->fw; ++x) {
      Cell& c = b->cells[static_cast<size_t>(y) * b->fw + x];
      if (tile_mode && (y == 0 || x == 0 || y == b->fh - 1 || x == b->fw - 1)) {
        c.is_ghost = true;  // no history until a halo feeds it
      } else {
        int32_t iy = tile_mode ? y - 1 : y;
        int32_t ix = tile_mode ? x - 1 : x;
        c.initial = board[static_cast<size_t>(iy) * w + ix];
        set_history(c, 0, c.initial);
      }
    }
  }
  build_neighbors(*b);
  return b;
}

void ae_destroy(void* p) { delete static_cast<Board*>(p); }

void ae_advance_to(void* p, int32_t target) {
  Board* b = static_cast<Board*>(p);
  if (target > b->global_epoch) b->global_epoch = target;
  for (size_t i = 0; i < b->cells.size(); ++i)
    if (!b->cells[i].is_ghost)
      b->mailbox.push_back({MSG_CURRENT_EPOCH, static_cast<int32_t>(i), 0, 0, 0});
  drain(*b);
}

void ae_crash_cell(void* p, int32_t y, int32_t x) {
  Board* b = static_cast<Board*>(p);
  Cell& c = b->cells[b->flat(y, x)];
  c.history.clear();
  c.queued.clear();
  c.epoch = 0;
  c.waiting = false;
  set_history(c, 0, c.initial);
  b->mailbox.push_back({MSG_CURRENT_EPOCH, b->flat(y, x), 0, 0, 0});
  drain(*b);
}

void ae_feed_halo(void* p, int32_t epoch, const uint8_t* padded) {
  // padded is (h+2, w+2) row-major; ghosts take their ring value at `epoch`.
  Board* b = static_cast<Board*>(p);
  for (int32_t y = 0; y < b->fh; ++y) {
    for (int32_t x = 0; x < b->fw; ++x) {
      Cell& c = b->cells[static_cast<size_t>(y) * b->fw + x];
      if (!c.is_ghost) continue;
      uint8_t state = padded[static_cast<size_t>(y) * b->fw + x];
      set_history(c, epoch, state);
      auto q = c.queued.find(epoch);
      if (q != c.queued.end()) {
        for (int64_t gid : q->second)
          b->mailbox.push_back(
              {MSG_STATE_REPLY, static_cast<int32_t>(y * b->fw + x), gid, 0, state});
        c.queued.erase(q);
      }
    }
  }
  drain(*b);
}

void ae_get_board(void* p, uint8_t* out) {
  Board* b = static_cast<Board*>(p);
  for (int32_t y = 0; y < b->h; ++y)
    for (int32_t x = 0; x < b->w; ++x) {
      const Cell& c = b->cells[b->flat(y, x)];
      out[static_cast<size_t>(y) * b->w + x] = c.history.at(c.epoch);
    }
}

int32_t ae_min_epoch(void* p) {
  Board* b = static_cast<Board*>(p);
  int32_t m = INT32_MAX;
  for (const Cell& c : b->cells)
    if (!c.is_ghost && c.epoch < m) m = c.epoch;
  return m == INT32_MAX ? 0 : m;
}

int64_t ae_messages(void* p) { return static_cast<Board*>(p)->messages; }

void ae_prune_below(void* p, int32_t epoch) {
  Board* b = static_cast<Board*>(p);
  for (Cell& c : b->cells) {
    // The top-of-history entry (c.epoch) is always kept, so a non-empty
    // history stays non-empty.
    for (auto it = c.history.begin(); it != c.history.end();) {
      if (it->first < epoch && it->first != c.epoch)
        it = c.history.erase(it);
      else
        ++it;
    }
  }
}

}  // extern "C"
