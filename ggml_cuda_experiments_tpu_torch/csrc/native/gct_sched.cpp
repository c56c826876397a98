// gct_sched: native continuous-batching scheduler + paged-KV page
// allocator for the port's Engine (models/engine.py, scheduler="native";
// bound by utils/native_sched.py). A copy of the JAX package's
// native/gct_sched.cpp.
//
// The runtime-scheduler piece of the engine in C++: request queueing,
// slot admission, page allocation/release, and completion bookkeeping.
// The decision sequence is specified by the Python reference scheduler
// (models/engine.py Engine._admit/_release + PageAllocator);
// tests/test_torch_native_sched.py enforces decision-for-decision equality.
//
// Concurrency: the host-side token loop is single-threaded (one step() at
// a time), so the scheduler is lock-free by construction; calls must come
// from one thread at a time.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <deque>
#include <vector>

using std::size_t;

namespace {

struct Request {
  int rid;
  int prompt_len;
  int max_new_tokens;
  int slot = -1;
  int generated = 0;
  std::vector<int> pages;
};

struct Engine {
  int max_batch;
  int n_pages;          // usable pages (trash page excluded by caller)
  int pages_per_seq;
  int page_size;
  int max_seq_len;
  int trash_page;

  // decision-identical to engine.py PageAllocator: FIFO free list,
  // alloc takes from the front, release appends in order
  std::deque<int> free_pages;
  std::deque<Request> waiting;
  std::vector<Request> running;       // by admission order
  std::vector<int> slot_rid;          // -1 = free
  std::vector<int> lengths;           // per slot
  std::vector<int> page_table;        // [max_batch, pages_per_seq]

  Engine(int mb, int np_, int pps, int ps, int msl)
      : max_batch(mb), n_pages(np_), pages_per_seq(pps), page_size(ps),
        max_seq_len(msl), trash_page(np_),
        slot_rid(mb, -1), lengths(mb, 1),
        page_table((size_t)mb * pps, np_) {
    for (int i = 0; i < np_; ++i) free_pages.push_back(i);
  }

  bool alloc(int n, std::vector<int> *out) {
    if ((int)free_pages.size() < n) return false;
    out->clear();
    for (int i = 0; i < n; ++i) {
      out->push_back(free_pages.front());
      free_pages.pop_front();
    }
    return true;
  }

  void release(const std::vector<int> &pages) {
    for (int p : pages) free_pages.push_back(p);
  }
};

}  // namespace

extern "C" {

void *gct_sched_new(int max_batch, int n_pages, int pages_per_seq,
                    int page_size, int max_seq_len) {
  return new Engine(max_batch, n_pages, pages_per_seq, page_size,
                    max_seq_len);
}

void gct_sched_free(void *h) { delete static_cast<Engine *>(h); }

void gct_sched_add_request(void *h, int rid, int prompt_len,
                           int max_new_tokens) {
  auto *e = static_cast<Engine *>(h);
  Request r;
  r.rid = rid;
  r.prompt_len = prompt_len;
  r.max_new_tokens = max_new_tokens;
  e->waiting.push_back(r);
}

// Admit as many waiting requests as slots/pages allow. Outputs per admitted
// request: rid, slot, and its page row (pages_per_seq ints, padded with the
// trash page). Returns the number admitted.
int gct_sched_admit(void *h, int *out_rids, int *out_slots,
                    int *out_pages) {
  auto *e = static_cast<Engine *>(h);
  int admitted = 0;
  while (!e->waiting.empty() &&
         (int)e->running.size() < e->max_batch) {
    Request &req = e->waiting.front();
    int total = req.prompt_len + req.max_new_tokens;
    if (total > e->max_seq_len) total = e->max_seq_len;
    int need = (total + e->page_size - 1) / e->page_size;
    std::vector<int> pages;
    if (!e->alloc(need, &pages)) break;

    int slot = 0;
    while (e->slot_rid[slot] != -1) ++slot;
    req.slot = slot;
    req.pages = pages;
    e->slot_rid[slot] = req.rid;
    e->lengths[slot] = req.prompt_len;
    for (int j = 0; j < e->pages_per_seq; ++j)
      e->page_table[(size_t)slot * e->pages_per_seq + j] =
          j < (int)pages.size() ? pages[j] : e->trash_page;

    out_rids[admitted] = req.rid;
    out_slots[admitted] = slot;
    for (int j = 0; j < e->pages_per_seq; ++j)
      out_pages[(size_t)admitted * e->pages_per_seq + j] =
          e->page_table[(size_t)slot * e->pages_per_seq + j];
    // first token comes from prefill: counts as generated
    req.generated = 1;
    e->running.push_back(req);
    e->waiting.pop_front();
    ++admitted;
  }
  return admitted;
}

// One decode step completed: every running slot consumed one token and
// produced one. hit_eos[slot] marks EOS. Returns the number of finished
// requests; their rids/slots in out_finished_*. Finished slots/pages are
// released immediately (same step, like the Python engine).
int gct_sched_step_complete(void *h, const uint8_t *hit_eos,
                            int *out_finished_rids,
                            int *out_finished_slots) {
  auto *e = static_cast<Engine *>(h);
  int nfin = 0;
  for (size_t i = 0; i < e->running.size();) {
    Request &req = e->running[i];
    int s = req.slot;
    e->lengths[s] += 1;
    req.generated += 1;
    // Python: req.length = prompt + generated (incl. the prefill token)
    //        = lengths[s] + 1
    bool done = (hit_eos && hit_eos[s]) ||
                req.generated >= req.max_new_tokens ||
                e->lengths[s] + 1 >= e->max_seq_len;
    if (done) {
      out_finished_rids[nfin] = req.rid;
      out_finished_slots[nfin] = s;
      ++nfin;
      e->release(req.pages);
      e->slot_rid[s] = -1;
      e->lengths[s] = 1;
      for (int j = 0; j < e->pages_per_seq; ++j)
        e->page_table[(size_t)s * e->pages_per_seq + j] = e->trash_page;
      e->running.erase(e->running.begin() + i);
    } else {
      ++i;
    }
  }
  return nfin;
}

int gct_sched_num_running(void *h) {
  return (int)static_cast<Engine *>(h)->running.size();
}

int gct_sched_num_waiting(void *h) {
  return (int)static_cast<Engine *>(h)->waiting.size();
}

int gct_sched_num_free_pages(void *h) {
  return (int)static_cast<Engine *>(h)->free_pages.size();
}

// Snapshot lengths [max_batch] and page_table [max_batch * pages_per_seq].
void gct_sched_state(void *h, int *lengths, int *page_table) {
  auto *e = static_cast<Engine *>(h);
  std::copy(e->lengths.begin(), e->lengths.end(), lengths);
  std::copy(e->page_table.begin(), e->page_table.end(), page_table);
}

}  // extern "C"
