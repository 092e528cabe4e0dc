// Paged KV-cache allocator + continuous-batching scheduler.
//
// Native host-side runtime for the serving path (the reference's native
// layer is its C++ host dispatch, src/flash_attention.cu:34-150; here the
// TPU-native equivalent of "host code that must not be slow Python" is the
// per-step serving bookkeeping: page allocation and batch admission run
// every decode step for thousands of sequences).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image). All functions
// are thread-compatible (caller serializes; the Python side holds the GIL).
//
// Model: the KV cache is a pool of fixed-size pages (page_size tokens each).
// Each sequence owns an ordered list of pages. The scheduler admits requests
// from a FIFO queue into the running batch whenever the pool can hold their
// prompt plus a reservation watermark, and preempts the *youngest* running
// sequence on exhaustion (preempted sequences re-enter the queue head and
// will re-prefill — vLLM-style recompute preemption).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <list>
#include <unordered_map>
#include <vector>

namespace {

struct Sequence {
  int64_t id;
  int32_t prompt_len;
  int32_t max_new_tokens;
  int32_t generated;        // tokens generated so far
  std::vector<int32_t> pages;
  bool running;
  // Prefix caching: chained content hashes of the prompt's FULL pages
  // (hash i covers tokens [0, (i+1)*page_size)), and how many leading
  // pages the last admission satisfied from the cache.
  std::vector<uint64_t> hashes;
  int32_t cached = 0;

  int32_t total_len() const { return prompt_len + generated; }
};

// Per-page prefix-cache state. A page is "hashed" once its (fully written,
// immutable) prompt content was published into the prefix map; hashed pages
// are refcounted and retire to an LRU instead of the free list, where they
// stay claimable until evicted for allocation.
struct PageMeta {
  int32_t ref = 0;
  uint64_t hash = 0;
  bool hashed = false;
};

struct Engine {
  int32_t num_pages;
  int32_t page_size;
  int32_t max_batch;
  int32_t max_pages_per_seq;
  std::vector<int32_t> free_pages;          // LIFO free list
  std::unordered_map<int64_t, Sequence> seqs;
  std::deque<int64_t> waiting;              // FIFO of queued sequence ids
  std::vector<int64_t> running;             // current batch, stable order
  // step() output staging
  std::vector<int64_t> out_ids;
  std::vector<int32_t> out_page_tables;     // running.size() x max_pages_per_seq
  int64_t preempt_count = 0;
  // Prefix cache: content hash -> page id, for pages holding published
  // immutable prompt content. Retired (ref == 0) hashed pages wait in an
  // LRU; allocation prefers the free list and evicts the LRU only when dry.
  std::vector<PageMeta> meta;
  std::unordered_map<uint64_t, int32_t> prefix_map;
  std::list<int32_t> lru;                   // oldest first
  std::unordered_map<int32_t, std::list<int32_t>::iterator> lru_pos;
  int64_t prefix_hits = 0;                  // pages served from the cache

  int32_t pages_needed(int32_t tokens) const {
    return (tokens + page_size - 1) / page_size;
  }

  int32_t allocatable() const {
    return (int32_t)(free_pages.size() + lru.size());
  }

  void lru_erase(int32_t p) {
    auto it = lru_pos.find(p);
    if (it != lru_pos.end()) { lru.erase(it->second); lru_pos.erase(it); }
  }

  int32_t alloc_page() {
    if (!free_pages.empty()) {
      int32_t p = free_pages.back();
      free_pages.pop_back();
      return p;
    }
    if (!lru.empty()) {  // evict the oldest retired cached page
      int32_t p = lru.front();
      lru.pop_front();
      lru_pos.erase(p);
      prefix_map.erase(meta[p].hash);
      meta[p] = PageMeta{};
      return p;
    }
    return -1;
  }

  bool grow_to(Sequence& s, int32_t tokens) {
    int32_t need = pages_needed(tokens);
    while ((int32_t)s.pages.size() < need) {
      int32_t p = alloc_page();
      if (p < 0) return false;
      meta[p].ref = 1;  // private until published
      s.pages.push_back(p);
    }
    return true;
  }

  void release_page(int32_t p) {
    if (meta[p].hashed) {
      if (--meta[p].ref == 0) {  // retire to the LRU, content retained
        lru.push_back(p);
        lru_pos[p] = std::prev(lru.end());
      }
    } else {
      meta[p].ref = 0;
      free_pages.push_back(p);
    }
  }

  void release(Sequence& s) {
    for (int32_t p : s.pages) release_page(p);
    s.pages.clear();
    s.cached = 0;
  }

  // Claim the longest published prefix for a pageless sequence. Chained
  // hashes make a per-page equality check sufficient for whole-prefix
  // equality. Returns the number of pages claimed.
  int32_t claim_cached(Sequence& s) {
    int32_t n = 0;
    for (uint64_t hsh : s.hashes) {
      auto it = prefix_map.find(hsh);
      if (it == prefix_map.end()) break;
      int32_t p = it->second;
      if (meta[p].ref == 0) lru_erase(p);
      meta[p].ref++;
      s.pages.push_back(p);
      n++;
    }
    prefix_hits += n;
    return n;
  }

  void unclaim(Sequence& s) {  // undo claim_cached on failed admission
    for (auto rit = s.pages.rbegin(); rit != s.pages.rend(); ++rit)
      release_page(*rit);
    prefix_hits -= s.cached;  // grow_to may have added private pages too
    s.pages.clear();
    s.cached = 0;
  }

  void preempt_youngest() {
    if (running.empty()) return;
    int64_t victim = running.back();
    running.pop_back();
    auto& s = seqs[victim];
    release(s);
    s.generated = 0;  // recompute preemption: prompt will re-prefill
    s.running = false;
    waiting.push_front(victim);
    preempt_count++;
  }
};

}  // namespace

extern "C" {

// Create an engine managing `num_pages` KV pages of `page_size` tokens,
// batching at most `max_batch` sequences of at most `max_pages_per_seq`
// pages each (<=0 means unlimited).
void* fa_engine_create(int32_t num_pages, int32_t page_size, int32_t max_batch,
                       int32_t max_pages_per_seq) {
  auto* e = new Engine();
  e->num_pages = num_pages;
  e->page_size = page_size;
  e->max_batch = max_batch;
  e->max_pages_per_seq =
      max_pages_per_seq > 0 ? max_pages_per_seq : num_pages;
  e->free_pages.reserve(num_pages);
  for (int32_t i = num_pages - 1; i >= 0; --i) e->free_pages.push_back(i);
  e->meta.resize(num_pages);
  return e;
}

void fa_engine_destroy(void* h) { delete static_cast<Engine*>(h); }

// Enqueue a request. Returns 0 on success, -1 if the id already exists or
// the prompt can never fit in the pool.
int32_t fa_engine_add_request(void* h, int64_t id, int32_t prompt_len,
                              int32_t max_new_tokens) {
  auto* e = static_cast<Engine*>(h);
  if (e->seqs.count(id)) return -1;
  int32_t worst = e->pages_needed(prompt_len + max_new_tokens);
  if (worst > e->num_pages) return -1;
  // The sequence's page list must fit the fixed-width page table the client
  // reads back — growing past it would silently truncate KV addressing.
  if (worst > e->max_pages_per_seq) return -1;
  // Admission (fa_engine_step) requires pages for prompt+1 tokens plus a
  // one-page watermark; a request that can never satisfy that would sit at
  // the FIFO head forever and livelock the queue.
  if (e->pages_needed(prompt_len + 1) + 1 > e->num_pages) return -1;
  Sequence s;
  s.id = id;
  s.prompt_len = prompt_len;
  s.max_new_tokens = max_new_tokens;
  s.generated = 0;
  s.running = false;
  e->seqs.emplace(id, std::move(s));
  e->waiting.push_back(id);
  return 0;
}

// add_request plus chained prompt-page content hashes enabling prefix
// caching: hash i must cover tokens [0, (i+1) * page_size) — chained, so a
// per-page match implies the whole prefix matches. At admission the engine
// claims the longest published prefix (see fa_engine_cached_pages /
// fa_engine_publish). Only FULL prompt pages may be hashed (a partially
// filled page receives decode writes and must stay private).
int32_t fa_engine_add_request_cached(void* h, int64_t id, int32_t prompt_len,
                                     int32_t max_new_tokens,
                                     const uint64_t* hashes,
                                     int32_t n_hashes) {
  auto* e = static_cast<Engine*>(h);
  int32_t rc = fa_engine_add_request(h, id, prompt_len, max_new_tokens);
  if (rc != 0) return rc;
  auto& s = e->seqs[id];
  int32_t full = prompt_len / e->page_size;
  s.hashes.assign(hashes, hashes + std::min(n_hashes, full));
  return 0;
}

// Pages of `id`'s prompt satisfied from the prefix cache at its (latest)
// admission — the prefill can skip the first `cached * page_size` tokens.
int32_t fa_engine_cached_pages(void* h, int64_t id) {
  auto* e = static_cast<Engine*>(h);
  auto it = e->seqs.find(id);
  return it == e->seqs.end() ? -1 : it->second.cached;
}

// Publish `id`'s freshly prefilled full prompt pages into the prefix map.
// Call exactly once per prefill, AFTER the pages hold their final content.
// A hash already mapped by another live page is skipped (that page keeps
// ownership of the map entry; this one stays private).
int32_t fa_engine_publish(void* h, int64_t id) {
  auto* e = static_cast<Engine*>(h);
  auto it = e->seqs.find(id);
  if (it == e->seqs.end()) return -1;
  auto& s = it->second;
  for (int32_t i = s.cached; i < (int32_t)s.hashes.size(); ++i) {
    int32_t p = s.pages[i];
    if (e->meta[p].hashed) continue;
    if (e->prefix_map.emplace(s.hashes[i], p).second) {
      e->meta[p].hashed = true;
      e->meta[p].hash = s.hashes[i];
    }
  }
  return 0;
}

int64_t fa_engine_prefix_hits(void* h) {
  return static_cast<Engine*>(h)->prefix_hits;
}

// Retired (ref == 0) cached pages currently parked in the LRU — for exact
// pool accounting in tests: free + lru + distinct-owned == num_pages.
int32_t fa_engine_lru_size(void* h) {
  return (int32_t)static_cast<Engine*>(h)->lru.size();
}

// One scheduling step: admit waiting sequences while capacity allows, then
// allocate pages for one new token per running sequence (preempting the
// youngest on exhaustion). Returns the number of running sequences.
// After step(), fetch the batch with fa_engine_batch().
int32_t fa_engine_step(void* h) {
  auto* e = static_cast<Engine*>(h);

  // Admission: a waiting sequence is admitted if its full prompt plus one
  // page of headroom fits right now (prefix-cache claims count as owned).
  while (!e->waiting.empty() && (int32_t)e->running.size() < e->max_batch) {
    int64_t id = e->waiting.front();
    auto& s = e->seqs[id];
    bool claimed = false;
    if (s.pages.empty() && !s.hashes.empty()) {
      s.cached = e->claim_cached(s);
      claimed = true;
    }
    int32_t need = e->pages_needed(s.total_len() + 1) + 1;  // +1 page watermark
    if (e->allocatable() < need - (int32_t)s.pages.size() ||
        !e->grow_to(s, s.total_len() + 1)) {
      if (claimed) e->unclaim(s);
      break;
    }
    s.running = true;
    e->running.push_back(id);
    e->waiting.pop_front();
  }

  // Growth: every running sequence needs room for the token this step emits.
  for (size_t i = 0; i < e->running.size();) {
    auto& s = e->seqs[e->running[i]];
    while (!e->grow_to(s, s.total_len() + 1)) {
      // Preempt the youngest *other* sequence; if we are the only one, the
      // request is stuck (cannot happen: add_request checked worst case
      // against the whole pool, and alone it owns the whole pool).
      if (e->running.size() <= 1) return -1;
      e->preempt_youngest();
      if (e->running.size() <= i) break;  // we were the victim
    }
    if (i < e->running.size() && e->running[i] == s.id) ++i;
  }
  return (int32_t)e->running.size();
}

// Record that the current step generated one token for every running
// sequence; sequences reaching max_new_tokens are finished and their pages
// freed. Returns how many finished this call. Finished ids are written to
// `finished_out` (capacity `cap`).
int32_t fa_engine_commit_tokens(void* h, int64_t* finished_out, int32_t cap) {
  auto* e = static_cast<Engine*>(h);
  int32_t n_fin = 0;
  std::vector<int64_t> still;
  still.reserve(e->running.size());
  for (int64_t id : e->running) {
    auto& s = e->seqs[id];
    s.generated += 1;
    if (s.generated >= s.max_new_tokens) {
      if (n_fin < cap) finished_out[n_fin] = id;
      n_fin++;
      e->release(s);
      e->seqs.erase(id);
    } else {
      still.push_back(id);
    }
  }
  e->running = std::move(still);
  return n_fin;
}

// Grow every running sequence's page list to cover `n` MORE tokens beyond
// what step() already allocated — the speculative-decoding slot reservation
// (k draft tokens verified in one model call). Never preempts: returns -1
// (allocating nothing) if the pool cannot cover every sequence, so callers
// can fall back to one-token decoding; 0 on success. Pages stay with their
// sequences either way — uncommitted slots are plain headroom that later
// tokens grow into.
int32_t fa_engine_grow_batch(void* h, int32_t n) {
  auto* e = static_cast<Engine*>(h);
  int32_t need = 0;
  for (int64_t id : e->running) {
    auto& s = e->seqs[id];
    int32_t want = e->pages_needed(s.total_len() + 1 + n);
    if (want > e->max_pages_per_seq) return -1;
    need += std::max(0, want - (int32_t)s.pages.size());
  }
  if (need > e->allocatable()) return -1;
  for (int64_t id : e->running) {
    auto& s = e->seqs[id];
    bool ok = e->grow_to(s, s.total_len() + 1 + n);
    (void)ok;  // cannot fail: `need` was checked against the free list
  }
  return 0;
}

// Commit `n` tokens for ONE sequence — the speculative-acceptance path
// (each row accepts a different number of draft tokens). Returns 1 if the
// sequence reached its budget and finished (pages freed), 0 if it keeps
// running, -1 if the id is unknown or not running.
int32_t fa_engine_commit_n(void* h, int64_t id, int32_t n) {
  auto* e = static_cast<Engine*>(h);
  auto it = e->seqs.find(id);
  if (it == e->seqs.end()) return -1;
  auto& s = it->second;
  if (!s.running) return -1;
  s.generated += n;
  if (s.generated >= s.max_new_tokens) {
    e->release(s);
    for (auto r = e->running.begin(); r != e->running.end(); ++r) {
      if (*r == id) { e->running.erase(r); break; }
    }
    e->seqs.erase(it);
    return 1;
  }
  return 0;
}

// Finish a sequence before its max_new_tokens budget — the stop-token /
// client-cancel path. Frees its pages immediately (they may be reallocated
// by the next step(), so the caller must not issue further KV reads or
// writes for this sequence). Returns 0, or -1 if the id is unknown.
// Waiting (not yet admitted) sequences are cancelled the same way.
int32_t fa_engine_finish(void* h, int64_t id) {
  auto* e = static_cast<Engine*>(h);
  auto it = e->seqs.find(id);
  if (it == e->seqs.end()) return -1;
  e->release(it->second);
  e->seqs.erase(it);
  for (auto r = e->running.begin(); r != e->running.end(); ++r) {
    if (*r == id) { e->running.erase(r); break; }
  }
  for (auto w = e->waiting.begin(); w != e->waiting.end(); ++w) {
    if (*w == id) { e->waiting.erase(w); break; }
  }
  return 0;
}

// Batch introspection: ids, lengths, and page tables of the running batch.
int32_t fa_engine_batch_size(void* h) {
  return (int32_t)static_cast<Engine*>(h)->running.size();
}

void fa_engine_batch(void* h, int64_t* ids_out, int32_t* lens_out,
                     int32_t* pages_out, int32_t max_pages_per_seq) {
  auto* e = static_cast<Engine*>(h);
  for (size_t i = 0; i < e->running.size(); ++i) {
    auto& s = e->seqs[e->running[i]];
    ids_out[i] = s.id;
    lens_out[i] = s.total_len();
    for (int32_t j = 0; j < max_pages_per_seq; ++j) {
      pages_out[i * max_pages_per_seq + j] =
          j < (int32_t)s.pages.size() ? s.pages[j] : -1;
    }
  }
}

int32_t fa_engine_free_pages(void* h) {
  return (int32_t)static_cast<Engine*>(h)->free_pages.size();
}

int32_t fa_engine_waiting(void* h) {
  return (int32_t)static_cast<Engine*>(h)->waiting.size();
}

int64_t fa_engine_preempt_count(void* h) {
  return static_cast<Engine*>(h)->preempt_count;
}

}  // extern "C"
