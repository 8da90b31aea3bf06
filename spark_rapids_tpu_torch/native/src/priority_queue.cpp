// Hashed priority queue: O(log n) push/pop with O(1) contains and
// O(log n) priority update by key (reference: HashedPriorityQueue.java, used
// for spill ordering in RapidsBufferStore). Min-heap on (priority, seq):
// lowest priority spills first, FIFO among equals via the insertion sequence.
#include <cstddef>
#include <cstdint>
#include <new>
#include <unordered_map>
#include <utility>
#include <vector>

using std::size_t;

namespace {

struct Entry {
  int64_t key;
  double priority;
  uint64_t seq;
};

struct HeapQueue {
  std::vector<Entry> heap;                      // binary min-heap
  std::unordered_map<int64_t, size_t> index;    // key -> heap slot
  uint64_t next_seq = 0;

  bool less(const Entry& a, const Entry& b) const {
    if (a.priority != b.priority) return a.priority < b.priority;
    return a.seq < b.seq;
  }

  void swap_slots(size_t i, size_t j) {
    std::swap(heap[i], heap[j]);
    index[heap[i].key] = i;
    index[heap[j].key] = j;
  }

  void sift_up(size_t i) {
    while (i > 0) {
      size_t parent = (i - 1) / 2;
      if (!less(heap[i], heap[parent])) break;
      swap_slots(i, parent);
      i = parent;
    }
  }

  void sift_down(size_t i) {
    size_t n = heap.size();
    for (;;) {
      size_t l = 2 * i + 1, r = 2 * i + 2, best = i;
      if (l < n && less(heap[l], heap[best])) best = l;
      if (r < n && less(heap[r], heap[best])) best = r;
      if (best == i) break;
      swap_slots(i, best);
      i = best;
    }
  }

  void remove_at(size_t i) {
    index.erase(heap[i].key);
    size_t last = heap.size() - 1;
    if (i != last) {
      heap[i] = heap[last];
      index[heap[i].key] = i;
      heap.pop_back();
      sift_down(i);
      sift_up(i);
    } else {
      heap.pop_back();
    }
  }
};

}  // namespace

extern "C" {

void* srt_pq_create() { return new (std::nothrow) HeapQueue(); }

void srt_pq_destroy(void* handle) { delete static_cast<HeapQueue*>(handle); }

// Insert or update: returns 1 if inserted, 0 if an existing key was updated.
int srt_pq_offer(void* handle, int64_t key, double priority) {
  auto* q = static_cast<HeapQueue*>(handle);
  auto it = q->index.find(key);
  if (it != q->index.end()) {
    size_t i = it->second;
    q->heap[i].priority = priority;
    q->sift_down(i);
    q->sift_up(i);
    return 0;
  }
  q->heap.push_back(Entry{key, priority, q->next_seq++});
  size_t i = q->heap.size() - 1;
  q->index[key] = i;
  q->sift_up(i);
  return 1;
}

int srt_pq_contains(void* handle, int64_t key) {
  auto* q = static_cast<HeapQueue*>(handle);
  return q->index.count(key) ? 1 : 0;
}

// Pop the minimum-priority entry. Returns 0 when empty.
int srt_pq_poll(void* handle, int64_t* key_out, double* priority_out) {
  auto* q = static_cast<HeapQueue*>(handle);
  if (q->heap.empty()) return 0;
  *key_out = q->heap[0].key;
  *priority_out = q->heap[0].priority;
  q->remove_at(0);
  return 1;
}

int srt_pq_peek(void* handle, int64_t* key_out, double* priority_out) {
  auto* q = static_cast<HeapQueue*>(handle);
  if (q->heap.empty()) return 0;
  *key_out = q->heap[0].key;
  *priority_out = q->heap[0].priority;
  return 1;
}

int srt_pq_remove(void* handle, int64_t key) {
  auto* q = static_cast<HeapQueue*>(handle);
  auto it = q->index.find(key);
  if (it == q->index.end()) return 0;
  q->remove_at(it->second);
  return 1;
}

uint64_t srt_pq_size(void* handle) {
  return static_cast<HeapQueue*>(handle)->heap.size();
}

}  // extern "C"
