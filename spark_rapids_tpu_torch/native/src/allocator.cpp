// Address-space sub-allocator (reference: AddressSpaceAllocator.scala — a
// first-fit allocator over one large pinned buffer used by the host memory
// store). Re-designed in C++ with coalescing free blocks and O(log n) free-list
// lookup by address; exposed to Python over a C ABI via ctypes.
//
// The allocator manages an abstract address space [0, size): callers bind the
// offsets to a host staging arena / pinned region. Thread safety is the
// caller's job (the Python store holds a lock), keeping this layer lock-free.
#include <cstdint>
#include <map>
#include <new>

namespace {

struct Allocator {
  uint64_t size;
  uint64_t available;
  // free blocks keyed by start offset -> length (coalescing neighbors on free)
  std::map<uint64_t, uint64_t> free_blocks;
  // live allocations: start offset -> length
  std::map<uint64_t, uint64_t> allocated;
};

}  // namespace

extern "C" {

void* srt_allocator_create(uint64_t size) {
  auto* a = new (std::nothrow) Allocator();
  if (a == nullptr) return nullptr;
  a->size = size;
  a->available = size;
  if (size > 0) a->free_blocks.emplace(0, size);
  return a;
}

void srt_allocator_destroy(void* handle) {
  delete static_cast<Allocator*>(handle);
}

// Returns the start offset, or UINT64_MAX when no block fits.
uint64_t srt_allocator_allocate(void* handle, uint64_t length) {
  auto* a = static_cast<Allocator*>(handle);
  if (length == 0 || a == nullptr) return UINT64_MAX;
  for (auto it = a->free_blocks.begin(); it != a->free_blocks.end(); ++it) {
    if (it->second >= length) {  // first fit
      uint64_t start = it->first;
      uint64_t remaining = it->second - length;
      a->free_blocks.erase(it);
      if (remaining > 0) a->free_blocks.emplace(start + length, remaining);
      a->allocated.emplace(start, length);
      a->available -= length;
      return start;
    }
  }
  return UINT64_MAX;
}

// Returns the freed length, or 0 if the offset was not an allocation start.
uint64_t srt_allocator_free(void* handle, uint64_t offset) {
  auto* a = static_cast<Allocator*>(handle);
  auto it = a->allocated.find(offset);
  if (it == a->allocated.end()) return 0;
  uint64_t length = it->second;
  a->allocated.erase(it);
  a->available += length;

  uint64_t start = offset;
  uint64_t end = offset + length;
  // coalesce with the following free block
  auto next = a->free_blocks.lower_bound(start);
  if (next != a->free_blocks.end() && next->first == end) {
    end += next->second;
    a->free_blocks.erase(next);
  }
  // coalesce with the preceding free block
  if (!a->free_blocks.empty()) {
    auto prev = a->free_blocks.lower_bound(start);
    if (prev != a->free_blocks.begin()) {
      --prev;
      if (prev->first + prev->second == start) {
        start = prev->first;
        a->free_blocks.erase(prev);
      }
    }
  }
  a->free_blocks.emplace(start, end - start);
  return length;
}

uint64_t srt_allocator_available(void* handle) {
  return static_cast<Allocator*>(handle)->available;
}

uint64_t srt_allocator_allocated_size(void* handle, uint64_t offset) {
  auto* a = static_cast<Allocator*>(handle);
  auto it = a->allocated.find(offset);
  return it == a->allocated.end() ? 0 : it->second;
}

uint64_t srt_allocator_num_free_blocks(void* handle) {
  return static_cast<Allocator*>(handle)->free_blocks.size();
}

uint64_t srt_allocator_largest_free_block(void* handle) {
  auto* a = static_cast<Allocator*>(handle);
  uint64_t best = 0;
  for (const auto& kv : a->free_blocks)
    if (kv.second > best) best = kv.second;
  return best;
}

}  // extern "C"
