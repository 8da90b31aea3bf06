// DMA-consolidation kernel: one launch compacts every partition's pieces.
//
// Replaces the TPU kernel spark_rapids_tpu/shuffle/partition_kernel.py
// ::_build_dma_compact (its inner `kernel`, launched at
// partition_kernel.py:676). It computes the same function: partition j's
// live rows, in the reference's order, contiguous at rows [0, total_j) of
// compact[j]. That order is every group's full 8-row blocks, group after
// group, then every group's remainder rows, group after group.
//
//   out      uint8 [n, groups, quota, L]  the partition-reorder kernel's
//            staging pieces; piece (j, g) holds count[g, j] live rows, and
//            its bytes past them are undefined and never read
//   idx      int32, one array:
//              prefix8 [n, groups]  destination row of piece (j, g)'s
//                                   full-block run (a multiple of 8)
//              nb8     [n]          full-block rows of partition j
//              totals  [n]          live rows of partition j
//              fills   [n]          bucket_capacity(totals[j]), or 0 when
//                                   the partition is empty
//              ridx    [n, ri_cap]  staging row (within partition j) of
//                                   each remainder row, in order
//            (shuffle/partition_kernel.py dma_index_plan)
//   compact  uint8 [n, dst_rows, L]  rows [0, totals[j]) the live rows,
//            rows [totals[j], fills[j]) zero, rows past fills[j] undefined
//
// Design. The TPU kernel copies each whole quota-row piece to prefix8[j, g]
// and relies on the grid running in order: group g's copy overwrites group
// g-1's padding tail, and the remainder copy lands last. GPU blocks run in
// no order, so that would race. Here each CTA of the first `groups` columns
// of the grid copies only piece (g, j)'s nb*8 full-block rows: one
// contiguous run in the source and in the destination, and the runs are
// disjoint, so no order is needed. The remaining `tail_ctas` columns split
// each partition's rows [nb8[j], fills[j]) into chunks: a chunk gathers its
// remainder rows straight from the staging rows that ridx names (the TPU
// version pre-gathers them into a temporary) and zeroes its padding rows.
// There is no 128-lane pad: that existed only for the TPU's lane tiling.
// Byte offsets are 64-bit (the staging tensor passes 2^31 bytes at SF 10).
//
// Bound. The function moves bytes and computes nothing: every live row is
// read once and written once, the padding rows are written once, and the
// index arrays are read. For lineitem at SF 10 in 8 partitions (60,000,000
// live rows, L = 76, about 7.1M padding rows) that is ~9.7 GB: ~2.9 ms at
// the H100's 3.35 TB/s. The runs move in 16-byte words when the row width
// allows it (8 * L % 16 == 0 and 16-byte aligned bases), else in 8-byte
// words (8 * L is always a multiple of 8), with four loads in flight per
// thread before their stores. Remainder rows are few (at most 7 per piece)
// and move in 4-byte words or bytes.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // loads in flight per thread

// Copy `bytes` bytes (a multiple of sizeof(T); both pointers aligned to it)
// with the CTA's threads striding over words.
template <typename T>
__device__ void copy_run(const uint8_t* __restrict__ src,
                         uint8_t* __restrict__ dst, size_t bytes) {
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  const size_t words = bytes / sizeof(T);
  size_t i = threadIdx.x;
  for (; i + static_cast<size_t>(kUnroll - 1) * kThreads < words;
       i += static_cast<size_t>(kUnroll) * kThreads) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = s[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d[i + u * kThreads] = v[u];
  }
  for (; i < words; i += kThreads) d[i] = s[i];
}

// Zero `bytes` bytes: single bytes up to a 16-byte boundary, then 16-byte
// stores, then the last bytes.
__device__ void zero_bytes(uint8_t* dst, size_t bytes) {
  size_t head = (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  if (head > bytes) head = bytes;
  for (size_t i = threadIdx.x; i < head; i += kThreads) dst[i] = 0;
  uint4* body = reinterpret_cast<uint4*>(dst + head);
  const size_t nvec = (bytes - head) / 16;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (size_t i = threadIdx.x; i < nvec; i += kThreads) body[i] = z;
  uint8_t* tail = dst + head + nvec * 16;
  const size_t ntail = bytes - head - nvec * 16;
  for (size_t i = threadIdx.x; i < ntail; i += kThreads) tail[i] = 0;
}

// Copy remainder rows [r0, r1) of one partition (indices into its ridx row)
// to consecutive destination rows starting at `dst`.
template <typename T>
__device__ void gather_rows(const uint8_t* __restrict__ src_part,
                            const int32_t* __restrict__ ridx, int r0, int r1,
                            uint8_t* __restrict__ dst, int L) {
  const int words = L / static_cast<int>(sizeof(T));
  const size_t count = static_cast<size_t>(r1 - r0) * words;
  for (size_t f = threadIdx.x; f < count; f += kThreads) {
    const int r = static_cast<int>(f / words);
    const int k = static_cast<int>(f - static_cast<size_t>(r) * words);
    const T* s = reinterpret_cast<const T*>(
        src_part + static_cast<size_t>(ridx[r0 + r]) * L);
    reinterpret_cast<T*>(dst + static_cast<size_t>(r) * L)[k] = s[k];
  }
}

template <typename TRun, typename TRow>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ out,
               const int32_t* __restrict__ idx, uint8_t* __restrict__ compact,
               int groups, int n, int quota, int L, int ri_cap, int dst_rows,
               int tail_ctas) {
  const int j = blockIdx.y;
  const int x = blockIdx.x;
  const int32_t* prefix8 = idx;
  const int32_t* nb8 = prefix8 + static_cast<size_t>(n) * groups;
  const int32_t* totals = nb8 + n;
  const int32_t* fills = totals + n;
  const int32_t* ridx = fills + n + static_cast<size_t>(j) * ri_cap;
  const size_t row = static_cast<size_t>(L);
  const size_t piece_rows = static_cast<size_t>(quota);
  uint8_t* dst_part = compact + static_cast<size_t>(j) * dst_rows * row;

  if (x < groups) {
    // piece (j, x): its full-block rows, one contiguous run
    const int32_t* p = prefix8 + static_cast<size_t>(j) * groups;
    const int start = p[x];
    const int end = x + 1 < groups ? p[x + 1] : nb8[j];
    if (end <= start) return;
    const uint8_t* src =
        out + (static_cast<size_t>(j) * groups + x) * piece_rows * row;
    copy_run<TRun>(src, dst_part + static_cast<size_t>(start) * row,
                   static_cast<size_t>(end - start) * row);
    return;
  }

  // chunk t of partition j's rows [nb8, fills): remainder rows, then zeros
  const int t = x - groups;
  const int begin = nb8[j];
  const int fill = fills[j];
  const int total = totals[j];
  if (fill <= begin) return;
  const int per = (fill - begin + tail_ctas - 1) / tail_ctas;
  const int r0 = begin + t * per;
  if (r0 >= fill) return;
  const int r1 = min(fill, r0 + per);
  const int g1 = min(r1, total);
  if (g1 > r0) {
    const uint8_t* src_part =
        out + static_cast<size_t>(j) * groups * piece_rows * row;
    gather_rows<TRow>(src_part, ridx, r0 - begin, g1 - begin,
                      dst_part + static_cast<size_t>(r0) * row, L);
  }
  const int z0 = max(r0, total);
  if (r1 > z0) {
    zero_bytes(dst_part + static_cast<size_t>(z0) * row,
               static_cast<size_t>(r1 - z0) * row);
  }
}

template <typename TRun, typename TRow>
void launch(const uint8_t* out, const int32_t* idx, uint8_t* compact,
            int groups, int n, int quota, int L, int ri_cap, int dst_rows,
            int tail_ctas, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(groups + tail_ctas),
                  static_cast<unsigned>(n));
  compact_kernel<TRun, TRow><<<grid, kThreads, 0, s>>>(
      out, idx, compact, groups, n, quota, L, ri_cap, dst_rows, tail_ctas);
}

template <typename TRun>
void launch_rows(const uint8_t* out, const int32_t* idx, uint8_t* compact,
                 int groups, int n, int quota, int L, int ri_cap,
                 int dst_rows, int tail_ctas, bool row4, cudaStream_t s) {
  if (row4) {
    launch<TRun, uint32_t>(out, idx, compact, groups, n, quota, L, ri_cap,
                           dst_rows, tail_ctas, s);
  } else {
    launch<TRun, uint8_t>(out, idx, compact, groups, n, quota, L, ri_cap,
                          dst_rows, tail_ctas, s);
  }
}

bool words_fit(uintptr_t bases, int L, int quota, int dst_rows, size_t w) {
  // every run starts at a multiple of quota * L (source) or of 8 * L past a
  // multiple of dst_rows * L (destination), and is a multiple of 8 * L long
  return bases % w == 0 && (8 * static_cast<size_t>(L)) % w == 0 &&
         (static_cast<size_t>(quota) * L) % w == 0 &&
         (static_cast<size_t>(dst_rows) * L) % w == 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `compact` ([n, dst_rows, L]) and uploads `idx`.
extern "C" int dma_compact(const uint8_t* out, const int32_t* idx,
                           uint8_t* compact, int groups, int n, int quota,
                           int L, int ri_cap, int dst_rows, int tail_ctas,
                           void* stream) {
  if (groups < 1 || n < 1 || n > 65535 || quota < 1 || L < 1 || ri_cap < 1 ||
      dst_rows < 1 || tail_ctas < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(compact);
  const bool row4 = L % 4 == 0 && bases % 4 == 0;
  if (words_fit(bases, L, quota, dst_rows, 16)) {
    launch_rows<uint4>(out, idx, compact, groups, n, quota, L, ri_cap,
                       dst_rows, tail_ctas, row4, s);
  } else if (words_fit(bases, L, quota, dst_rows, 8)) {
    launch_rows<unsigned long long>(out, idx, compact, groups, n, quota, L,
                                    ri_cap, dst_rows, tail_ctas, row4, s);
  } else {
    launch_rows<uint8_t>(out, idx, compact, groups, n, quota, L, ri_cap,
                         dst_rows, tail_ctas, row4, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dma_compact_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
