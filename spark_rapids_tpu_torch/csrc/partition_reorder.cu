// Partition-reorder kernel: the map side of the device shuffle exchange.
//
// Replaces the TPU kernel spark_rapids_tpu/shuffle/partition_kernel.py
// ::_make_kernel (its inner `kernel`, launched at partition_kernel.py:384),
// with the same contract, so the two are compared byte for byte:
//
//   pids  int32 [groups, G, W]      partition id per row, -1 = dead/padding
//   data  uint8 [groups, G*W, L]    packed rows (shuffle/partition_kernel.py
//                                   pack_matrix)
//   out   uint8 [n, groups, quota, L]
//         piece (j, g) holds partition j's live rows of group g, in their
//         original order, at rows [0, count); bytes past count are undefined
//   stats int32 [groups, n, 128]    lane 0: the piece's live count; lane 1:
//         1 when any window of the group overflowed (a window's count for a
//         partition above q_w, or a running count above quota - (q_w + 32));
//         other lanes 0. A raised flag sends the batch to the sort path.
//
// Design. The TPU grid carries each partition's running count from one
// window to the next; GPU blocks run in no order, so one block owns one
// group and loops over its G windows of W = 512 rows, one row per thread.
// Stable ranks within a window come from __match_any_sync (the lanes of a
// warp that share a partition id) plus per-warp partition counts in shared
// memory, prefix-summed over the 16 warps. Each row then goes to
// run[p] + rank. The copy is warp-cooperative: the warp's 32 rows are one
// contiguous run of the input, which its lanes read word by word (4-byte
// words when the row width allows it, else bytes), so the loads coalesce and
// the stores of rows bound for one piece land side by side. Rows that would
// land past the end of an overflowing piece are not written.
//
// Bound. The function is memory-bound: it must read every pid (cap x 4
// bytes) and every live row's data (live x L; no output depends on a dead or
// padding row's bytes), and write every live row once (live x L). For
// lineitem at SF 10 in 8 partitions (L = 76, cap = 67,108,864, 60,000,000
// live rows) that is ~4.8 GB read and ~4.6 GB written: ~2.8 ms at the
// H100's 3.35 TB/s. This version skips the data of warps whose 32 rows are
// all dead, but reads a dead row's data when it shares a warp with a live
// one; it aims to be right, not fast.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kW = 512;                 // rows per window = threads per block
constexpr int kWarps = kW / 32;
constexpr int kMaxParts = 32;
constexpr int kStatLanes = 128;
constexpr int kUnroll = 4;               // loads in flight per lane
static_assert(kWarps * kMaxParts == kW, "one counter per thread to clear");

template <typename T>
__global__ void __launch_bounds__(kW)
reorder_kernel(const int32_t* __restrict__ pids,
               const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
               int32_t* __restrict__ stats, int groups, int G, int n,
               int q_w, int quota, int L) {
  __shared__ int warp_cnt[kWarps][kMaxParts];
  __shared__ int warp_off[kWarps][kMaxParts];
  __shared__ int run[kMaxParts];
  __shared__ int base[kMaxParts];
  __shared__ int flag;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int limit = quota - (q_w + 32);
  const int words = L / static_cast<int>(sizeof(T));
  const unsigned below = (1u << lane) - 1u;
  const size_t group_row0 = static_cast<size_t>(g) * G * kW;

  if (tid < kMaxParts) run[tid] = 0;
  if (tid == 0) flag = 0;

  for (int w = 0; w < G; ++w) {
    (&warp_cnt[0][0])[tid] = 0;
    __syncthreads();

    const size_t win_row0 = group_row0 + static_cast<size_t>(w) * kW;
    int p = pids[win_row0 + tid];
    const bool live = p >= 0 && p < n;
    if (!live) p = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, p);
    const int rank_in_warp = __popc(peers & below);
    if (live && rank_in_warp == 0) warp_cnt[warp][p] = __popc(peers);
    __syncthreads();

    if (tid < n) {
      int acc = 0;
      for (int k = 0; k < kWarps; ++k) {
        warp_off[k][tid] = acc;
        acc += warp_cnt[k][tid];
      }
      const int r = run[tid];
      if (acc > q_w || r + acc > limit) flag = 1;
      base[tid] = r;
      run[tid] = r + acc;
    }
    __syncthreads();

    // The warp's 32 rows are one contiguous run of 32 * words words in
    // `data`; lane i copies words i, i + 32, ... of that run, so every load
    // is coalesced, and each word goes to its row's place in its piece.
    // kUnroll loads are issued before their stores to keep more in flight.
    // Step s of the loop is valid for all lanes or none (s < words), so the
    // shuffles run with the full warp.
    // A warp whose 32 rows are all dead (padding past num_rows) has nothing
    // to copy: its data is not read. The test is warp-uniform.
    if (!__any_sync(0xffffffffu, live)) continue;
    const int dst = live ? base[p] + warp_off[warp][p] + rank_in_warp : -1;
    const T* src = reinterpret_cast<const T*>(
        data + (win_row0 + warp * 32) * static_cast<size_t>(L));
    for (int s0 = 0; s0 < words; s0 += kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s0 + u < words) v[u] = src[(s0 + u) * 32 + lane];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s0 + u >= words) break;
        const int f = (s0 + u) * 32 + lane;
        const int r = f / words;
        const int k = f - r * words;
        const int d = __shfl_sync(0xffffffffu, dst, r);
        const int pr = __shfl_sync(0xffffffffu, p, r);
        if (d < 0 || d >= quota) continue;
        T* dstp = reinterpret_cast<T*>(
            out + ((static_cast<size_t>(pr) * groups + g) * quota + d) *
                      static_cast<size_t>(L));
        dstp[k] = v[u];
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < n * kStatLanes; i += kW) {
    const int j = i / kStatLanes;
    const int k = i % kStatLanes;
    stats[(static_cast<size_t>(g) * n + j) * kStatLanes + k] =
        k == 0 ? run[j] : (k == 1 ? flag : 0);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` and `stats`; `vec4` selects 4-byte copies and
// requires L % 4 == 0 and 4-byte aligned `data` and `out`.
extern "C" int partition_reorder(const int32_t* pids, const uint8_t* data,
                                 uint8_t* out, int32_t* stats, int groups,
                                 int G, int n, int q_w, int quota, int L,
                                 int vec4, void* stream) {
  if (groups < 1 || G < 1 || n < 1 || n > kMaxParts || L < 1 || quota < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    reorder_kernel<uint32_t><<<groups, kW, 0, s>>>(pids, data, out, stats,
                                                   groups, G, n, q_w, quota,
                                                   L);
  } else {
    reorder_kernel<uint8_t><<<groups, kW, 0, s>>>(pids, data, out, stats,
                                                  groups, G, n, q_w, quota, L);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* partition_reorder_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
