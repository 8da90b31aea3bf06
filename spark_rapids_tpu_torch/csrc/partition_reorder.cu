// Partition-reorder kernel: the map side of the device shuffle exchange.
//
// Replaces the TPU kernel spark_rapids_tpu/shuffle/partition_kernel.py:261
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
// Bound. The function is memory-bound: it must read every pid (cap x 4
// bytes) and every live row's data (live x L), and write every live row once
// (live x L) and the stats. For lineitem at SF 10 in 8 partitions (L = 76,
// cap = 67,108,864, 60,000,000 live rows) that is 9.40 GB: 2.805 ms at the
// H100's 3.35 TB/s. The pre-pass reads the pids a second time (0.27 GB).
//
// Design. One call runs two device kernels.
//
// 1. prepass_kernel, one CTA per group, reads only the pids. Each warp
//    counts its windows' rows per partition tile by tile (__match_any_sync
//    within a 32-row chunk), then n threads walk the group's windows once
//    for the running counts and the reference's overflow rule. It writes,
//    for every tile of R rows, the destination row of each partition's first
//    row in its piece (scratch `base`, [groups * T, n]) and the tile's live
//    row count (scratch `live`, [groups * T]), and the stats. So no tile's
//    data movement waits on another tile's ranks: this removes the first
//    limit of the window-serial version, whose CTA ranked a window (with
//    three block barriers and a serial scan) before it could issue that
//    window's loads.
// 2. reorder_kernel, a persistent grid sized by occupancy (shared memory and
//    registers, not the group count), walks the tiles. A tile's bytes
//    (row0 * L, R * L) are contiguous and 16-byte aligned, so one thread
//    brings them into shared memory with the 1-D bulk copy of the Tensor
//    Memory Accelerator (cp.async.bulk completing on an mbarrier). Two
//    buffers: the next tile loads while this one is written out. A tile
//    with no live row (the padding past num_rows) is neither read nor
//    written. Inside the tile the rows are ranked stably (__match_any_sync
//    in each warp's 32-row chunk plus the chunks' per-partition counts),
//    then copied into a staging buffer in partition-major order, each
//    partition's run placed at the same offset mod 16 as its destination in
//    the piece. The run is then written with coalesced 16-byte stores, the
//    head and tail bytes one by one. This removes the second limit (4-byte
//    stores scattered a row at a time, byte stores when L % 4 != 0): every
//    width writes 16-byte words, and the in-shared-memory permute moves
//    16-, 8-, 4- or 1-byte words by L's alignment. Live rows are the only
//    rows written; dead rows are read only when they share a tile with a
//    live one, and all-dead tiles are skipped (the third limit).
//
//    Rows of kWideRowBytes or more (several 256-byte string columns) do not
//    fit three R-row buffers in shared memory at any R worth having, and a
//    row can be wider than shared memory itself. Such rows take the same
//    kernel in its wide form: a tile is 32 rows, its contiguous bytes come in
//    kChunk-byte bulk copies (double-buffered across chunks and tiles), and
//    each row's piece of a chunk goes straight to its destination in 16-byte
//    stores, shifted in registers (funnel shifts) where the source and the
//    destination differ in alignment. A run is one row there, long enough
//    that the head and tail bytes are a few percent. So every width from 1
//    byte up runs in this one kernel.
//
// With a group's flag raised, rows past quota are not written, so no write
// leaves its piece. Byte offsets into data and out are 64-bit (the staging
// tensor is 6.37 GB at SF 10).
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kW = 512;                // rows per window (the overflow rule's)
constexpr int kMaxWindows = 64;        // windows per group
constexpr int kMaxParts = 32;
constexpr int kStatLanes = 128;
constexpr int kMaxChunks = kW / 32;    // 32-row chunks per window
constexpr int kPreThreads = 512;
constexpr int kPreWarps = kPreThreads / 32;
constexpr int kThreads = 256;          // reorder_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kWideRowBytes = 1024;    // rows this wide take the wide form
constexpr int kChunk = 16384;          // bytes per bulk copy in the wide form
constexpr int kWideRows = 32;
constexpr int kMaxRowBytes = 1 << 24;
static_assert(kMaxChunks <= 2 * kWarps, "two chunks per warp at most");
static_assert(kChunk / kWideRowBytes + 2 <= 32, "one warp plans a chunk");

struct Geom {
  int groups, G, n, q_w, quota, L;
  int R;                 // rows per tile
  int tiles_per_group;   // G * kW / R
};

__device__ __forceinline__ int warp_exclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  return incl - v;
}

// ------------------------------------------------------------------ pre-pass
__global__ void __launch_bounds__(kPreThreads)
prepass_kernel(const int32_t* __restrict__ pids, int32_t* __restrict__ base,
               int32_t* __restrict__ live_rows, int32_t* __restrict__ stats,
               Geom geo) {
  __shared__ int win[kMaxWindows][kMaxParts];   // counts, then run bases
  __shared__ int wcnt[kPreWarps][kMaxParts];
  __shared__ int total[kMaxParts];
  __shared__ int flag;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = geo.n;
  const int cpt = geo.R / 32;                   // chunks per tile
  const int tpw = kW / geo.R;                   // tiles per window
  const size_t tile0 = static_cast<size_t>(g) * geo.tiles_per_group;
  const unsigned below = (1u << lane) - 1u;

  if (tid == 0) flag = 0;
  wcnt[warp][lane] = 0;
  __syncwarp();
  for (int w = warp; w < geo.G; w += kPreWarps) {
    const int32_t* wp = pids + (static_cast<size_t>(g) * geo.G + w) * kW;
    int pv[kMaxChunks];
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) pv[k] = wp[k * 32 + lane];
    int before = 0;        // lane q: window rows of partition q in earlier tiles
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      int p = pv[k];
      const bool live = p >= 0 && p < n;
      if (!live) p = -1;
      const unsigned peers = __match_any_sync(0xffffffffu, p);
      if (live && (peers & below) == 0) wcnt[warp][p] += __popc(peers);
      __syncwarp();
      if ((k + 1) % cpt == 0) {                 // the tile ends here
        const size_t t = tile0 + static_cast<size_t>(w) * tpw + k / cpt;
        const int c = lane < n ? wcnt[warp][lane] : 0;
        if (lane < n) base[t * n + lane] = before;
        before += c;
        int sum = c;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) live_rows[t] = sum;
        wcnt[warp][lane] = 0;
        __syncwarp();
      }
    }
    if (lane < n) win[w][lane] = before;
  }
  __syncthreads();

  // the reference's overflow rule, window by window
  if (tid < n) {
    const int limit = geo.quota - (geo.q_w + 32);
    int run = 0;
    bool over = false;
    for (int w = 0; w < geo.G; ++w) {
      const int c = win[w][tid];
      if (c > geo.q_w || run + c > limit) over = true;
      win[w][tid] = run;
      run += c;
    }
    total[tid] = run;
    if (over) flag = 1;
  }
  __syncthreads();

  const int tn = geo.tiles_per_group * n;
  for (int i = tid; i < tn; i += kPreThreads) {
    const int t = i / n;
    base[tile0 * n + i] += win[t / tpw][i - t * n];
  }
  for (int i = tid; i < n * kStatLanes; i += kPreThreads) {
    const int j = i / kStatLanes;
    const int k = i % kStatLanes;
    stats[(static_cast<size_t>(g) * n + j) * kStatLanes + k] =
        k == 0 ? total[j] : (k == 1 ? flag : 0);
  }
}

// ------------------------------------------------------------------ bulk copy
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` a multiple of 16; both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes from shared memory at any alignment (reads up to 3 bytes past)
__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0) return *reinterpret_cast<const uint4*>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const unsigned sh = static_cast<unsigned>(a & 3) * 8;
  const uint32_t x0 = w[0], x1 = w[1], x2 = w[2], x3 = w[3], x4 = w[4];
  return make_uint4(__funnelshift_r(x0, x1, sh), __funnelshift_r(x1, x2, sh),
                    __funnelshift_r(x2, x3, sh), __funnelshift_r(x3, x4, sh));
}

// The runs of one step: run s copies len[s] bytes from shared memory at
// dsm + src[s] to global memory at dst[s]; w0[s] is the index of its first
// 16-byte destination word in the step's word list (w0[32] = all words).
struct Runs {
  int src[32];
  int len[32];
  int w0[33];
  uint8_t* dst[32];
};

// Every thread takes every kThreads-th destination word: whole words go as
// one 16-byte store, a run's head and tail words byte by byte.
__device__ void write_runs(const uint8_t* dsm, const Runs& r) {
  const int total = r.w0[32];
  int s = 0;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    while (i >= r.w0[s + 1]) ++s;
    uint8_t* d0 = r.dst[s];
    uint8_t* d1 = d0 + r.len[s];
    uint8_t* wd = reinterpret_cast<uint8_t*>(
                      reinterpret_cast<uintptr_t>(d0) & ~uintptr_t(15)) +
                  static_cast<size_t>(i - r.w0[s]) * 16;
    const uint8_t* src = dsm + r.src[s] + (wd - d0);
    if (wd >= d0 && wd + 16 <= d1) {
      *reinterpret_cast<uint4*>(wd) = load16(src);
    } else {
      uint8_t* lo = wd < d0 ? d0 : wd;
      uint8_t* hi = wd + 16 < d1 ? wd + 16 : d1;
      for (uint8_t* q = lo; q < hi; ++q) *q = src[q - wd];
    }
  }
}

// ------------------------------------------------------------------ reorder
// T: the word of the in-shared-memory permute (L % sizeof(T) == 0).
// kWide: 32-row tiles in kChunk-byte pieces, rows written one by one.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
reorder_kernel(const int32_t* __restrict__ pids,
               const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
               const int32_t* __restrict__ base,
               const int32_t* __restrict__ live_rows, Geom geo) {
  extern __shared__ __align__(16) uint8_t dsm[];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int chunk_cnt[kMaxChunks][kMaxParts];   // counts, then offsets
  __shared__ int run_off[kMaxParts];
  __shared__ uint8_t* row_dst[kWideRows];
  __shared__ Runs runs;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int n = geo.n;
  const int L = geo.L;
  const int R = geo.R;
  const int nch = R / 32;
  const int tiles = geo.groups * geo.tiles_per_group;
  const int tile_bytes = R * L;
  const int nsteps = kWide ? (tile_bytes + kChunk - 1) / kChunk : 1;
  const int buf_bytes = kWide ? kChunk + 16 : 4 * R + tile_bytes;
  const int stage_off = 2 * buf_bytes;

  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto next_live = [&](int t) {
    while (t < tiles && live_rows[t] == 0) t += gridDim.x;
    return t;
  };
  // step (t, c): piece c of tile t into buffer b (one thread)
  auto issue = [&](int t, int c, int b) {
    uint8_t* buf = dsm + b * buf_bytes;
    const uint8_t* src = data + static_cast<size_t>(t) * tile_bytes;
    if (kWide) {
      const int off = c * kChunk;
      const int bytes = min(kChunk, tile_bytes - off);
      mbar_expect(&bar[b], bytes);
      bulk_load(buf, src + off, bytes, &bar[b]);
    } else {
      mbar_expect(&bar[b], 4 * R + tile_bytes);
      bulk_load(buf, pids + static_cast<size_t>(t) * R, 4 * R, &bar[b]);
      bulk_load(buf + 4 * R, src, tile_bytes, &bar[b]);
    }
  };

  int t = next_live(blockIdx.x);
  int c = 0;
  if (tid == 0 && t < tiles) issue(t, 0, 0);
  for (int i = 0; t < tiles; ++i) {
    const int b = i & 1;
    int tn = t, cn = c + 1;
    if (cn == nsteps) {
      cn = 0;
      tn = next_live(t + gridDim.x);
    }
    if (tid == 0 && tn < tiles) issue(tn, cn, b ^ 1);
    const uint8_t* buf = dsm + b * buf_bytes;
    const int g = t / geo.tiles_per_group;

    if (kWide) {
      if (warp == 0) {
        if (c == 0) {            // the tile's 32 rows: one chunk of ranks
          int p = pids[static_cast<size_t>(t) * kWideRows + lane];
          const bool live = p >= 0 && p < n;
          if (!live) p = -1;
          const unsigned peers = __match_any_sync(0xffffffffu, p);
          uint8_t* d = nullptr;
          if (live) {
            const int row = base[static_cast<size_t>(t) * n + p] +
                            __popc(peers & below);
            if (row < geo.quota) {
              d = out + ((static_cast<size_t>(p) * geo.groups + g) *
                             geo.quota + row) * static_cast<size_t>(L);
            }
          }
          row_dst[lane] = d;
          __syncwarp();
        }
        // lane k: the piece of row b0 / L + k inside this chunk
        const int b0 = c * kChunk;
        const int b1 = min(b0 + kChunk, tile_bytes);
        const int r = b0 / L + lane;
        int len = 0, src = 0;
        uint8_t* d = nullptr;
        if (r < kWideRows && r * L < b1) {
          const int s0 = max(b0, r * L);
          const int s1 = min(b1, (r + 1) * L);
          if (row_dst[r] != nullptr) {
            d = row_dst[r] + (s0 - r * L);
            len = s1 - s0;
            src = b * buf_bytes + (s0 - b0);
          }
        }
        const int words =
            len > 0 ? (static_cast<int>(reinterpret_cast<uintptr_t>(d) & 15) +
                       len + 15) >> 4
                    : 0;
        const int w0 = warp_exclusive_sum(words);
        runs.src[lane] = src;
        runs.len[lane] = len;
        runs.dst[lane] = d;
        runs.w0[lane] = w0;
        if (lane == 31) runs.w0[32] = w0 + words;
      }
      mbar_wait(&bar[b], (i >> 1) & 1);
      __syncthreads();
      write_runs(dsm, runs);
    } else {
      mbar_wait(&bar[b], (i >> 1) & 1);
      const int32_t* pid_s = reinterpret_cast<const int32_t*>(buf);
      const uint8_t* dat_s = buf + 4 * R;
      // stable ranks: a warp's chunk rows by __match_any_sync, the chunks'
      // per-partition counts in shared memory
      int my_p[2], my_rank[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ch = warp + j * kWarps;
        my_p[j] = -1;
        my_rank[j] = 0;
        if (ch < nch) {
          int p = pid_s[ch * 32 + lane];
          const bool live = p >= 0 && p < n;
          if (!live) p = -1;
          const unsigned peers = __match_any_sync(0xffffffffu, p);
          my_rank[j] = __popc(peers & below);
          chunk_cnt[ch][lane] = 0;
          __syncwarp();
          if (live && my_rank[j] == 0) chunk_cnt[ch][p] = __popc(peers);
          my_p[j] = p;
        }
      }
      __syncthreads();
      // lane p: partition p's chunk offsets, its run in the staging buffer
      // (at its destination's offset mod 16) and its destination words
      if (warp == 0) {
        const int p = lane;
        int rows = 0;
        if (p < n) {
          for (int ch = 0; ch < nch; ++ch) {
            const int v = chunk_cnt[ch][p];
            chunk_cnt[ch][p] = rows;
            rows += v;
          }
        }
        int len = 0, slot = 0;
        uint8_t* d = nullptr;
        if (p < n) {
          const int dst0 = base[static_cast<size_t>(t) * n + p];
          const int keep = max(0, min(rows, geo.quota - dst0));
          d = out + ((static_cast<size_t>(p) * geo.groups + g) * geo.quota +
                     dst0) * static_cast<size_t>(L);
          len = keep * L;
          slot = ((rows * L + 15) & ~15) + 16;
        }
        const int a = static_cast<int>(reinterpret_cast<uintptr_t>(d) & 15);
        const int start = warp_exclusive_sum(slot) + a;
        const int words = len > 0 ? (a + len + 15) >> 4 : 0;
        const int w0 = warp_exclusive_sum(words);
        run_off[p] = start;
        runs.src[lane] = stage_off + start;
        runs.len[lane] = len;
        runs.dst[lane] = d;
        runs.w0[lane] = w0;
        if (lane == 31) runs.w0[32] = w0 + words;
      }
      __syncthreads();
      // permute: the warp's 32 contiguous rows, word by word, each word to
      // its row's place in its partition's run
      uint8_t* stage = dsm + stage_off;
      const int words = L / static_cast<int>(sizeof(T));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ch = warp + j * kWarps;
        if (ch >= nch) break;
        const int p = my_p[j];
        const int dst =
            p >= 0 ? run_off[p] + (chunk_cnt[ch][p] + my_rank[j]) * L : -1;
        const T* src = reinterpret_cast<const T*>(dat_s + ch * 32 * L);
        for (int f = lane; f < 32 * words; f += 32) {
          const int r = f / words;
          const int d = __shfl_sync(0xffffffffu, dst, r);
          if (d >= 0) reinterpret_cast<T*>(stage + d)[f - r * words] = src[f];
        }
      }
      __syncthreads();
      write_runs(dsm, runs);
    }
    __syncthreads();         // buffer b, the staging buffer and `runs` free
    t = tn;
    c = cn;
  }
}

// Dynamic shared memory of reorder_kernel; shuffle/partition_kernel.py
// reorder_tile_rows picks R by the same sum.
int smem_bytes(int R, int L, bool wide) {
  if (wide) return 2 * (kChunk + 16);
  // two tile buffers (pids, rows) and the staging buffer: the rows plus at
  // most 31 bytes of alignment slack per run
  return 2 * (4 * R + R * L) + R * L + kMaxParts * 32;
}

template <typename T, bool kWide>
int launch_main(const int32_t* pids, const uint8_t* data, uint8_t* out,
                const int32_t* base, const int32_t* live, const Geom& geo,
                cudaStream_t s) {
  auto kernel = reorder_kernel<T, kWide>;
  const int smem = smem_bytes(geo.R, geo.L, kWide);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles =
      static_cast<long long>(geo.groups) * geo.tiles_per_group;
  const int grid = static_cast<int>(
      tiles < static_cast<long long>(per_sm) * sms ? tiles
                                                   : per_sm * sms);
  kernel<<<grid, kThreads, smem, s>>>(pids, data, out, base, live, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the pre-pass and the reorder on `stream` and returns the first
// CUDA error (0 on success), checking cudaGetLastError() after each launch.
// The caller allocates `out`, `stats` and `scratch` (int32, groups * T *
// (n + 1) with T = G * 512 / tile_rows tiles per group). tile_rows is a
// power of two in [32, 512]; 32 for rows of 1024 bytes or more. pids, data
// and out must be 16-byte aligned.
extern "C" int partition_reorder(const int32_t* pids, const uint8_t* data,
                                 uint8_t* out, int32_t* stats,
                                 int32_t* scratch, int groups, int G, int n,
                                 int q_w, int quota, int L, int tile_rows,
                                 void* stream) {
  const bool wide = L >= kWideRowBytes;
  const bool pow2 = tile_rows > 0 && (tile_rows & (tile_rows - 1)) == 0;
  if (groups < 1 || G < 1 || G > kMaxWindows || n < 1 || n > kMaxParts ||
      L < 1 || L > kMaxRowBytes || quota < 1 || !pow2 || tile_rows < 32 ||
      tile_rows > kW || (wide && tile_rows != kWideRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(pids) | reinterpret_cast<uintptr_t>(data) |
       reinterpret_cast<uintptr_t>(out)) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const Geom geo{groups, G, n, q_w, quota, L, tile_rows,
                 G * (kW / tile_rows)};
  const long long tiles = static_cast<long long>(groups) * geo.tiles_per_group;
  if (tiles * tile_rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* base = scratch;
  int32_t* live = scratch + static_cast<size_t>(tiles) * n;
  prepass_kernel<<<groups, kPreThreads, 0, s>>>(pids, base, live, stats, geo);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (wide) return launch_main<uint8_t, true>(pids, data, out, base, live, geo, s);
  if (L % 16 == 0) {
    return launch_main<uint4, false>(pids, data, out, base, live, geo, s);
  }
  if (L % 8 == 0) {
    return launch_main<uint2, false>(pids, data, out, base, live, geo, s);
  }
  if (L % 4 == 0) {
    return launch_main<uint32_t, false>(pids, data, out, base, live, geo, s);
  }
  return launch_main<uint8_t, false>(pids, data, out, base, live, geo, s);
}

extern "C" const char* partition_reorder_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
