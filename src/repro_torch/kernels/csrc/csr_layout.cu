// csr_layout: a graph's device layout expanded from its CSR in one pass.
// From row_ptr ([V+1] int64) it writes, for the 2E directed edges padded to
// P entries: src[i] = the row of edge i (V for padding); ell_slot[i] =
// min(i - row_ptr[src[i]], width) (width for padding); dst[2E:] = V (dst's
// head holds col_idx, copied in before the launch); and inc_ptr = row_ptr
// narrowed to int32.
//
// Replaces no TPU kernel: the reference builds this layout on the host in
// numpy (src/repro/core/graph.py::Graph.to_device), and so did the port
// until the host's edge list, slot map and padding took most of a request.
//
// Bound on an H100 SXM: bytes. row_ptr read once and src, ell_slot, the
// padding of dst and inc_ptr written once: 8(V+1) + 8P + 4(P-2E) + 4(V+1)
// bytes at 3.35 TB/s (0.17 ms for a scale-22 R-MAT graph). A few integer
// operations per edge are far below it.
//
// Design: one block per tile of 4,096 consecutive edges, so the skewed rows
// of R-MAT-G (max degree ~880, a row may span tiles) and runs of empty rows
// cost no block more than its share. Two warps find the tile's rows, those
// whose start lies in the tile, by a 32-ary search over row_ptr (five or
// six dependent loads, row_ptr L2-resident). The block reads those rows'
// pointers coalesced, writes inc_ptr from them, and marks in shared memory
// the start of each non-empty row (starts of non-empty rows are distinct,
// so no two rows mark one position). An inclusive max-scan over the tile
// then gives every edge the start of its row; the row id stored at that
// start gives src, and the distance to it the slot (edges before the
// tile's first start belong to the row before the tile's rows). Results
// leave through shared memory as coalesced 16-byte stores. Each edge index
// is 64-bit; a tile's local positions are 32-bit.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kLayoutThreads = 256;
constexpr int kLayoutItems = 16;
constexpr int kLayoutTile = kLayoutThreads * kLayoutItems;
constexpr int kLayoutWarps = kLayoutThreads / 32;
// one pad word after every 32: thread t's blocked items (16t .. 16t+15)
// and the striped 16-byte reads both fall in 32 distinct banks
constexpr int kLayoutSmem = kLayoutTile + kLayoutTile / 32;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// The first r in [0, n) with a[r] >= x, n if none: each step a warp probes
// 32 evenly spaced entries and keeps the span between the last probe below
// x and the first one at or above it. Every lane returns the answer.
__device__ long long warp_lower_bound(const long long* __restrict__ a, long long n,
                                      long long x, int lane) {
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long q = lo + lane * step;
    const bool at_or_above = q >= hi || __ldg(a + q) >= x;
    const unsigned m = __ballot_sync(0xffffffffu, at_or_above);
    if (m == 0) {
      lo += 31 * step + 1;
    } else {
      const int k = __ffs(m) - 1;
      if (k == 0) {
        hi = lo;
      } else {
        const long long qk = lo + k * step;
        lo += (k - 1) * step + 1;
        if (qk < hi) hi = qk;
      }
    }
  }
  return lo;
}

// Inclusive max-scan of the block's items in blocked order (thread t holds
// positions 16t .. 16t+15).
__device__ __forceinline__ void block_max_scan(int (&v)[kLayoutItems], int* warp_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 1; k < kLayoutItems; ++k) v[k] = max(v[k], v[k - 1]);
  int x = v[kLayoutItems - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = max(x, y);
  }
  int before = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) before = -1;
  if (lane == 31) warp_max[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
#pragma unroll
  for (int k = 0; k < kLayoutItems; ++k) v[k] = max(v[k], before);
}

__global__ void __launch_bounds__(kLayoutThreads)
    csr_layout_kernel(const long long* __restrict__ row_ptr, int V, long long E2, long long P,
                      int width, int* __restrict__ src, int* __restrict__ slot,
                      int* __restrict__ dst, int* __restrict__ inc_ptr) {
  // start: the local start of the non-empty row marked at each position (-1
  // elsewhere), then the tile's src; row_at: the row marked there, then its
  // slots
  __shared__ int start[kLayoutSmem];
  __shared__ int row_at[kLayoutSmem];
  __shared__ int warp_max[kLayoutWarps];
  __shared__ long long rows[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long e0 = static_cast<long long>(blockIdx.x) * kLayoutTile;
  const long long e1 = min(e0 + kLayoutTile, P);
  const int n = static_cast<int>(max(e1 - e0, 0LL));
  const long long nrows = static_cast<long long>(V) + 1;

  // the tile's rows: those that start in [e0, e1); the last tile also takes
  // the rows that start at P (the trailing empty rows and row V when 2E == P)
  if (warp < 2) {
    const long long r = (warp == 1 && e1 == P) ? nrows
                        : warp_lower_bound(row_ptr, nrows, warp == 0 ? e0 : e1, lane);
    if (lane == 0) rows[warp] = r;
  }
  for (int i = t; i < kLayoutSmem; i += kLayoutThreads) start[i] = -1;
  __syncthreads();
  const long long lo = rows[0], hi = rows[1];
  for (long long r = lo + t; r < hi; r += kLayoutThreads) {
    const long long p = __ldg(row_ptr + r);
    if (inc_ptr) inc_ptr[r] = static_cast<int>(p);
    if (r < V && __ldg(row_ptr + r + 1) > p) {
      const int j = static_cast<int>(p - e0);
      start[padded(j)] = j;
      row_at[padded(j)] = static_cast<int>(r);
    }
  }
  __syncthreads();

  int s[kLayoutItems];
#pragma unroll
  for (int k = 0; k < kLayoutItems; ++k) s[k] = start[padded(t * kLayoutItems + k)];
  block_max_scan(s, warp_max);
  // edges before the tile's first start belong to the last row before lo
  const int carry_row = static_cast<int>(lo - 1);
  const long long carry_start = lo > 0 ? __ldg(row_ptr + lo - 1) : 0;
  int out_src[kLayoutItems], out_slot[kLayoutItems];
#pragma unroll
  for (int k = 0; k < kLayoutItems; ++k) {
    const int j = t * kLayoutItems + k;
    if (e0 + j >= E2) {
      out_src[k] = V;
      out_slot[k] = width;
    } else if (s[k] >= 0) {
      out_src[k] = row_at[padded(s[k])];
      out_slot[k] = min(j - s[k], width);
    } else {
      out_src[k] = carry_row;
      out_slot[k] = static_cast<int>(min(e0 + j - carry_start, static_cast<long long>(width)));
    }
  }
  __syncthreads();  // every lookup of row_at is done
#pragma unroll
  for (int k = 0; k < kLayoutItems; ++k) {
    const int j = padded(t * kLayoutItems + k);
    start[j] = out_src[k];
    row_at[j] = out_slot[k];
  }
  __syncthreads();

  if (n == kLayoutTile && e1 <= E2) {  // a whole tile of edges: 16-byte stores
    int4* src4 = reinterpret_cast<int4*>(src + e0);
    int4* slot4 = slot ? reinterpret_cast<int4*>(slot + e0) : nullptr;
    for (int i = t; i < kLayoutTile / 4; i += kLayoutThreads) {
      const int j = padded(4 * i);
      src4[i] = make_int4(start[j], start[j + 1], start[j + 2], start[j + 3]);
      if (slot4) slot4[i] = make_int4(row_at[j], row_at[j + 1], row_at[j + 2], row_at[j + 3]);
    }
  } else {
    for (int i = t; i < n; i += kLayoutThreads) {
      const long long e = e0 + i;
      src[e] = start[padded(i)];
      if (slot) slot[e] = row_at[padded(i)];
      if (e >= E2) dst[e] = V;
    }
  }
}

}  // namespace repro_torch

// width < 1 (or a null slot) writes no slot map; a null inc_ptr no row
// pointers. src and slot must be 16-byte aligned.
extern "C" int repro_csr_layout(const void* row_ptr, int V, long long E2, long long P, int width,
                                void* src, void* slot, void* dst, void* inc_ptr, void* stream) {
  using namespace repro_torch;
  long long blocks = (P + kLayoutTile - 1) / kLayoutTile;
  if (blocks < 1) blocks = 1;  // E = 0 and no padding: one tile writes inc_ptr
  csr_layout_kernel<<<static_cast<unsigned int>(blocks), kLayoutThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(row_ptr), V, E2, P, width, static_cast<int*>(src),
      width >= 1 ? static_cast<int*>(slot) : nullptr, static_cast<int*>(dst),
      static_cast<int*>(inc_ptr));
  return static_cast<int>(cudaGetLastError());
}
