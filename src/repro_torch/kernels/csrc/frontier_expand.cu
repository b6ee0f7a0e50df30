// frontier_expand: the edge half of the frontier's compaction
// (repro_torch.core.frontier.compact_frontier). A slab row r of graph b holds
// the vertex vert[b, r] and its vdeg[b, r] incident edges, from
// starts[b, r], the exclusive sum of vdeg. For every slab entry e in
// [0, cap_e) the kernel writes the row that owns it, its slot in the row,
// the row's vertex and the edge's target:
//   owner = the largest r with vdeg[r] > 0 and starts[r] <= e (0 if none),
//   slot  = e - starts[owner],  src = vert[owner],
//   dst   = dst_csr[clamp(inc_ptr[min(src, V)] + slot, 0, E - 1)] (fill if E = 0),
// and the pads (cap_v, V, fill, 0) for e >= min(ne, cap_e). With cap_v = 0
// the owner is 0 with slot e and src V. It is the function that the plain
// version floods with a scatter_reduce_ amax of row ids and a cummax, then
// four gathers; both agree bit for bit, overflow (ne > cap_e, rows cut at
// cap_v) included: int32 sums wrap as the plain version's do.
//
// Replaces no TPU kernel: the reference floods the row ids with XLA's
// lax.cummax (src/repro/core/frontier.py:178). The port's cummax ran as
// PyTorch's scan with indices, which walks a graph's whole slab in one
// thread block, 32 entries a step: ~3.8 ms a call at cap_e = 2^22.
//
// Bound on an H100 SXM: bytes. vert, vdeg and starts read once (12 cap_v),
// inc_ptr once for each row that holds edges (4 R), the n_live = min(total,
// ne, cap_e) live targets of dst_csr once, and the four int32 fields written
// once (16 cap_e): per graph 12 cap_v + 4 R + 4 n_live + 16 cap_e bytes at
// 3.35 TB/s, ~0.024 ms at the RMAT-G scale-22 slab (cap_v 2^17, cap_e 2^22).
//
// Design: one block of 256 threads for each tile of 2,048 consecutive
// entries of one graph (grid: tiles x B), so a row of any length, a hub of
// 13,000 edges too, spans as many tiles as it needs and costs each only its
// share, and a run of empty rows costs no block more than its rows. Since
// starts is nondecreasing and a row with edges starts where the rows before
// it end, an entry below total = starts[last] + vdeg[last] is owned by the
// row before the first row that starts past it, and every entry from total
// on by the last row with edges. Three warps search starts 32-ary (three to
// five dependent loads; starts is L2-resident): the first row that starts
// at or after the tile, the first at or after its end, and, where the tile
// reaches past total, the last row with edges. The block marks in shared
// memory the start of each row with edges that begins in the tile (such
// starts are distinct) with the row, its vertex and that vertex's inc_ptr;
// an inclusive max-scan over the tile gives each entry the start of its
// row, and entries before the tile's first start belong to the row before
// (which holds edges). Each thread takes 8 consecutive entries for the
// scan, then the tile is written through shared memory in stripes: a warp's
// 32 consecutive entries read consecutive targets of dst_csr (one row's
// edges lie together) and store 128 contiguous bytes of each field. Tiles
// wholly past min(ne, cap_e) only store the pads.
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kExpandThreads = 256;
constexpr int kExpandItems = 8;
constexpr int kExpandTile = kExpandThreads * kExpandItems;
constexpr int kExpandWarps = kExpandThreads / 32;
// one pad word after every 32: thread t's blocked items (8t .. 8t+7) and
// the striped reads both fall in 32 distinct banks
constexpr int kExpandSmem = kExpandTile + kExpandTile / 32;
constexpr unsigned kAllLanes = 0xffffffffu;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// The first r in [0, n) with a[r] >= x, n if none, for a nondecreasing a:
// each step the warp probes 32 evenly spaced entries and keeps the span
// between the last probe below x and the first at or above it. Every lane
// returns the answer.
__device__ int warp_lower_bound(const int* __restrict__ a, int n, int x, int lane) {
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long q = lo + lane * step;
    const bool at_or_above = q >= hi || __ldg(a + q) >= x;
    const unsigned m = __ballot_sync(kAllLanes, at_or_above);
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
  return static_cast<int>(lo);
}

// Inclusive max-scan of the block's items in blocked order (thread t holds
// positions 8t .. 8t+7).
__device__ __forceinline__ void block_max_scan(int (&v)[kExpandItems], int* warp_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 1; k < kExpandItems; ++k) v[k] = max(v[k], v[k - 1]);
  int x = v[kExpandItems - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAllLanes, x, d);
    if (lane >= d) x = max(x, y);
  }
  int before = __shfl_up_sync(kAllLanes, x, 1);
  if (lane == 0) before = -1;
  if (lane == 31) warp_max[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
#pragma unroll
  for (int k = 0; k < kExpandItems; ++k) v[k] = max(v[k], before);
}

// A row as an entry sees it: the row, its global start, its vertex and
// that vertex's inc_ptr.
struct Row {
  int row, start, src, base;
};

__device__ __forceinline__ Row load_row(const int* __restrict__ vert,
                                        const int* __restrict__ starts,
                                        const int* __restrict__ inc_ptr, int r, int V) {
  const int v = __ldg(vert + r);
  return Row{r, __ldg(starts + r), v, __ldg(inc_ptr + min(v, V))};
}

__global__ void __launch_bounds__(kExpandThreads)
    frontier_expand_kernel(const int* __restrict__ vert, long long ld_vert,
                           const int* __restrict__ vdeg, long long ld_vdeg,
                           const int* __restrict__ starts, long long ld_starts,
                           const int* __restrict__ ne, const int* __restrict__ inc_ptr,
                           long long ld_inc, const int* __restrict__ dst_csr, long long ld_dst,
                           int cap_v, int cap_e, int V, int E, int fill,
                           int* __restrict__ owner_out, int* __restrict__ src_out,
                           int* __restrict__ dst_out, int* __restrict__ slot_out) {
  // a_: the local start of the row with edges that begins at each position
  // (-1 elsewhere), then each entry's owner; b_: that row, then the slot;
  // c_: its vertex, then src; d_: the vertex's inc_ptr, then the dst index
  __shared__ int a_[kExpandSmem];
  __shared__ int b_[kExpandSmem];
  __shared__ int c_[kExpandSmem];
  __shared__ int d_[kExpandSmem];
  __shared__ int warp_max[kExpandWarps];
  __shared__ int bounds[3];  // the tile's first row, its end row, the last row with edges
  __shared__ Row carry, last;

  const int b = blockIdx.y;
  vert += b * ld_vert;
  vdeg += b * ld_vdeg;
  starts += b * ld_starts;
  inc_ptr += b * ld_inc;
  dst_csr += b * ld_dst;
  const long long out0 = static_cast<long long>(b) * cap_e;
  owner_out += out0;
  src_out += out0;
  dst_out += out0;
  slot_out += out0;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int e0 = blockIdx.x * kExpandTile;
  const int n = min(kExpandTile, cap_e - e0);
  const int nvalid = min(__ldg(ne + b), cap_e);

  if (e0 >= nvalid) {  // only pads
    for (int j = t; j < n; j += kExpandThreads) {
      owner_out[e0 + j] = cap_v;
      src_out[e0 + j] = V;
      dst_out[e0 + j] = fill;
      slot_out[e0 + j] = 0;
    }
    return;
  }
  const int total =
      cap_v > 0 ? wrap_add(__ldg(starts + cap_v - 1), __ldg(vdeg + cap_v - 1)) : 0;
  const int nlive = min(total, nvalid);  // entries below it lie in a row
  const int e1 = min(e0 + n, nlive);
  if (warp < 2) {
    const int r = e0 < nlive ? warp_lower_bound(starts, cap_v, warp == 0 ? e0 : e1, lane) : 0;
    if (lane == 0) bounds[warp] = r;
  } else if (warp == 2 && e0 + n > nlive) {
    const int r = total > 0 ? warp_lower_bound(starts, cap_v, total, lane) - 1 : 0;
    if (lane == 0) bounds[2] = r;
  }
  for (int i = t; i < kExpandSmem; i += kExpandThreads) a_[i] = -1;
  __syncthreads();
  const int lo = bounds[0], hi = bounds[1];
  for (int r = lo + t; r < hi; r += kExpandThreads) {
    if (__ldg(vdeg + r) > 0) {
      const Row row = load_row(vert, starts, inc_ptr, r, V);
      const int j = row.start - e0, p = padded(j);
      a_[p] = j;
      b_[p] = r;
      c_[p] = row.src;
      d_[p] = row.base;
    }
  }
  if (t == 0 && e0 < nlive && lo > 0) carry = load_row(vert, starts, inc_ptr, lo - 1, V);
  if (t == 32 && e0 + n > nlive)
    last = cap_v > 0 ? load_row(vert, starts, inc_ptr, bounds[2], V)
                     : Row{0, 0, V, __ldg(inc_ptr + V)};
  __syncthreads();

  int s[kExpandItems];
#pragma unroll
  for (int k = 0; k < kExpandItems; ++k) s[k] = a_[padded(t * kExpandItems + k)];
  block_max_scan(s, warp_max);
  int o_owner[kExpandItems], o_slot[kExpandItems], o_src[kExpandItems], o_gidx[kExpandItems];
#pragma unroll
  for (int k = 0; k < kExpandItems; ++k) {
    const int j = t * kExpandItems + k, e = e0 + j;
    Row row;
    if (e >= nvalid) {
      row = Row{cap_v, e, V, 0};  // a pad: owner cap_v, slot 0, src V
    } else if (e >= nlive) {
      row = last;
    } else if (s[k] >= 0) {
      const int p = padded(s[k]);
      row = Row{b_[p], e0 + s[k], c_[p], d_[p]};
    } else {
      row = carry;
    }
    o_owner[k] = row.row;
    o_slot[k] = wrap_sub(e, row.start);
    o_src[k] = row.src;
    o_gidx[k] = wrap_add(row.base, o_slot[k]);
  }
  __syncthreads();  // every lookup of b_, c_ and d_ is done
#pragma unroll
  for (int k = 0; k < kExpandItems; ++k) {
    const int p = padded(t * kExpandItems + k);
    a_[p] = o_owner[k];
    b_[p] = o_slot[k];
    c_[p] = o_src[k];
    d_[p] = o_gidx[k];
  }
  __syncthreads();

  int target[kExpandItems];
#pragma unroll
  for (int k = 0; k < kExpandItems; ++k) {  // every load in flight before the stores
    const int j = k * kExpandThreads + t, e = e0 + j;
    target[k] = fill;
    if (j < n && e < nvalid && E > 0)
      target[k] = __ldg(dst_csr + min(max(d_[padded(j)], 0), E - 1));
  }
#pragma unroll
  for (int k = 0; k < kExpandItems; ++k) {
    const int j = k * kExpandThreads + t;
    if (j < n) {
      const int p = padded(j);
      owner_out[e0 + j] = a_[p];
      slot_out[e0 + j] = b_[p];
      src_out[e0 + j] = c_[p];
      dst_out[e0 + j] = target[k];
    }
  }
}

}  // namespace

cudaError_t frontier_expand_attributes(cudaFuncAttributes* attr, int* threads) {
  *threads = kExpandThreads;
  return cudaFuncGetAttributes(attr, reinterpret_cast<const void*>(frontier_expand_kernel));
}

}  // namespace repro_torch

// vert, vdeg, starts: [B, cap_v] int32 rows (row strides ld_*); ne: [B]
// int32; inc_ptr: [B, V+1] and dst_csr: [B, E] int32 rows; the four outputs
// [B, cap_e] int32, contiguous. starts must be the exclusive sum of vdeg >= 0
// along each row. cap_e = 0 or B = 0 launches nothing.
extern "C" int repro_frontier_expand(const void* vert, long long ld_vert, const void* vdeg,
                                     long long ld_vdeg, const void* starts, long long ld_starts,
                                     const void* ne, const void* inc_ptr, long long ld_inc,
                                     const void* dst_csr, long long ld_dst, int B, int cap_v,
                                     int cap_e, int V, int E, int fill, void* owner, void* src,
                                     void* dst, void* slot, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || cap_e <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((cap_e + kExpandTile - 1LL) / kExpandTile), B);
  frontier_expand_kernel<<<grid, kExpandThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(vert), ld_vert, static_cast<const int*>(vdeg), ld_vdeg,
      static_cast<const int*>(starts), ld_starts, static_cast<const int*>(ne),
      static_cast<const int*>(inc_ptr), ld_inc, static_cast<const int*>(dst_csr), ld_dst, cap_v,
      cap_e, V, E, fill, static_cast<int*>(owner), static_cast<int*>(src),
      static_cast<int*>(dst), static_cast<int*>(slot));
  return static_cast<int>(cudaGetLastError());
}
