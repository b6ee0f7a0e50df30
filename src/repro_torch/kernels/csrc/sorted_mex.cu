// sorted_mex: the sort engine's segment-min. Over (vertex, color) pairs
// sorted by vertex, then color, a pair is a gap where the next pair belongs
// to another vertex (or there is none) or skips past color + 1; each vertex
// in [0, V) takes the least color + 1 over its gaps (mex[v], left at
// INT32_MAX where it has none). Pairs of the inert id V, which sort last,
// write nothing.
//
// Replaces no TPU kernel: the reference takes this segment-min with XLA's
// segment_min (src/repro/core/mex.py::segment_mex); the port took it with
// scatter_reduce_ amin, which sent every pair to an atomic, in sorted order:
// the ~17 M inert pairs of a scale-21 R-MAT-B round-0 sweep all hit one word.
//
// Bound on an H100 SXM: bytes. Both int32 inputs read once and the [V]
// result written once (its INT32_MAX fill is the wrapper's): 8M + 4V bytes
// at 3.35 TB/s, 0.088 ms for M = 35.65 M pairs and V = 2^21. Warps whose
// first pair is inert read nothing more, so a sweep whose pairs are half
// inert needs ~8 M_live + 4V (0.048 ms there). The work per pair is a few
// compares, shuffles and ballots.
//
// Design: each warp walks 512 consecutive pairs, 32 at a time, one per
// lane; all 32 of a lane's loads are in flight before the first use (coalesced
// 128-byte lines; measured faster than staging 16-byte loads through shared
// memory: 0.072 against 0.080 ms at the shape above). A pair's successor
// comes from the next lane, the next step's first lane, or one more load
// after the warp's last pair. A warp whose first pair is inert returns at
// once. Runs of one vertex are runs of lanes; since colors ascend within a
// vertex, a run's least candidate is its first gap's, which two ballots
// find. The run that reaches the next 32 pairs is carried into them instead
// of being written, so a warp makes one atomicMin per vertex it saw a gap
// of and none for a vertex without one: a 13,000-pair hub costs at most one
// atomic per warp it spans (~26). Integer mins are exact in any order, so
// the result equals the plain version bit for bit on sorted pairs whose
// colors lie below 2^31 - 1 (color + 1 must not wrap).
#include <climits>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kMexThreads = 256;
constexpr int kMexWarps = kMexThreads / 32;
constexpr int kMexSteps = 16;
constexpr int kMexWarpPairs = 32 * kMexSteps;
constexpr int kNoCandidate = INT_MAX;
constexpr unsigned kAllLanes = 0xffffffffu;

__global__ void __launch_bounds__(kMexThreads)
    sorted_mex_kernel(const int* __restrict__ vertex, const int* __restrict__ color,
                      long long M, int V, int* __restrict__ mex) {
  const int lane = threadIdx.x & 31;
  const long long w0 =
      (static_cast<long long>(blockIdx.x) * kMexWarps + (threadIdx.x >> 5)) * kMexWarpPairs;
  // the inert id sorts last: a warp whose first pair is inert writes nothing
  if (w0 >= M || __ldg(vertex + w0) == V) return;
  const int wn = static_cast<int>(min(static_cast<long long>(kMexWarpPairs), M - w0));
  int vs[kMexSteps], cs[kMexSteps];
#pragma unroll
  for (int s = 0; s < kMexSteps; ++s) {  // every load in flight before the first use
    const int j = s * 32 + lane;
    vs[s] = j < wn ? __ldg(vertex + w0 + j) : V;
    cs[s] = j < wn ? __ldg(color + w0 + j) : 0;
  }
  const bool tail = w0 + wn < M;  // a pair follows the warp's last
  const int tv = tail ? __ldg(vertex + w0 + wn) : V;
  const int tc = tail ? __ldg(color + w0 + wn) : 0;
  bool carried = false;       // lane 0's run began in an earlier step
  int carry = kNoCandidate;   // ... and had this first gap there
#pragma unroll
  for (int s = 0; s < kMexSteps; ++s) {
    if (s * 32 >= wn) break;
    const int j = s * 32 + lane;
    const int v = vs[s], c = cs[s];
    // the successor: the next lane's pair, the next step's first, or the tail
    const int dv = __shfl_down_sync(kAllLanes, v, 1);
    const int dc = __shfl_down_sync(kAllLanes, c, 1);
    const int hv = __shfl_sync(kAllLanes, vs[s + 1 < kMexSteps ? s + 1 : s], 0);
    const int hc = __shfl_sync(kAllLanes, cs[s + 1 < kMexSteps ? s + 1 : s], 0);
    const bool inside = j + 1 < wn;
    const int nv = inside ? (lane < 31 ? dv : hv) : tv;
    const int nc = inside ? (lane < 31 ? dc : hc) : tc;
    const bool real = j < wn, next = real && (inside || tail);
    const int c1 = static_cast<int>(static_cast<unsigned>(c) + 1u);
    const bool gap = !next || nv != v || nc > c1;
    const bool live = real && static_cast<unsigned>(v) < static_cast<unsigned>(V);
    const int cand = (live && gap) ? c1 : kNoCandidate;
    const int pv = __shfl_up_sync(kAllLanes, v, 1);
    const bool first = lane == 0 || pv != v;
    // a run's least candidate is its first gap's: colors ascend within a
    // vertex. The run of lane l: lanes l .. the next run's first - 1.
    const unsigned firsts = __ballot_sync(kAllLanes, first);
    const unsigned gaps = __ballot_sync(kAllLanes, cand != kNoCandidate);
    const unsigned later = lane == 31 ? 0u : firsts & (kAllLanes << (lane + 1));
    const unsigned run = (kAllLanes << lane) & (later ? (later & (0u - later)) - 1u : kAllLanes);
    const unsigned run_gaps = gaps & run;
    const int at = __shfl_sync(kAllLanes, cand, run_gaps ? __ffs(run_gaps) - 1 : lane);
    int m = run_gaps ? at : kNoCandidate;
    if (lane == 0 && carried && carry != kNoCandidate) m = carry;  // an earlier gap
    // the last run goes on into the next step: carry it instead of writing
    const int last_first = 31 - __clz(firsts);
    carried = __shfl_sync(kAllLanes, next && inside && nv == v, 31);
    carry = __shfl_sync(kAllLanes, m, last_first);
    if (first && m != kNoCandidate && !(carried && lane == last_first)) atomicMin(mex + v, m);
  }
}

cudaError_t sorted_mex_attributes(cudaFuncAttributes* attr, int* threads) {
  *threads = kMexThreads;
  return cudaFuncGetAttributes(attr, reinterpret_cast<const void*>(sorted_mex_kernel));
}

}  // namespace repro_torch

// mex: [V] int32, filled with INT32_MAX by the caller. vertex and color
// are sorted by vertex, then color, and may start at any 4-byte address.
extern "C" int repro_sorted_mex(const void* vertex, const void* color, long long M, int V,
                                void* mex, void* stream) {
  using namespace repro_torch;
  if (M <= 0) return static_cast<int>(cudaSuccess);
  const long long per_block = static_cast<long long>(kMexWarps) * kMexWarpPairs;
  const long long blocks = (M + per_block - 1) / per_block;
  sorted_mex_kernel<<<static_cast<unsigned int>(blocks), kMexThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(vertex), static_cast<const int*>(color), M, V,
      static_cast<int*>(mex));
  return static_cast<int>(cudaGetLastError());
}
