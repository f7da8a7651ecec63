// The profile scatter of exact mode: the Hopper counterpart of the
// windowed gather and scatter-add of transit_tpu/opacities/lbl.py:245-271
// (layer_extinction, the reference's computemolext, extinction.c:485-509).
// That code is XLA, not Pallas; JAX runs it per layer under lax.map as a
// dense (groups, window) formulation.
//
// profile_scatter_kernel: for each layer l and co-add group g with
// g_k[l, g] != 0, and each coarse bin j of the group's window,
//     out[l, j] += g_k[l, g] * profflat[pbase + ofactor*j - offset]
// where the fine index ofactor*j - offset lies in [0, 2 psize].  The
// profile (psize, pbase) is the table cell of the group's Doppler index
// g_idop[l, g] and its isotope's Lorentz index ilor[l, iso]; offset =
// iown - psize; the window is [idwn - (psize - subw)/of, idwn + (psize +
// subw)/of] clipped to the grid, subw = iown - idwn*of, with C's
// truncating division (lbl.py:247-256), computed here per (layer, group)
// from the plan's int32 rows rather than read from five (nl, ng) tensors.
//
// profile_scatter_bwd_kernel: the VJP in g_k, grad[l, g] = sum over the
// same bins of profflat[pbase + fidx] * ct[l, j] for a kept group (0
// for the others).  Each sum runs bin after bin from the window's first
// bin with __fmul_rn / __fadd_rn, the order and roundings of
// lbl.profile_scatter_plain_vjp, so the two agree bit for bit.
//
// The design: one thread per (layer, group), and a block per tile of up
// to PS_TILE consecutive groups of one layer.  The host's tile table
// (lbl.scatter_tiles, built once per plan) cuts the groups so that no
// tile crosses an isotope's run: inside a run the groups go by
// wavelength, so a tile's windows cover a short stretch of the row (on
// hj_ref.cfg 102 bins on average, at most 1874 of 19001), which the
// block stages in shared memory.  Each thread computes its window (the
// chain of dependent loads g_idop -> table cell -> psize, pbase), the
// block reduces the lowest and highest bin of its windows to a span
// [lo, hi], and then
//   - forward: the threads add k * table into a shared copy of
//     out[l, lo:hi] with shared atomics, and the block adds each non-zero
//     bin to the output with one global atomic (tiles that neighbour in
//     the row still overlap);
//   - backward: the block loads ct[l, lo:hi] into shared memory,
//     coalesced, and each thread sums its window from there, then writes
//     grad[l, g], coalesced over the tile.
// A span longer than the shared segment (PS_SEG floats, static shared
// memory) takes the same loops on global memory: global atomics in the
// forward, global cotangent reads in the backward.
//
// What bounds them: bytes.  A (layer, group, j) pair is 2 operations
// against one 4-byte table read, but the pairs of a layer share a few
// dozen profiles of ~17.5 KB (2 psize + 1 floats), read at a stride of
// ofactor floats, and the table's distinct elements the launch reaches
// are what it must move; besides, g_k (or keep), the kept groups'
// Doppler indices, the plan's rows and the (nl, n_coarse) output or
// cotangent (chip_smoke.exact_bounds counts them on the run's data;
// PERF.md keeps the times against that bound).  The table stays in L2.
// By ablation (line_tile_ablation.py profile) 54-63% of the time is the
// tiles' fixed work (the rows, the chain of dependent loads to each
// window, the span, the segment), the bins' loop the rest, of which the
// windows wider than 8 bins take 5-9% and the table reads 7-17%.  The
// forward's atomics make the last bits of its sums change from run to
// run.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int PS_TILE = 256;   // groups a tile at most, one thread each
// The row segment's floats (8 KB): on hj_ref.cfg the widest tile spans
// 1874 bins.
constexpr int PS_SEG = 2048;

struct Window {
  long long pbase, offset, two_psize;
  int minj, maxj;              // empty: minj > maxj
};

// The window of (layer l, group g): lbl.py:246-256.
__device__ __forceinline__ Window group_window(
    int l, int g, long long w, const int* __restrict__ g_idop,
    const int* __restrict__ ilor, const int* __restrict__ g_iso,
    const int* __restrict__ g_iown, const int* __restrict__ g_idwn,
    const int* __restrict__ profsize, const int* __restrict__ profbase,
    int niso, int nlor, int ofactor, int n_coarse) {
  const int cell = g_idop[w] * nlor + ilor[(long long)l * niso + g_iso[g]];
  const long long psize = profsize[cell];
  const long long iown = g_iown[g], idwn = g_idwn[g];
  const long long subw = iown - idwn * ofactor;
  Window win;
  win.pbase = profbase[cell];
  win.offset = iown - psize;
  win.two_psize = 2 * psize;
  // C division truncates toward zero, as lbl._trunc_div does:
  long long minj = idwn - (psize - subw) / ofactor;
  long long maxj = idwn + (psize + subw) / ofactor;
  win.minj = (int)(minj < 0 ? 0 : minj);
  win.maxj = (int)(maxj > n_coarse - 1 ? n_coarse - 1 : maxj);
  return win;
}

__device__ __forceinline__ Window no_window() {
  Window win;
  win.pbase = win.offset = win.two_psize = 0;
  win.minj = INT_MAX;
  win.maxj = -1;
  return win;
}

// The tile's span [lo, hi]: the lowest first and highest last bin of
// its threads' windows (lo > hi when none has one).
__device__ __forceinline__ int2 block_span(const Window& win, int* span) {
  const bool live = win.minj <= win.maxj;
  const int a = __reduce_min_sync(0xffffffffu, live ? win.minj : INT_MAX);
  const int z = __reduce_max_sync(0xffffffffu, live ? win.maxj : -1);
  if (threadIdx.x == 0) {
    span[0] = INT_MAX;
    span[1] = -1;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    atomicMin(span, a);
    atomicMax(span + 1, z);
  }
  __syncthreads();
  return make_int2(span[0], span[1]);
}

// row[j - base] += k * profflat[pbase + fidx] over the window's bins j
// whose fine index fidx = ofactor*j - offset lies in [0, 2 psize];
// returns their count.
__device__ __forceinline__ unsigned int window_add(
    const Window& win, const float* __restrict__ profflat, int ofactor,
    float k, float* row, int base) {
  unsigned int n = 0;
  for (int j = win.minj; j <= win.maxj; ++j) {
    const long long f = (long long)ofactor * j - win.offset;
    if (f >= 0 && f <= win.two_psize) {
      atomicAdd(row + (j - base), __fmul_rn(k, profflat[win.pbase + f]));
      ++n;
    }
  }
  return n;
}

// The sum over the same bins of profflat[pbase + fidx] * row[j - base],
// bin after bin from minj, each product and sum rounded on its own:
// lbl.profile_scatter_plain_vjp's order (its masked bins add 0).
__device__ __forceinline__ float window_dot(
    const Window& win, const float* __restrict__ profflat, int ofactor,
    const float* row, int base) {
  float s = 0.0f;
  for (int j = win.minj; j <= win.maxj; ++j) {
    const long long f = (long long)ofactor * j - win.offset;
    if (f >= 0 && f <= win.two_psize)
      s = __fadd_rn(s, __fmul_rn(profflat[win.pbase + f], row[j - base]));
  }
  return s;
}

__global__ void __launch_bounds__(PS_TILE) profile_scatter_kernel(
    const float* __restrict__ g_k, const int* __restrict__ g_idop,
    const int* __restrict__ ilor, const int* __restrict__ g_iso,
    const int* __restrict__ g_iown, const int* __restrict__ g_idwn,
    const int* __restrict__ profsize, const int* __restrict__ profbase,
    const float* __restrict__ profflat, const int* __restrict__ tiles,
    float* __restrict__ out, unsigned long long* __restrict__ pairs, int ng,
    int ntiles, int niso, int nlor, int ofactor, int n_coarse) {
  __shared__ float seg[PS_SEG];
  __shared__ int span[2];
  const int l = (int)(blockIdx.x / ntiles), t = (int)(blockIdx.x % ntiles);
  const int g = tiles[t] + threadIdx.x;
  const long long w = (long long)l * ng + g;
  const float k = g < tiles[t + 1] ? g_k[w] : 0.0f;
  const Window win = k != 0.0f
      ? group_window(l, g, w, g_idop, ilor, g_iso, g_iown, g_idwn, profsize,
                     profbase, niso, nlor, ofactor, n_coarse)
      : no_window();
  const int2 lh = block_span(win, span);
  if (lh.x > lh.y) return;                    // the whole block: no window
  const int lo = lh.x, n = lh.y - lh.x + 1;
  float* row = out + (long long)l * n_coarse;
  unsigned int cnt;
  if (n <= PS_SEG) {
    for (int i = threadIdx.x; i < n; i += PS_TILE) seg[i] = 0.0f;
    __syncthreads();
    cnt = window_add(win, profflat, ofactor, k, seg, lo);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += PS_TILE) {
      const float v = seg[i];
      if (v != 0.0f) atomicAdd(row + lo + i, v);
    }
  } else {                                    // wider than the segment
    cnt = window_add(win, profflat, ofactor, k, row, 0);
  }
  if (pairs != nullptr) {
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if ((threadIdx.x & 31) == 0 && cnt)
      atomicAdd(pairs, (unsigned long long)cnt);
  }
}

__global__ void __launch_bounds__(PS_TILE) profile_scatter_bwd_kernel(
    const unsigned char* __restrict__ keep, const int* __restrict__ g_idop,
    const int* __restrict__ ilor, const int* __restrict__ g_iso,
    const int* __restrict__ g_iown, const int* __restrict__ g_idwn,
    const int* __restrict__ profsize, const int* __restrict__ profbase,
    const float* __restrict__ profflat, const int* __restrict__ tiles,
    const float* __restrict__ ct, float* __restrict__ grad, int ng,
    int ntiles, int niso, int nlor, int ofactor, int n_coarse) {
  __shared__ float seg[PS_SEG];
  __shared__ int span[2];
  const int l = (int)(blockIdx.x / ntiles), t = (int)(blockIdx.x % ntiles);
  const int g = tiles[t] + threadIdx.x;
  const bool mine = g < tiles[t + 1];
  const long long w = (long long)l * ng + g;
  const Window win = mine && keep[w]
      ? group_window(l, g, w, g_idop, ilor, g_iso, g_iown, g_idwn, profsize,
                     profbase, niso, nlor, ofactor, n_coarse)
      : no_window();
  const int2 lh = block_span(win, span);
  const int lo = lh.x, n = lh.y - lh.x + 1;
  const float* row = ct + (long long)l * n_coarse;
  float s;
  if (n > 0 && n <= PS_SEG) {
    for (int i = threadIdx.x; i < n; i += PS_TILE) seg[i] = row[lo + i];
    __syncthreads();
    s = window_dot(win, profflat, ofactor, seg, lo);
  } else {                                    // wider than the segment
    s = window_dot(win, profflat, ofactor, row, 0);
  }
  if (mine) grad[w] = s;
}

int check_args(int nl, int ng, int ntiles, int niso, int nlor, int ofactor,
               int n_coarse) {
  if (nl <= 0 || ng <= 0 || ntiles <= 0 || niso <= 0 || nlor <= 0 ||
      ofactor <= 0 || n_coarse <= 0 || (long long)nl * ntiles > INT_MAX)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// tiles: ntiles + 1 int32 group starts, ascending from 0 to ng, no tile
// longer than PS_TILE (lbl.scatter_tiles; the host checks them,
// lbl.check_tiles).
extern "C" int profile_scatter(
    const void* g_k, const void* g_idop, const void* ilor, const void* g_iso,
    const void* g_iown, const void* g_idwn, const void* profsize,
    const void* profbase, const void* profflat, const void* tiles, void* out,
    void* pairs, int nl, int ng, int ntiles, int niso, int nlor, int ofactor,
    int n_coarse, void* stream) {
  if (int err = check_args(nl, ng, ntiles, niso, nlor, ofactor, n_coarse))
    return err;
  profile_scatter_kernel<<<nl * ntiles, PS_TILE, 0, (cudaStream_t)stream>>>(
      (const float*)g_k, (const int*)g_idop, (const int*)ilor,
      (const int*)g_iso, (const int*)g_iown, (const int*)g_idwn,
      (const int*)profsize, (const int*)profbase, (const float*)profflat,
      (const int*)tiles, (float*)out, (unsigned long long*)pairs, ng, ntiles,
      niso, nlor, ofactor, n_coarse);
  return (int)cudaGetLastError();
}

extern "C" int profile_scatter_backward(
    const void* keep, const void* g_idop, const void* ilor,
    const void* g_iso, const void* g_iown, const void* g_idwn,
    const void* profsize, const void* profbase, const void* profflat,
    const void* tiles, const void* ct, void* grad, int nl, int ng,
    int ntiles, int niso, int nlor, int ofactor, int n_coarse,
    void* stream) {
  if (int err = check_args(nl, ng, ntiles, niso, nlor, ofactor, n_coarse))
    return err;
  profile_scatter_bwd_kernel<<<nl * ntiles, PS_TILE, 0,
                               (cudaStream_t)stream>>>(
      (const unsigned char*)keep, (const int*)g_idop, (const int*)ilor,
      (const int*)g_iso, (const int*)g_iown, (const int*)g_idwn,
      (const int*)profsize, (const int*)profbase, (const float*)profflat,
      (const int*)tiles, (const float*)ct, (float*)grad, ng, ntiles, niso,
      nlor, ofactor, n_coarse);
  return (int)cudaGetLastError();
}
