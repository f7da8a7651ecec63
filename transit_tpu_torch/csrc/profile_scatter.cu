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
// for the others); one warp reduces it with shuffles, no atomics, so the
// result does not depend on the run.
//
// What bounds them: bytes.  A (layer, group, j) pair is one table read, a
// multiply and an add: 2 operations against 4 bytes of table (the
// output or cotangent row it adds to or reads stays in L2, so it is
// charged once per array, not per pair).  The design is the simple one:
// one warp per (layer, group), its lanes striding the window (most
// windows are a few bins wide, so most lanes idle), the table read at a
// stride of ofactor floats (one sector a pair), and float atomics into
// the output row (their order, and so the sums' last bits, change from
// run to run).  Compacting the live (layer, group) pairs, staging the
// cotangent in shared memory and coalescing the table reads are left to a
// later design.

#include <cuda_runtime.h>

namespace {

constexpr int PS_THREADS = 256;
constexpr int PS_WARPS = PS_THREADS / 32;

struct Window {
  long long pbase, offset, two_psize, minj, maxj;
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
  win.minj = idwn - (psize - subw) / ofactor;
  win.maxj = idwn + (psize + subw) / ofactor;
  if (win.minj < 0) win.minj = 0;
  if (win.maxj > n_coarse - 1) win.maxj = n_coarse - 1;
  return win;
}

__global__ void __launch_bounds__(PS_THREADS) profile_scatter_kernel(
    const float* __restrict__ g_k, const int* __restrict__ g_idop,
    const int* __restrict__ ilor, const int* __restrict__ g_iso,
    const int* __restrict__ g_iown, const int* __restrict__ g_idwn,
    const int* __restrict__ profsize, const int* __restrict__ profbase,
    const float* __restrict__ profflat, float* __restrict__ out,
    unsigned long long* __restrict__ pairs, int nl, int ng, int niso,
    int nlor, int ofactor, int n_coarse) {
  const long long w = (long long)blockIdx.x * PS_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= (long long)nl * ng) return;        // the whole warp leaves
  const float k = g_k[w];
  if (k == 0.0f) return;                      // not kept, or no strength
  const int l = (int)(w / ng), g = (int)(w % ng);
  const Window win = group_window(l, g, w, g_idop, ilor, g_iso, g_iown,
                                  g_idwn, profsize, profbase, niso, nlor,
                                  ofactor, n_coarse);
  float* row = out + (long long)l * n_coarse;
  unsigned int n = 0;
  for (long long j = win.minj + lane; j <= win.maxj; j += 32) {
    const long long f = ofactor * j - win.offset;
    if (f >= 0 && f <= win.two_psize) {
      atomicAdd(row + j, k * profflat[win.pbase + f]);
      ++n;
    }
  }
  if (pairs != nullptr) {
    n = __reduce_add_sync(0xffffffffu, n);
    if (lane == 0 && n) atomicAdd(pairs, (unsigned long long)n);
  }
}

__global__ void __launch_bounds__(PS_THREADS) profile_scatter_bwd_kernel(
    const unsigned char* __restrict__ keep, const int* __restrict__ g_idop,
    const int* __restrict__ ilor, const int* __restrict__ g_iso,
    const int* __restrict__ g_iown, const int* __restrict__ g_idwn,
    const int* __restrict__ profsize, const int* __restrict__ profbase,
    const float* __restrict__ profflat, const float* __restrict__ ct,
    float* __restrict__ grad, int nl, int ng, int niso, int nlor,
    int ofactor, int n_coarse) {
  const long long w = (long long)blockIdx.x * PS_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= (long long)nl * ng) return;
  if (!keep[w]) {
    if (lane == 0) grad[w] = 0.0f;
    return;
  }
  const int l = (int)(w / ng), g = (int)(w % ng);
  const Window win = group_window(l, g, w, g_idop, ilor, g_iso, g_iown,
                                  g_idwn, profsize, profbase, niso, nlor,
                                  ofactor, n_coarse);
  const float* row = ct + (long long)l * n_coarse;
  float s = 0.0f;
  for (long long j = win.minj + lane; j <= win.maxj; j += 32) {
    const long long f = ofactor * j - win.offset;
    if (f >= 0 && f <= win.two_psize) s += profflat[win.pbase + f] * row[j];
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) grad[w] = s;
}

unsigned int warp_blocks(int nl, int ng) {
  return (unsigned int)(((long long)nl * ng + PS_WARPS - 1) / PS_WARPS);
}

}  // namespace

extern "C" int profile_scatter(
    const void* g_k, const void* g_idop, const void* ilor, const void* g_iso,
    const void* g_iown, const void* g_idwn, const void* profsize,
    const void* profbase, const void* profflat, void* out, void* pairs,
    int nl, int ng, int niso, int nlor, int ofactor, int n_coarse,
    void* stream) {
  if (nl <= 0 || ng <= 0 || niso <= 0 || nlor <= 0 || ofactor <= 0 ||
      n_coarse <= 0)
    return (int)cudaErrorInvalidValue;
  profile_scatter_kernel<<<warp_blocks(nl, ng), PS_THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const float*)g_k, (const int*)g_idop, (const int*)ilor,
      (const int*)g_iso, (const int*)g_iown, (const int*)g_idwn,
      (const int*)profsize, (const int*)profbase, (const float*)profflat,
      (float*)out, (unsigned long long*)pairs, nl, ng, niso, nlor, ofactor,
      n_coarse);
  return (int)cudaGetLastError();
}

extern "C" int profile_scatter_backward(
    const void* keep, const void* g_idop, const void* ilor,
    const void* g_iso, const void* g_iown, const void* g_idwn,
    const void* profsize, const void* profbase, const void* profflat,
    const void* ct, void* grad, int nl, int ng, int niso, int nlor,
    int ofactor, int n_coarse, void* stream) {
  if (nl <= 0 || ng <= 0 || niso <= 0 || nlor <= 0 || ofactor <= 0 ||
      n_coarse <= 0)
    return (int)cudaErrorInvalidValue;
  profile_scatter_bwd_kernel<<<warp_blocks(nl, ng), PS_THREADS, 0,
                               (cudaStream_t)stream>>>(
      (const unsigned char*)keep, (const int*)g_idop, (const int*)ilor,
      (const int*)g_iso, (const int*)g_iown, (const int*)g_idwn,
      (const int*)profsize, (const int*)profbase, (const float*)profflat,
      (const float*)ct, (float*)grad, nl, ng, niso, nlor, ofactor, n_coarse);
  return (int)cudaGetLastError();
}
