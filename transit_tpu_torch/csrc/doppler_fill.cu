// The Doppler index's forward fill of exact mode: the Hopper counterpart
// of the jnp forward fill at transit_tpu/opacities/lbl.py:227 (XLA, not
// Pallas: a masked arange, a segment-local running max and a gather),
// which is the C code's computemolext, extinction.c:479-483.
//
// For each row (a layer, or a (layer, temperature) cell of the grid
// build) and co-add group g of isotope i = g_iso[g]:
//     aD   = alphad[row, i] * g_wavn[g]
//     cond = keep[row, g] && aD / alphal[row, i] >= 0.1f
//     g_idop[row, g] = nearest(aDop, aD at s)   where s is the last group
//                      at or before g with cond, if s >= g_iso_start[g]
//                    = idop0[row, i]             otherwise
// with nearest() as transit_tpu_torch.numerics.search.nearest_index_torch
// computes it (the lower bound, clamped to [1, n - 1], then a strict <
// on the absolute differences: ties go to the lower index) and the
// float32 arithmetic of lbl.doppler_fill_plain, rounded as it is
// (__fmul_rn, __fdiv_rn, __fsub_rn: nvcc may not contract the product
// into the difference), so the two agree bit for bit.  The source s lies
// in g's isotope run, so its index is recomputed from its own g_wavn with
// the same row's alphad.
//
// What bounds it: bytes.  keep (1 B a (row, group)) read, g_idop (4 B)
// written, and the plan's g_iso, g_wavn and g_iso_start (12 B a group)
// read, each once; on the 4.86M-line hot Jupiter (13 rows of 4.45M
// groups a chunk) ~0.34 GB, ~0.10 ms at 3.35 TB/s.  The per-(row,
// isotope) widths, idop0 and the 60-entry aDop grid are a few KB.
// PERF.md keeps the kernel's times against that bound.
//
// The design.  An isotope run is ~1.1M groups long, and in deep layers,
// where Lorentz widths dominate, cond is false over whole runs, so a
// group's source can lie anywhere before it.  The groups go in segments
// of DF_SEG; three launches:
//   1. doppler_last_kernel writes each (row, segment)'s last cond group
//      (or -1) to a (rows, nseg) int32 scratch.  Each warp reads its
//      segment's last 32 groups, where most rows have one; only a block
//      with a warp that found none stages the rest (below) and tests it.
//   2. doppler_carry_kernel, a block per row, turns the row's scratch in
//      place into its exclusive running max: the last cond group before
//      each segment (group indices grow along a row).
//   3. doppler_fill_kernel writes g_idop.  Each warp walks its segment 32
//      groups at a time: a ballot of cond, the highest set bit at or below
//      each lane gives the lane's source among those 32, a shuffle its
//      index; the carry (the source before them: the segment's last cond
//      so far, else the scratch's entry) serves lanes with none.
// Launches 1 and 3 give a block one segment and up to DF_WARPS of its
// rows, a warp a row, so the block stages the segment's plan rows in
// shared memory once for its rows (13 rows: two blocks of 7 warps), and a
// warp its row of keep; all of a warp's loads before its loop are in
// flight at once, and its loop reads shared memory and writes g_idop,
// 128 B a warp instruction.  No (rows, ng) intermediate besides keep and
// g_idop; the scratch is rows x ng / DF_SEG ints.  Nothing is allocated,
// nothing synchronised: the wrapper (kernel_profile.doppler_fill) makes
// the output and the scratch, and each entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int DF_WARPS = 8;                // most warps (rows) a block
constexpr int DF_CHUNKS = 32;              // 32-group chunks a segment
constexpr int DF_SEG = 32 * DF_CHUNKS;     // groups a segment
constexpr int DF_SCAN = 1024;              // threads of the carry scan
constexpr int DF_PER = 4;                  // scratch entries a scan thread
constexpr int DF_MAX_NDOP = 4096;          // aDop entries (shared memory)
constexpr unsigned FULL = 0xffffffffu;

// The nearest aDop index of v, as nearest_index_torch computes it:
// searchsorted (left: the first a[i] >= v, by its comparator, so a NaN
// gives n), clamp to [1, n - 1] and a strict comparison of the absolute
// differences (ties go to the lower index).
__device__ __forceinline__ int nearest(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(a[mid] >= v)) lo = mid + 1;
    else hi = mid;
  }
  const int h = min(max(lo, 1), n - 1);
  return fabsf(__fsub_rn(a[h], v)) < fabsf(__fsub_rn(a[h - 1], v)) ? h
                                                                     : h - 1;
}

// The recompute test aD / l >= 0.1f, the quotient rounded as PyTorch's
// division rounds it.
__device__ __forceinline__ bool passes(float aD, float l) {
  return __fdiv_rn(aD, l) >= 0.1f;
}

// A warp's row of keep over its segment into shared memory ``kw``, by
// aligned words (the row starts at any byte, and a word that holds one
// of its bytes lies in its allocation), all loads in flight at once;
// returns the row's first byte there.  The caller syncs the warp.
__device__ __forceinline__ const unsigned char* stage_keep(
    const unsigned char* krow, int n, unsigned* kw, int lane) {
  const size_t at = (size_t)krow;
  const int off = (int)(at & 3);
  const unsigned* words = (const unsigned*)(at & ~(size_t)3);
  for (int t = lane; t < (off + n + 3) >> 2; t += 32) kw[t] = words[t];
  return (const unsigned char*)kw + off;
}

// Launches 1 and 3: a block per segment and blockDim.x / 32 of its rows,
// a warp a row (blockIdx.x = segment * row blocks + row block); the
// warp's row, its segment, the segment's first group and length.
__device__ __forceinline__ void block_cell(int rows, int ng, int& row,
                                           int& seg, int& g0, int& n) {
  const int per = blockDim.x >> 5;
  const int nrb = (rows + per - 1) / per;
  seg = blockIdx.x / nrb;
  row = (blockIdx.x % nrb) * per + (threadIdx.x >> 5);
  g0 = seg * DF_SEG;
  n = min(DF_SEG, ng - g0);
}

// Launch 1.  Each warp checks its segment's last 32 groups (in most rows
// one of them recomputes).  If a warp of the block found none, the block
// stages the segment's plan rows, and each such warp its row of keep,
// and walks back a chunk at a time to the first chunk that holds a cond.
__global__ void __launch_bounds__(DF_WARPS * 32) doppler_last_kernel(
    const unsigned char* __restrict__ keep, const float* __restrict__ alphad,
    const float* __restrict__ alphal, const int* __restrict__ g_iso,
    const float* __restrict__ g_wavn, int* __restrict__ last, int rows,
    int ng, int nseg, int niso) {
  __shared__ int s_iso[DF_SEG];
  __shared__ float s_wavn[DF_SEG];
  __shared__ unsigned s_keep[DF_WARPS][DF_SEG / 4 + 2];
  int row, seg, g0, n;
  block_cell(rows, ng, row, seg, g0, n);
  const bool live = row < rows;
  const int lane = threadIdx.x & 31;
  const unsigned char* kg = keep + (size_t)row * ng + g0;
  const float* ad = alphad + (size_t)row * niso;
  const float* al = alphal + (size_t)row * niso;
  int c = (n - 1) >> 5;
  unsigned b = 0;
  if (live) {
    const int j = (c << 5) + lane;
    bool cd = false;
    if (j < n && kg[j]) {
      const int i = g_iso[g0 + j];
      cd = passes(__fmul_rn(ad[i], g_wavn[g0 + j]), al[i]);
    }
    b = __ballot_sync(FULL, cd);
  }
  const bool walk = live && !b && c > 0;
  if (__syncthreads_or(walk)) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      s_iso[j] = g_iso[g0 + j];
      s_wavn[j] = g_wavn[g0 + j];
    }
    const unsigned char* krow =
        walk ? stage_keep(kg, n, s_keep[threadIdx.x >> 5], lane) : nullptr;
    __syncthreads();
    if (walk) {
      for (--c; c >= 0; --c) {
        const int j = (c << 5) + lane;
        bool cd = false;
        if (krow[j]) {
          const int i = s_iso[j];
          cd = passes(__fmul_rn(ad[i], s_wavn[j]), al[i]);
        }
        b = __ballot_sync(FULL, cd);
        if (b) break;
      }
    }
  }
  if (live && lane == 0)
    last[(size_t)row * nseg + seg] = b ? g0 + (c << 5) + 31 - __clz(b) : -1;
}

// A block's exclusive running max of v over its threads, in thread
// order (-1 before the first); ``total`` gets the block's max.  Uses 32
// ints of shared memory.
__device__ __forceinline__ int block_exclusive_max(int v, int* warp_max,
                                                   int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl = max(incl, u);
  }
  int ex = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) ex = -1;
  if (lane == 31) warp_max[warp] = incl;
  __syncthreads();
  int before = -1;
  total = -1;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
    if (k < warp) before = max(before, warp_max[k]);
    total = max(total, warp_max[k]);
  }
  __syncthreads();              // warp_max is reused by the next call
  return max(before, ex);
}

// Launch 2: a block per row; the row's scratch in place becomes its
// exclusive running max.
__global__ void __launch_bounds__(DF_SCAN) doppler_carry_kernel(
    int* __restrict__ last, int nseg) {
  __shared__ int warp_max[32];
  int* r = last + (size_t)blockIdx.x * nseg;
  int running = -1;
  for (int base = 0; base < nseg; base += DF_SCAN * DF_PER) {
    const int first = base + threadIdx.x * DF_PER;
    int v[DF_PER], mine = -1;
#pragma unroll
    for (int k = 0; k < DF_PER; ++k) {
      v[k] = first + k < nseg ? r[first + k] : -1;
      mine = max(mine, v[k]);
    }
    int total;
    int ex = max(running, block_exclusive_max(mine, warp_max, total));
#pragma unroll
    for (int k = 0; k < DF_PER; ++k) {
      if (first + k < nseg) r[first + k] = ex;
      ex = max(ex, v[k]);
    }
    running = max(running, total);
  }
}

// Launch 3, in the geometry of launch 1.  The block stages the segment's
// plan rows and aDop, each warp its row of keep, and each lane keeps the
// widths and initial index of its group's isotope.  A source is valid at
// or after the group's run start.
__global__ void __launch_bounds__(DF_WARPS * 32) doppler_fill_kernel(
    const unsigned char* __restrict__ keep, const float* __restrict__ alphad,
    const float* __restrict__ alphal, const long long* __restrict__ idop0,
    const int* __restrict__ g_iso, const float* __restrict__ g_wavn,
    const int* __restrict__ g_iso_start, const float* __restrict__ aDop,
    const int* __restrict__ carry, int* __restrict__ out, int rows, int ng,
    int nseg, int niso, int ndop) {
  __shared__ int s_iso[DF_SEG], s_start[DF_SEG];
  __shared__ float s_wavn[DF_SEG];
  __shared__ unsigned s_keep[DF_WARPS][DF_SEG / 4 + 2];
  extern __shared__ float adop[];
  int row, seg, g0, n;
  block_cell(rows, ng, row, seg, g0, n);
  const int lane = threadIdx.x & 31;
  const bool live = row < rows;
  // Everything the warp reads from device memory before its loop goes out
  // at once: its row's carry and the carry's plan entries, its keep, the
  // widths of its first isotope, the block's plan rows and aDop.
  int src = -1, src_iso = 0, iso = 0;
  float src_wavn = 0.0f, wd = 0.0f, wl = 0.0f;
  long long first = 0;
  const unsigned char* krow = nullptr;
  const float* ad = alphad + (size_t)row * niso;
  const float* al = alphal + (size_t)row * niso;
  const long long* i0 = idop0 + (size_t)row * niso;
  if (live) {
    src = carry[(size_t)row * nseg + seg];
    if (src >= 0) {
      src_iso = g_iso[src];
      src_wavn = g_wavn[src];
    }
    krow = stage_keep(keep + (size_t)row * ng + g0, n,
                      s_keep[threadIdx.x >> 5], lane);
    iso = g_iso[g0 + min(lane, n - 1)];
    wd = ad[iso];
    wl = al[iso];
    first = i0[iso];
  }
  for (int k = threadIdx.x; k < ndop; k += blockDim.x) adop[k] = aDop[k];
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    s_iso[j] = g_iso[g0 + j];
    s_start[j] = g_iso_start[g0 + j];
    s_wavn[j] = g_wavn[g0 + j];
  }
  __syncthreads();
  if (!live) return;
  int* orow = out + (size_t)row * ng + g0;
  // The source before the segment and its index (uniform over the warp).
  int cval =
      src >= 0 ? nearest(adop, ndop, __fmul_rn(ad[src_iso], src_wavn)) : 0;
  const unsigned below = lane == 31 ? FULL : (2u << lane) - 1u;
  for (int c = 0; c < n; c += 32) {
    const int j = c + lane;
    const int jj = min(j, n - 1);
    const int gi = s_iso[jj];
    if (gi != iso) {
      iso = gi;
      wd = ad[gi];
      wl = al[gi];
      first = i0[gi];
    }
    const float aD = __fmul_rn(wd, s_wavn[jj]);
    const bool cd = j < n && krow[jj] && passes(aD, wl);
    const unsigned b = __ballot_sync(FULL, cd);
    int s = src, v = cval;
    if (b) {
      const int mine = cd ? nearest(adop, ndop, aD) : 0;
      const unsigned m = b & below;
      const int from = m ? 31 - __clz(m) : 0;
      const int got = __shfl_sync(FULL, mine, from);
      if (m) {
        s = g0 + c + from;
        v = got;
      }
      const int top = 31 - __clz(b);
      src = g0 + c + top;
      cval = __shfl_sync(FULL, mine, top);
    }
    if (j < n) orow[j] = s >= s_start[jj] ? v : (int)first;
  }
}

int check_sizes(int rows, int ng, int nseg, int niso) {
  if (rows <= 0 || ng <= 0 || niso <= 0 ||
      nseg != (ng + DF_SEG - 1) / DF_SEG)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The fill's geometry: a block per segment and up to DF_WARPS of its rows;
// the blocks of a segment share its rows evenly (13 rows: two blocks of 7
// warps).
dim3 row_blocks(int rows, int nseg, int& per) {
  const int nrb = (rows + DF_WARPS - 1) / DF_WARPS;
  per = (rows + nrb - 1) / nrb;
  return dim3((unsigned)nseg * nrb);
}

}  // namespace

// The three launches of one fill, in this order on one stream; ``last``
// is the (rows, nseg) int32 scratch, nseg = ceil(ng / DF_SEG)
// (kernel_profile.DOPPLER_SEGMENT).
extern "C" int doppler_last(const void* keep, const void* alphad,
                            const void* alphal, const void* g_iso,
                            const void* g_wavn, void* last, int rows, int ng,
                            int nseg, int niso, void* stream) {
  if (int err = check_sizes(rows, ng, nseg, niso)) return err;
  int per;
  const dim3 grid = row_blocks(rows, nseg, per);
  doppler_last_kernel<<<grid, per * 32, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)keep, (const float*)alphad,
      (const float*)alphal, (const int*)g_iso, (const float*)g_wavn,
      (int*)last, rows, ng, nseg, niso);
  return (int)cudaGetLastError();
}

extern "C" int doppler_carry(void* last, int rows, int nseg, void* stream) {
  if (rows <= 0 || nseg <= 0) return (int)cudaErrorInvalidValue;
  doppler_carry_kernel<<<rows, DF_SCAN, 0, (cudaStream_t)stream>>>(
      (int*)last, nseg);
  return (int)cudaGetLastError();
}

extern "C" int doppler_fill(const void* keep, const void* alphad,
                            const void* alphal, const void* idop0,
                            const void* g_iso, const void* g_wavn,
                            const void* g_iso_start, const void* aDop,
                            const void* carry, void* out, int rows, int ng,
                            int nseg, int niso, int ndop, void* stream) {
  if (int err = check_sizes(rows, ng, nseg, niso)) return err;
  if (ndop < 2 || ndop > DF_MAX_NDOP) return (int)cudaErrorInvalidValue;
  int per;
  const dim3 grid = row_blocks(rows, nseg, per);
  doppler_fill_kernel<<<grid, per * 32, ndop * sizeof(float),
                        (cudaStream_t)stream>>>(
      (const unsigned char*)keep, (const float*)alphad,
      (const float*)alphal, (const long long*)idop0, (const int*)g_iso,
      (const float*)g_wavn, (const int*)g_iso_start, (const float*)aDop,
      (const int*)carry, (int*)out, rows, ng, nseg, niso, ndop);
  return (int)cudaGetLastError();
}
