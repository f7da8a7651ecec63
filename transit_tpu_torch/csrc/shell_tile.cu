// Decimated far-wing shells of the banded path: the Hopper counterpart of
// transit_tpu/opacities/fast.py:_run_tiles with stride > 1 (or
// far_full_res) on a shell plan with a line weight — _block_primal's
// line-weighted branch (fast.py:554-568), the per-line halo weight
// (_line_halo_weight, :487-513) and the Catmull-Rom upsampling with the
// clip at 0 (_upsample_cr, :447-456, 833-836).  In JAX this is jnp code
// that XLA fuses, not a Pallas kernel.
//
// For each decimated shell of a band (in plan order), tile, layer and
// evaluation point e (the tw/stride + 3 points spaced stride*dwn from one
// stride before the tile; with stride 1 the tw bins), the function sums
// over the shell's lines of the tile
//     k * K(x, y) / alphaD,
//     k  = gf e^(-c2 El/T) (1 - e^(-c2 nu/T)) coef0 (dens * wl)  (0 when
//          the line's k0 < ethresh * kmax),
//     wl = smoothstep of the line's distance from the tile, 1 at 0.875 and
//          0 at 1.125 times the band's halo at the tile,
//     K  = the shell's Voigt function (r2 or asym2), x = sqrt(ln2)
//          |nu_e - nu| / alphaD clamped at 1e8, y = sqrt(ln2) alphaL/alphaD,
// with no per-layer wing cutoff; then upsamples the points to the tile's
// bins (bin g*stride + r from points g..g+3 with the Catmull-Rom weights
// at u = r/stride), clips at 0, and adds the result into the layer rows
// and tile columns of the (nl, n_coarse) output: out = (out + s_1) + s_2
// ..., the order of the plain version.
//
// What bounds it: FP32 arithmetic, and all of it is needed — every kept
// (layer, line) of a tile reaches every evaluation point (a shell holds
// only lines whose wings cover the tile).  The design:
//   * One launch per band for all its decimated shells.  A block takes
//     one (tile, block of layers) entry of a table made once per model
//     (tile, then per shell the offset and count of the tile's lines in a
//     packed line list), heaviest tiles first; it runs the shells in plan
//     order, so the adds into one column never race (the tiles of a band
//     are disjoint and one block owns a tile's columns for all shells).
//   * Per chunk of up to SCH_MAX lines (the whole tile, for most tiles) a
//     set-up pass gives each (layer, line) its weighted strength,
//     1/alphaD, y and wavenumber in one float4 of shared memory.
//   * A thread owns one layer and P consecutive points (P = 2 or 4, so
//     that the layer block's points fill the block), reads each line's
//     float4 once for its P points and keeps P independent Kahan sums:
//     P chains to interleave.  Each point's terms and their order (line
//     order, Kahan compensated) are those of the first design (one item
//     of a thread after another, a launch per tile class), and the sums
//     agree with its to a few ulps.
//   * The sums live in shared memory between chunks and go to the
//     upsampling epilogue from there.
// Rounding as in line_tile.cu: the _rn intrinsics where the plain
// version's separate ops fix the order (points, strength, weight,
// upsampling).

#include "voigt.cuh"

namespace {

constexpr int SNT = 256;            // threads per block
constexpr int S_ENTRIES = 2048;     // staged (layer, line) float4 entries
constexpr int SCH_MAX = 512;        // lines per chunk
constexpr int S_MAX_LB = 32;        // layers per block
constexpr int S_ITEMS = 2048;       // (layer, point) sums per block
constexpr int MAX_SHELLS = 8;
constexpr size_t S_SMEM = S_ENTRIES * sizeof(float4) +
                          2 * S_ITEMS * sizeof(float);

// The decimated shells of one launch, by value: stride (a power of two
// dividing tw) and Voigt function (1 r2, 2 asym2) of each, in plan order.
struct Shells {
  int n;
  int stride[MAX_SHELLS];
  int wfn[MAX_SHELLS];
};

// The evaluation of one chunk: thread tasks (layer ll, points e0..e0+P-1)
// walk the chunk's cn staged lines of their layer and carry the Kahan sums
// of their points in s_acc / s_comp ((lb, ne) each).
template <int WFN, int P>
__device__ __forceinline__ void eval_chunk(
    const float4* __restrict__ ent, float* __restrict__ s_acc,
    float* __restrict__ s_comp, int nlay, int ne, int off, int sch, int cn,
    bool first, float wn_i, float sdwn, float toff) {
  const int G = (ne + P - 1) / P;
  for (int task = threadIdx.x; task < nlay * G; task += SNT) {
    const int ll = task / G;
    const int e0 = (task - ll * G) * P;
    float pos[P], acc[P], comp[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      pos[p] = __fadd_rn(
          __fadd_rn(wn_i, __fmul_rn(sdwn, (float)(e0 + p - off))), toff);
      const bool on = e0 + p < ne;
      acc[p] = first || !on ? 0.0f : s_acc[ll * ne + e0 + p];
      comp[p] = first || !on ? 0.0f : s_comp[ll * ne + e0 + p];
    }
    const float4* row = ent + ll * sch;
    for (int j = 0; j < cn; ++j) {
      const float4 en = row[j];        // k, 1/alphaD, y, wavenumber
      if (en.x == 0.0f) continue;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float dist = fabsf(__fsub_rn(pos[p], en.w));
        const float x =
            fminf(__fmul_rn(__fmul_rn(SQRTLN2, dist), en.y), 1e8f);
        const float term = __fsub_rn(
            __fmul_rn(__fmul_rn(voigt_k<WFN>(x, en.z), en.y), en.x),
            comp[p]);
        const float t = __fadd_rn(acc[p], term);
        comp[p] = __fsub_rn(__fsub_rn(t, acc[p]), term);
        acc[p] = t;
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (e0 + p < ne) {
        s_acc[ll * ne + e0 + p] = acc[p];
        s_comp[ll * ne + e0 + p] = comp[p];
      }
    }
  }
}

__global__ void __launch_bounds__(SNT)
shell_tile_kernel(const float* __restrict__ wavn,
                  const float* __restrict__ elow,
                  const float* __restrict__ gf,
                  const int* __restrict__ iso,
                  const int* __restrict__ blocks,
                  const int* __restrict__ rows,
                  const float* __restrict__ temps,
                  const float* __restrict__ alphal,
                  const float* __restrict__ alphad_f,
                  const float* __restrict__ coef0,
                  const float* __restrict__ densm,
                  const float* __restrict__ kmax,
                  float* __restrict__ out,
                  unsigned long long* __restrict__ stats,
                  const Shells shells, int nrows, int lb, int niso, int tw,
                  int n_coarse, float wn_i, float dwn, float ethresh,
                  float nwidth, float aL_max, float aDf_max, float tw_wn,
                  float neg_expcte) {
  extern __shared__ float4 s_ent[];                    // (lb, sch)
  float* s_acc = reinterpret_cast<float*>(s_ent + S_ENTRIES);  // (lb, ne)
  float* s_comp = s_acc + S_ITEMS;
  __shared__ unsigned long long s_cnt[3];

  const int tid = threadIdx.x;
  const int* blk = blocks + (size_t)blockIdx.x * (1 + 2 * shells.n);
  const int tile = blk[0];
  const int l0 = blockIdx.y * lb;
  const int nlay = min(lb, nrows - l0);
  const int sch = min(SCH_MAX, S_ENTRIES / nlay);
  if (tid < 3) s_cnt[tid] = 0;
  __syncthreads();

  // The tile's edges and the band's halo there (_line_halo_weight).
  const float toff = __fmul_rn(dwn, (float)(tile * tw));
  const float tile_lo = __fadd_rn(wn_i, toff);
  const float tile_hi = __fadd_rn(tile_lo, tw_wn);
  const float halo = __fadd_rn(
      __fmul_rn(nwidth, fmaxf(aL_max, __fmul_rn(aDf_max, tile_hi))), dwn);
  const float h_hi = __fmul_rn(1.125f, halo), h_w = __fmul_rn(0.25f, halo);

  unsigned long long n_chain = 0, n_live = 0, n_eval = 0;
  for (int sh = 0; sh < shells.n; ++sh) {
    const int l_off = blk[1 + 2 * sh], cnt = blk[2 + 2 * sh];
    if (cnt == 0) continue;            // adds nothing to the tile
    const int stride = shells.stride[sh], wfn = shells.wfn[sh];
    const int ne = stride > 1 ? tw / stride + 3 : tw;
    const int off = stride > 1 ? 1 : 0;  // point e sits at bin (e-off)*s
    const float sdwn = __fmul_rn(dwn, (float)stride);   // exact: 2^k
    const bool p4 = nlay * ((ne + 1) / 2) > SNT;
    for (int c0 = 0; c0 < cnt; c0 += sch) {
      const int cn = min(sch, cnt - c0);
      __syncthreads();                 // the previous chunk is consumed
      // Set-up: per (layer, line) the strength k (0: cut or weighted
      // out), 1/alphaD, y and the line's wavenumber.
      for (int e = tid; e < nlay * cn; e += SNT) {
        const int ll = e / cn, j = e - ll * cn;
        const size_t g = (size_t)l_off + c0 + j;
        const float wv = wavn[g];
        const int L = rows ? rows[l0 + ll] : l0 + ll;
        const int ti = L * niso + iso[g];
        float kk = 0.0f, inv = 0.0f, yy = 0.0f;
        const float k0 = strength(gf[g], elow[g], wv, temps[L], coef0[ti],
                                  neg_expcte);
        ++n_chain;
        if (k0 >= __fmul_rn(ethresh, kmax[L])) {
          const float dl = fmaxf(
              fmaxf(__fsub_rn(tile_lo, wv), __fsub_rn(wv, tile_hi)), 0.0f);
          const float v = fminf(
              fmaxf(__fdiv_rn(__fsub_rn(h_hi, dl), h_w), 0.0f), 1.0f);
          const float wl = __fmul_rn(__fmul_rn(v, v),
                                     __fsub_rn(3.0f, __fmul_rn(2.0f, v)));
          kk = __fmul_rn(k0, __fmul_rn(densm[ti], wl));
          inv = __fdiv_rn(1.0f, __fmul_rn(alphad_f[ti], wv));
          yy = __fmul_rn(__fmul_rn(SQRTLN2, alphal[ti]), inv);
          if (kk != 0.0f) {
            ++n_live;
            n_eval += ne;
          }
        }
        s_ent[ll * sch + j] = make_float4(kk, inv, yy, wv);
      }
      __syncthreads();
      const bool first = c0 == 0;
      if (wfn == 1) {
        if (p4)
          eval_chunk<1, 4>(s_ent, s_acc, s_comp, nlay, ne, off, sch, cn,
                           first, wn_i, sdwn, toff);
        else
          eval_chunk<1, 2>(s_ent, s_acc, s_comp, nlay, ne, off, sch, cn,
                           first, wn_i, sdwn, toff);
      } else {
        if (p4)
          eval_chunk<2, 4>(s_ent, s_acc, s_comp, nlay, ne, off, sch, cn,
                           first, wn_i, sdwn, toff);
        else
          eval_chunk<2, 2>(s_ent, s_acc, s_comp, nlay, ne, off, sch, cn,
                           first, wn_i, sdwn, toff);
      }
    }
    __syncthreads();
    // Epilogue: upsample the point sums, clip, add.
    for (int t = tid; t < nlay * tw; t += SNT) {
      const int ll = t / tw, b = t - ll * tw;
      const int col = tile * tw + b;
      if (col >= n_coarse) continue;
      const float* xs = s_acc + ll * ne;
      float v;
      if (stride > 1) {
        const int g = b / stride, r = b - g * stride;
        // Catmull-Rom (Keys a = -1/2) weights at u = r/stride
        // (_cr_weights); exact in float for power-of-two strides up to 64.
        const float u = (float)r / (float)stride;
        const float u2 = u * u, u3 = u2 * u;
        const float w0 = -0.5f * u3 + u2 - 0.5f * u;
        const float w1 = 1.5f * u3 - 2.5f * u2 + 1.0f;
        const float w2 = -1.5f * u3 + 2.0f * u2 + 0.5f * u;
        const float w3 = 0.5f * u3 - 0.5f * u2;
        v = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(xs[g], w0),
                                          __fmul_rn(xs[g + 1], w1)),
                                __fmul_rn(xs[g + 2], w2)),
                      __fmul_rn(xs[g + 3], w3));
        v = fmaxf(v, 0.0f);
      } else {
        v = xs[b];
      }
      const size_t at =
          (size_t)(rows ? rows[l0 + ll] : l0 + ll) * n_coarse + col;
      out[at] = __fadd_rn(out[at], v);
    }
    // The next shell writes s_acc only after its first chunk's barriers,
    // which every thread reaches after this epilogue.
  }
  if (stats) {
    atomicAdd(&s_cnt[0], n_chain);
    atomicAdd(&s_cnt[1], n_live);
    atomicAdd(&s_cnt[2], n_eval);
    __syncthreads();
    if (tid == 0 && s_cnt[0]) {
      atomicAdd(&stats[0], s_cnt[0]);
      atomicAdd(&stats[1], s_cnt[1]);
      atomicAdd(&stats[2], s_cnt[2]);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// Device pointers: the packed line list wavn/elow/gf f32 and iso int32
// (each tile's lines of each shell contiguous, in line order); blocks
// (nblk, 1 + 2 nshell) int32, per block its global tile, then per shell
// the offset and count of the tile's lines in the packed list; rows
// (nrows,) int32, the layers computed (null: 0 .. nrows-1); temps and kmax
// (nl,), the isotope tables (nl, niso) f32; out (nl, n_coarse) f32 gets
// each shell's upsampled, clipped field added to the rows' and tiles'
// block, shell after shell.  spec is a HOST array of nshell (stride, wfn)
// pairs in plan order: stride a power of two dividing tw (1: full
// resolution, no upsampling or clip), wfn 1 r2 or 2 asym2.  aL_max and
// aDf_max are the band's width bounds and tw_wn = tw * dwn (the plans'
// line_weight).  stats, if not null, is (3,) uint64 and gets the
// (layer, tile, line) strength chains, the live ones (k != 0) and their
// (layer, point, line) evaluations added.
extern "C" int shell_tile_extinction(
    const void* wavn, const void* elow, const void* gf, const void* iso,
    const void* blocks, const void* rows, const void* temps,
    const void* alphal, const void* alphad_f, const void* coef0,
    const void* densm, const void* kmax, void* out, void* stats, int nrows,
    int nblk, int nshell, const int* spec, int niso, int tw, int n_coarse,
    float wn_i, float dwn, float ethresh, float nwidth, float aL_max,
    float aDf_max, float tw_wn, float neg_expcte, void* stream) {
  if (nrows <= 0 || nblk <= 0 || nshell <= 0 || nshell > MAX_SHELLS ||
      tw <= 0)
    return (int)cudaErrorInvalidValue;
  Shells sh;
  sh.n = nshell;
  int ne_max = 0;
  for (int i = 0; i < nshell; ++i) {
    const int s = spec[2 * i], w = spec[2 * i + 1];
    if (s <= 0 || (s & (s - 1)) || tw % s || w < 1 || w > 2)
      return (int)cudaErrorInvalidValue;
    sh.stride[i] = s;
    sh.wfn[i] = w;
    const int ne = s > 1 ? tw / s + 3 : tw;
    if (ne > ne_max) ne_max = ne;
  }
  if (ne_max > S_ITEMS) return (int)cudaErrorInvalidValue;
  int lb = S_ITEMS / ne_max;
  if (lb > S_MAX_LB) lb = S_MAX_LB;
  if (lb > nrows) lb = nrows;
  const int nlb = (nrows + lb - 1) / lb;
  lb = (nrows + nlb - 1) / nlb;           // balance the ragged layer block
  cudaError_t err = cudaFuncSetAttribute(
      shell_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S_SMEM);
  if (err != cudaSuccess) return (int)err;
  shell_tile_kernel<<<dim3(nblk, nlb), SNT, S_SMEM, (cudaStream_t)stream>>>(
      (const float*)wavn, (const float*)elow, (const float*)gf,
      (const int*)iso, (const int*)blocks, (const int*)rows,
      (const float*)temps, (const float*)alphal, (const float*)alphad_f,
      (const float*)coef0, (const float*)densm, (const float*)kmax,
      (float*)out, (unsigned long long*)stats, sh, nrows, lb, niso, tw,
      n_coarse, wn_i, dwn, ethresh, nwidth, aL_max, aDf_max, tw_wn,
      neg_expcte);
  return (int)cudaGetLastError();
}
