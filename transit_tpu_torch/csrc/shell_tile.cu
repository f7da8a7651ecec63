// Decimated far-wing shells of the banded path: the Hopper counterpart of
// transit_tpu/opacities/fast.py:_run_tiles with stride > 1 (or
// far_full_res) on a shell plan with a line weight — _block_primal's
// line-weighted branch (fast.py:554-568), the per-line halo weight
// (_line_halo_weight, :487-513) and the Catmull-Rom upsampling with the
// clip at 0 (_upsample_cr, :447-456, 833-836).  In JAX this is jnp code
// that XLA fuses, not a Pallas kernel.
//
// For each tile of a shell class, layer and evaluation point e (the
// tw/stride + 3 points spaced stride*dwn from one stride before the tile;
// with stride 1 the tw bins), shell_tile_kernel sums over the tile's lines
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
// and tile columns of the (nl, n_coarse) output.
//
// What bounds it: FP32 arithmetic, and all of it is needed — every kept
// (layer, line) of a tile reaches every evaluation point (the shells hold
// only lines whose wings cover the tile).  So the design is dense and
// simple: one block per (tile, block of lb layers); the tile's lines go
// through shared memory in chunks of SCH; per chunk each (layer, line)
// gets its strength, weight, 1/alphaD and y once, then every thread walks
// the chunk's lines for its (layer, point) items (up to S_OWN), skipping
// lines with k = 0, and sums the terms in line order with a Kahan
// compensation; the epilogue upsamples from shared memory.  Rounding as in
// line_tile.cu: the _rn intrinsics where the plain version's separate ops
// fix the order (points, strength, weight, upsampling).

#include "voigt.cuh"

namespace {

constexpr int SNT = 256;          // threads per block
constexpr int SCH = 64;           // lines per chunk
constexpr int S_MAX_LB = 32;      // layers per block
constexpr int S_OWN = 4;          // (layer, point) items per thread
constexpr int S_MAX_ITEMS = S_OWN * SNT;

template <int WFN>
__global__ void __launch_bounds__(SNT)
shell_tile_kernel(const float* __restrict__ wavn,
                  const float* __restrict__ elow,
                  const float* __restrict__ gf,
                  const int* __restrict__ iso,
                  const unsigned char* __restrict__ mask,
                  const int* __restrict__ tiles,
                  const int* __restrict__ rows,
                  const float* __restrict__ temps,
                  const float* __restrict__ alphal,
                  const float* __restrict__ alphad_f,
                  const float* __restrict__ coef0,
                  const float* __restrict__ densm,
                  const float* __restrict__ kmax,
                  float* __restrict__ out,
                  unsigned long long* __restrict__ stats,
                  int nrows, int lmax, int niso, int tw, int stride, int lb,
                  int n_coarse, float wn_i, float dwn, float sdwn,
                  float ethresh, float nwidth, float aL_max, float aDf_max,
                  float tw_wn, float neg_expcte) {
  __shared__ float s_k[S_MAX_LB * SCH], s_inv[S_MAX_LB * SCH],
      s_y[S_MAX_LB * SCH];
  __shared__ float s_wv[SCH], s_el[SCH], s_gf[SCH], s_wl[SCH];
  __shared__ int s_iso[SCH];
  __shared__ float s_dec[S_MAX_ITEMS];      // (lb, ne) point sums
  __shared__ unsigned long long s_cnt[2];

  const int tid = threadIdx.x;
  const int tile = tiles ? tiles[blockIdx.x] : (int)blockIdx.x;
  const int l0 = blockIdx.y * lb;
  const int nlay = min(lb, nrows - l0);
  const int ne = stride > 1 ? tw / stride + 3 : tw;
  const int off = stride > 1 ? 1 : 0;     // point e sits at bin (e-off)*s
  const size_t row = (size_t)blockIdx.x * lmax;
  if (tid < 2) s_cnt[tid] = 0;

  // The tile's edges and the band's halo there (_line_halo_weight).
  const float toff = __fmul_rn(dwn, (float)(tile * tw));
  const float tile_lo = __fadd_rn(wn_i, toff);
  const float tile_hi = __fadd_rn(tile_lo, tw_wn);
  const float halo = __fadd_rn(
      __fmul_rn(nwidth, fmaxf(aL_max, __fmul_rn(aDf_max, tile_hi))), dwn);
  const float h_hi = __fmul_rn(1.125f, halo), h_w = __fmul_rn(0.25f, halo);

  // Items: (layer ll, point e), S_OWN per thread.
  float pos[S_OWN], acc[S_OWN], comp[S_OWN];
  int it_ll[S_OWN];
#pragma unroll
  for (int o = 0; o < S_OWN; ++o) {
    const int i = tid + o * SNT;
    it_ll[o] = i / ne;
    const int e = i - it_ll[o] * ne;
    if (it_ll[o] >= nlay) it_ll[o] = -1;
    pos[o] = __fadd_rn(__fadd_rn(wn_i, __fmul_rn(sdwn, (float)(e - off))),
                       toff);
    acc[o] = comp[o] = 0.0f;
  }

  unsigned long long n_chain = 0, n_live = 0;
  for (int c0 = 0; c0 < lmax; c0 += SCH) {
    const int cn = min(SCH, lmax - c0);
    __syncthreads();                      // the previous chunk is consumed
    if (tid < cn) {
      const size_t g = row + c0 + tid;
      const float wv = wavn[g];
      s_wv[tid] = wv;
      s_el[tid] = elow[g];
      s_gf[tid] = gf[g];
      s_iso[tid] = mask[g] ? iso[g] : -1;
      const float dl = fmaxf(
          fmaxf(__fsub_rn(tile_lo, wv), __fsub_rn(wv, tile_hi)), 0.0f);
      const float v = fminf(
          fmaxf(__fdiv_rn(__fsub_rn(h_hi, dl), h_w), 0.0f), 1.0f);
      s_wl[tid] = __fmul_rn(__fmul_rn(v, v),
                            __fsub_rn(3.0f, __fmul_rn(2.0f, v)));
    }
    __syncthreads();
    // Set-up: per (layer, line) the strength k (0: masked, cut or
    // weighted out), 1/alphaD and y.
    for (int e = tid; e < nlay * SCH; e += SNT) {
      const int ll = e / SCH, j = e - ll * SCH;
      float kk = 0.0f, inv = 0.0f, yy = 0.0f;
      if (j < cn && s_iso[j] >= 0) {
        const int L = rows ? rows[l0 + ll] : l0 + ll;
        const int ti = L * niso + s_iso[j];
        const float wv = s_wv[j];
        const float k0 = strength(s_gf[j], s_el[j], wv, temps[L], coef0[ti],
                                  neg_expcte);
        ++n_chain;
        if (k0 >= __fmul_rn(ethresh, kmax[L])) {
          kk = __fmul_rn(k0, __fmul_rn(densm[ti], s_wl[j]));
          inv = __fdiv_rn(1.0f, __fmul_rn(alphad_f[ti], wv));
          yy = __fmul_rn(__fmul_rn(SQRTLN2, alphal[ti]), inv);
          if (kk != 0.0f) ++n_live;
        }
      }
      s_k[e] = kk;
      s_inv[e] = inv;
      s_y[e] = yy;
    }
    __syncthreads();
    // Evaluation: each item walks the chunk's lines of its layer.
#pragma unroll
    for (int o = 0; o < S_OWN; ++o) {
      if (it_ll[o] < 0) continue;
      const int base = it_ll[o] * SCH;
      for (int j = 0; j < cn; ++j) {
        const float kk = s_k[base + j];
        if (kk == 0.0f) continue;
        const float inv = s_inv[base + j];
        const float dist = fabsf(__fsub_rn(pos[o], s_wv[j]));
        const float x =
            fminf(__fmul_rn(__fmul_rn(SQRTLN2, dist), inv), 1e8f);
        const float term = __fsub_rn(
            __fmul_rn(__fmul_rn(voigt_k<WFN>(x, s_y[base + j]), inv), kk),
            comp[o]);
        const float t = __fadd_rn(acc[o], term);
        comp[o] = __fsub_rn(__fsub_rn(t, acc[o]), term);
        acc[o] = t;
      }
    }
  }
  // Epilogue: point sums to shared memory, then upsample, clip, add.
#pragma unroll
  for (int o = 0; o < S_OWN; ++o)
    if (it_ll[o] >= 0) s_dec[tid + o * SNT] = acc[o];
  if (stats) {
    atomicAdd(&s_cnt[0], n_chain);
    atomicAdd(&s_cnt[1], n_live);
  }
  __syncthreads();
  for (int t = tid; t < nlay * tw; t += SNT) {
    const int ll = t / tw, b = t - ll * tw;
    const int col = tile * tw + b;
    if (col >= n_coarse) continue;
    const float* xs = s_dec + ll * ne;
    float v;
    if (stride > 1) {
      const int g = b / stride, r = b - g * stride;
      // Catmull-Rom (Keys a = -1/2) weights at u = r/stride (_cr_weights);
      // exact in float for power-of-two strides up to 64.
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
  if (stats && tid == 0 && s_cnt[0]) {
    atomicAdd(&stats[0], s_cnt[0]);
    atomicAdd(&stats[1], s_cnt[1]);
    atomicAdd(&stats[2], s_cnt[1] * (unsigned long long)ne);
  }
}

template <int WFN>
int launch_shell(dim3 grid, cudaStream_t stream, const float* wavn,
                 const float* elow, const float* gf, const int* iso,
                 const unsigned char* mask, const int* tiles,
                 const int* rows, const float* temps, const float* alphal,
                 const float* alphad_f, const float* coef0,
                 const float* densm, const float* kmax, float* out,
                 unsigned long long* stats, int nrows, int lmax, int niso,
                 int tw, int stride, int lb, int n_coarse, float wn_i,
                 float dwn, float sdwn, float ethresh, float nwidth,
                 float aL_max, float aDf_max, float tw_wn,
                 float neg_expcte) {
  shell_tile_kernel<WFN><<<grid, SNT, 0, stream>>>(
      wavn, elow, gf, iso, mask, tiles, rows, temps, alphal, alphad_f,
      coef0, densm, kmax, out, stats, nrows, lmax, niso, tw, stride, lb,
      n_coarse, wn_i, dwn, sdwn, ethresh, nwidth, aL_max, aDf_max, tw_wn,
      neg_expcte);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// Pointers as line_tile_extinction's (line_tile.cu); out (nl, n_coarse)
// f32 gets the launch's upsampled, clipped shell field added to the rows'
// and tiles' block.  stride >= 1 divides tw (stride 1: full resolution, no
// upsampling or clip); sdwn = dwn * stride, rounded once; aL_max and
// aDf_max are the band's width bounds and tw_wn = tw * dwn (the plan's
// line_weight).  wfn selects K: 1 r2, 2 asym2 (the planner tags a
// decimated shell with one of the two).  stats, if not null,
// is (3,) uint64 and gets the (layer, tile, line) strength chains, the
// live ones (k != 0) and their (layer, point, line) evaluations added.
extern "C" int shell_tile_extinction(
    const void* wavn, const void* elow, const void* gf, const void* iso,
    const void* mask, const void* tiles, const void* rows,
    const void* temps, const void* alphal, const void* alphad_f,
    const void* coef0, const void* densm, const void* kmax, void* out,
    void* stats, int nrows, int ntiles, int lmax, int niso, int tw,
    int stride, int n_coarse, int wfn, float wn_i, float dwn, float sdwn,
    float ethresh, float nwidth, float aL_max, float aDf_max, float tw_wn,
    float neg_expcte, void* stream) {
  if (nrows <= 0 || ntiles <= 0 || lmax <= 0 || tw <= 0 || stride <= 0 ||
      tw % stride || wfn < 1 || wfn > 2)
    return (int)cudaErrorInvalidValue;
  const int ne = stride > 1 ? tw / stride + 3 : tw;
  if (ne > S_MAX_ITEMS) return (int)cudaErrorInvalidValue;
  int lb = S_MAX_ITEMS / ne;
  if (lb > S_MAX_LB) lb = S_MAX_LB;
  if (lb > nrows) lb = nrows;
  const int nblk = (nrows + lb - 1) / lb;
  lb = (nrows + nblk - 1) / nblk;         // balance the ragged layer block
  const dim3 grid(ntiles, nblk);
  auto go = [&](auto launch) {
    return launch(grid, (cudaStream_t)stream, (const float*)wavn,
                  (const float*)elow, (const float*)gf, (const int*)iso,
                  (const unsigned char*)mask, (const int*)tiles,
                  (const int*)rows, (const float*)temps,
                  (const float*)alphal, (const float*)alphad_f,
                  (const float*)coef0, (const float*)densm,
                  (const float*)kmax, (float*)out,
                  (unsigned long long*)stats, nrows, lmax, niso, tw, stride,
                  lb, n_coarse, wn_i, dwn, sdwn, ethresh, nwidth, aL_max,
                  aDf_max, tw_wn, neg_expcte);
  };
  if (wfn == 1) return go(&launch_shell<1>);
  return go(&launch_shell<2>);
}
