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
constexpr int SB_G = 4096;          // the backward's staged g: lb * tw
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
                  unsigned char* __restrict__ clip,
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
        if (clip)
          clip[((size_t)sh * nrows + l0 + ll) * n_coarse + col] = v > 0.0f;
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

// Catmull-Rom weight m (0..3) at u = r/stride (_cr_weights), as the
// forward's epilogue computes it.
__device__ __forceinline__ float cr_weight(int m, int r, int stride) {
  const float u = (float)r / (float)stride;
  const float u2 = u * u, u3 = u2 * u;
  if (m == 0) return -0.5f * u3 + u2 - 0.5f * u;
  if (m == 1) return 1.5f * u3 - 2.5f * u2 + 1.0f;
  if (m == 2) return -1.5f * u3 + 2.0f * u2 + 0.5f * u;
  return 0.5f * u3 - 0.5f * u2;
}

// The backward of shell_tile_kernel: fast._block_val_bwd with the halo
// weight wl folded into k (the density's cotangent carries wl,
// fast.py:673) and no wing mask, behind the transpose of the Catmull-Rom
// upsampling and the clip (fast.py:833-836).  A block takes the forward's
// (tile, block of layers) entry; it stages its layers' temperatures,
// thresholds and table rows and the tile's g columns once, and per shell:
//   * the point cotangents gp (lb, ne): each point e gathers W[m, r] g of
//     the bins g*stride + r it fed (g = e - m), where that shell's own
//     upsampled field was > 0 (the forward's clip mask, staged beside g);
//     stride 1: the bins' g itself;
//   * the tile's lines of the shell in chunks staged in shared memory; a
//     thread keeps to one layer (tid % nlay) and takes every ns-th line,
//     so the lanes of a warp read one line for their layers; per (layer,
//     line) its strength, keep test and weight, then, if it is live, its
//     three sums over the ne points (add_bin_sums, float32 pair, float64
//     sums; the shell's Voigt function a template argument) and its chain
//     (chain_terms), summed in the thread's own shared slots (CellAcc):
//     every live element has the same points, so the lanes stay in step;
// then the slots into the block's cells (one shared atomic per warp,
// layer and cell) and one float64 atomic per block and cell into the
// global sums.  What bounds it: the pairs, every live (layer, line) of a
// tile against every point (84.3e6 at 0.05 cm-1).
constexpr int SB_LINES = 512;       // staged lines per chunk

template <int WFN>
__device__ __forceinline__ void shell_point_sums(const float* gp,
                                                 const float* pos, int ne,
                                                 float wv, float inv,
                                                 float y, double& s1,
                                                 double& s2, double& s3) {
  for (int p = 0; p < ne; ++p) {
    const float gb = gp[p];
    if (gb == 0.0f) continue;
    const float x_raw =
        __fmul_rn(__fmul_rn(SQRTLN2, fabsf(__fsub_rn(pos[p], wv))), inv);
    add_bin_sums<WFN>(x_raw, y, gb, s1, s2, s3);
  }
}

__global__ void __launch_bounds__(SNT, 3)
shell_tile_bwd_kernel(const float* __restrict__ wavn,
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
                      const float* __restrict__ g,
                      const unsigned char* __restrict__ clip,
                      double* __restrict__ acc,
                      const Shells shells, int nrows, int lb, int niso,
                      int tw, int ne_max, int n_coarse, float wn_i,
                      float dwn, float ethresh, float nwidth, float aL_max,
                      float aDf_max, float tw_wn, float neg_expcte) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ncell = 1 + 4 * niso;
  float4* s_tab = reinterpret_cast<float4*>(smem);           // (lb, niso)
  float4* s_line = s_tab + lb * niso;                         // SB_LINES
  int* s_iso = reinterpret_cast<int*>(s_line + SB_LINES);     // SB_LINES
  double* s_scr = reinterpret_cast<double*>(s_iso + SB_LINES);  // 8x32x4
  double* s_acc = s_scr + (SNT / 32) * 32 * 4;          // NACC x SNT
  double* s_red = s_acc + NACC * SNT;                        // (lb, ncell)
  float* s_g = reinterpret_cast<float*>(s_red + lb * ncell);  // (lb, tw)
  float* s_gm = s_g + lb * tw;                               // (lb, tw)
  float* s_gp = s_gm + lb * tw;                              // (lb, ne)
  float* s_pos = s_gp + lb * ne_max;                         // ne
  float* s_w = s_pos + ne_max;               // Catmull-Rom weights (4, s)

  const int tid = threadIdx.x;
  const int* blk = blocks + (size_t)blockIdx.x * (1 + 2 * shells.n);
  const int tile = blk[0];
  const int l0 = blockIdx.y * lb;
  const int nlay = min(lb, nrows - l0);
  double* scr = s_scr + (tid >> 5) * 32 * 4;
  for (int i = tid; i < nlay * ncell; i += SNT) s_red[i] = 0.0;
  for (int i = tid; i < nlay * niso; i += SNT) {
    const int ti = (rows ? rows[l0 + i / niso] : l0 + i / niso) * niso +
                   i % niso;
    s_tab[i] = make_float4(alphal[ti], alphad_f[ti], coef0[ti], densm[ti]);
  }
  for (int i = tid; i < nlay * tw; i += SNT) {
    const int ll = i / tw, col = tile * tw + (i - ll * tw);
    s_g[i] = col < n_coarse
                 ? g[(size_t)(rows ? rows[l0 + ll] : l0 + ll) * n_coarse +
                     col]
                 : 0.0f;
  }
  // The thread's layer and lines.
  const int ll = tid % nlay, s0 = tid / nlay;
  const int ns = SNT / nlay + (ll < SNT % nlay ? 1 : 0);
  const int L = rows ? rows[l0 + ll] : l0 + ll;
  const float T = temps[L], thr = __fmul_rn(ethresh, kmax[L]);
  const float rT = __frcp_rn(T);
  const double expcte = -(double)neg_expcte;
  CellAcc cells(s_acc, SNT);

  const float toff = __fmul_rn(dwn, (float)(tile * tw));
  const float tile_lo = __fadd_rn(wn_i, toff);
  const float tile_hi = __fadd_rn(tile_lo, tw_wn);
  const float halo = __fadd_rn(
      __fmul_rn(nwidth, fmaxf(aL_max, __fmul_rn(aDf_max, tile_hi))), dwn);
  const float h_hi = __fmul_rn(1.125f, halo), h_w = __fmul_rn(0.25f, halo);

  for (int sh = 0; sh < shells.n; ++sh) {
    const int l_off = blk[1 + 2 * sh], cnt = blk[2 + 2 * sh];
    if (cnt == 0) continue;
    const int stride = shells.stride[sh], wfn = shells.wfn[sh];
    const int ne = stride > 1 ? tw / stride + 3 : tw;
    const int off = stride > 1 ? 1 : 0;
    const float sdwn = __fmul_rn(dwn, (float)stride);
    __syncthreads();            // g staged; the previous shell is consumed
    // The shell's masked cotangent: g where its upsampled field was > 0.
    if (stride > 1)
      for (int i = tid; i < nlay * tw; i += SNT) {
        const int lq = i / tw, col = tile * tw + (i - lq * tw);
        s_gm[i] = col < n_coarse &&
                          clip[((size_t)sh * nrows + l0 + lq) * n_coarse +
                               col]
                      ? s_g[i]
                      : 0.0f;
      }
    for (int p = tid; p < ne; p += SNT)
      s_pos[p] = __fadd_rn(
          __fadd_rn(wn_i, __fmul_rn(sdwn, (float)(p - off))), toff);
    for (int i = tid; i < 4 * stride; i += SNT)
      s_w[i] = cr_weight(i / stride, i % stride, stride);
    __syncthreads();
    for (int t = tid; t < nlay * ne; t += SNT) {
      const int lq = t / ne, e = t - lq * ne;
      float v = 0.0f;
      if (stride > 1) {
        const int G = tw / stride;
        const float* gm = s_gm + lq * tw;
        for (int m = 0; m < 4; ++m) {
          const int gi = e - m;
          if (gi < 0 || gi >= G) continue;
          for (int r = 0; r < stride; ++r)
            v += s_w[m * stride + r] * gm[gi * stride + r];
        }
      } else {
        v = s_g[lq * tw + e];
      }
      s_gp[lq * ne + e] = v;
    }
    for (int c0 = 0; c0 < cnt; c0 += SB_LINES) {
      const int cn = min(SB_LINES, cnt - c0);
      __syncthreads();          // gp ready; the previous chunk is consumed
      for (int j = tid; j < cn; j += SNT) {
        const size_t gi = (size_t)l_off + c0 + j;
        s_line[j] = make_float4(wavn[gi], elow[gi], gf[gi], 0.0f);
        s_iso[j] = iso[gi];
      }
      __syncthreads();
      for (int j = s0; j < cn; j += ns) {
        const float4 ln = s_line[j];           // wv, El, gf
        const int is = s_iso[j];
        const float4 tb = s_tab[ll * niso + is];
        float e1, e2, sj;
        strength_parts(ln.z, ln.y, ln.x, T, rT, neg_expcte, e1, e2, sj);
        const float k0 = __fmul_rn(sj, tb.z);
        if (!(k0 >= thr)) continue;
        const float dl = fmaxf(
            fmaxf(__fsub_rn(tile_lo, ln.x), __fsub_rn(ln.x, tile_hi)), 0.0f);
        const float u = fminf(
            fmaxf(__fdiv_rn(__fsub_rn(h_hi, dl), h_w), 0.0f), 1.0f);
        const float wl = __fmul_rn(__fmul_rn(u, u),
                                   __fsub_rn(3.0f, __fmul_rn(2.0f, u)));
        if (wl == 0.0f) continue;        // every cotangent carries wl
        const float inv = __fdiv_rn(1.0f, __fmul_rn(tb.y, ln.x));
        const float y = __fmul_rn(__fmul_rn(SQRTLN2, tb.x), inv);
        double s1 = 0.0, s2 = 0.0, s3 = 0.0;
        if (wfn == 1)
          shell_point_sums<1>(s_gp + ll * ne, s_pos, ne, ln.x, inv, y, s1,
                              s2, s3);
        else
          shell_point_sums<2>(s_gp + ll * ne, s_pos, ne, ln.x, inv, y, s1,
                              s2, s3);
        double v[5];
        chain_terms(v, s1, s2, s3, inv,
                    __fmul_rn(k0, __fmul_rn(tb.w, wl)), k0, tb.w, wl, tb.z,
                    sj, e1, e2, ln.z, ln.y, ln.x, T, expcte);
        cells.add(v, is, s_red + ll * ncell, niso);
      }
    }
  }
  cells.flush(s_red, scr, true, ll, ncell, niso);
  __syncthreads();
  flush_cells(s_red, acc, rows, l0, nlay, ncell);
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
// line_weight).  clip, if not null, is (nshell, nrows, n_coarse) uint8 and
// gets, for each decimated shell (stride > 1) and each bin of a tile the
// shell has lines in, whether the upsampled field was > 0 before the clip
// (the backward's mask; rows numbered 0 .. nrows-1 as in `rows`).  stats,
// if not null, is (3,) uint64 and gets the
// (layer, tile, line) strength chains, the live ones (k != 0) and their
// (layer, point, line) evaluations added.
extern "C" int shell_tile_extinction(
    const void* wavn, const void* elow, const void* gf, const void* iso,
    const void* blocks, const void* rows, const void* temps,
    const void* alphal, const void* alphad_f, const void* coef0,
    const void* densm, const void* kmax, void* out, void* clip, void* stats,
    int nrows, int nblk, int nshell, const int* spec, int niso, int tw,
    int n_coarse,
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
      (float*)out, (unsigned char*)clip, (unsigned long long*)stats, sh,
      nrows, lb, niso, tw,
      n_coarse, wn_i, dwn, ethresh, nwidth, aL_max, aDf_max, tw_wn,
      neg_expcte);
  return (int)cudaGetLastError();
}

// The backward of shell_tile_extinction on the same launch (same packed
// lines, blocks, rows, temps, tables, kmax, spec and widths): g
// (nl, n_coarse) f32 is the cotangent of the output, clip the forward's
// (nshell, nrows, n_coarse) uint8 mask (read for shells of stride > 1
// only; may be null when there are none); acc (nl, 1 + 4 niso) f64 gets,
// per layer, the cotangents of temps, then per isotope of coef0, densm,
// alphal and alphad_f added (float64 atomics).  niso <= 64.
extern "C" int shell_tile_backward(
    const void* wavn, const void* elow, const void* gf, const void* iso,
    const void* blocks, const void* rows, const void* temps,
    const void* alphal, const void* alphad_f, const void* coef0,
    const void* densm, const void* kmax, const void* g, const void* clip,
    void* acc, int nrows, int nblk, int nshell, const int* spec, int niso,
    int tw, int n_coarse, float wn_i, float dwn, float ethresh,
    float nwidth, float aL_max, float aDf_max, float tw_wn,
    float neg_expcte, void* stream) {
  if (nrows <= 0 || nblk <= 0 || nshell <= 0 || nshell > MAX_SHELLS ||
      tw <= 0 || niso <= 0 || niso > 64)
    return (int)cudaErrorInvalidValue;
  Shells sh;
  sh.n = nshell;
  int ne_max = 0;
  for (int i = 0; i < nshell; ++i) {
    const int s = spec[2 * i], w = spec[2 * i + 1];
    if (s <= 0 || (s & (s - 1)) || tw % s || w < 1 || w > 2 ||
        (s > 1 && !clip))
      return (int)cudaErrorInvalidValue;
    sh.stride[i] = s;
    sh.wfn[i] = w;
    const int ne = s > 1 ? tw / s + 3 : tw;
    if (ne > ne_max) ne_max = ne;
  }
  if (ne_max > S_ITEMS) return (int)cudaErrorInvalidValue;
  // The forward's layer blocks, at most SB_G / tw layers.
  int lb = S_ITEMS / ne_max;
  if (lb > S_MAX_LB) lb = S_MAX_LB;
  if (lb > SB_G / tw) lb = SB_G / tw > 0 ? SB_G / tw : 1;
  if (lb > nrows) lb = nrows;
  const int nlb = (nrows + lb - 1) / lb;
  lb = (nrows + nlb - 1) / nlb;
  const size_t smem = (size_t)lb * niso * sizeof(float4) +
                      SB_LINES * (sizeof(float4) + sizeof(int)) +
                      (SNT / 32) * 32 * 4 * sizeof(double) +
                      NACC * SNT * sizeof(double) +
                      (size_t)lb * (1 + 4 * niso) * sizeof(double) +
                      (size_t)(2 * lb * tw + lb * ne_max + ne_max + 4 * tw) *
                          sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      shell_tile_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  shell_tile_bwd_kernel<<<dim3(nblk, nlb), SNT, smem,
                          (cudaStream_t)stream>>>(
      (const float*)wavn, (const float*)elow, (const float*)gf,
      (const int*)iso, (const int*)blocks, (const int*)rows,
      (const float*)temps, (const float*)alphal, (const float*)alphad_f,
      (const float*)coef0, (const float*)densm, (const float*)kmax,
      (const float*)g, (const unsigned char*)clip, (double*)acc, sh, nrows,
      lb, niso, tw, ne_max, n_coarse, wn_i, dwn, ethresh, nwidth, aL_max,
      aDf_max, tw_wn, neg_expcte);
  return (int)cudaGetLastError();
}
