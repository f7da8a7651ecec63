// Device functions shared by the port's kernels (line_tile.cu,
// shell_tile.cu): the Voigt functions of transit_tpu/opacities/voigt.py
// (Humlicek w4, its region II alone, the two-term asymptotic pair) and
// the line-strength chain, each in the plain PyTorch version's order of
// operations where the result depends on it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float SQRTLN2 = 0.83255461115769775635f;
constexpr float SQRTLN2PI = 0.46971863934982566689f;
constexpr float INV_SQRTPI = 0.56418958354775628695f;   // 1/sqrt(pi)
constexpr unsigned FULL = 0xffffffffu;

// K(x, y) = sqrt(ln2/pi) Re w(x + iy), Humlicek (1982) w4, for x >= 0,
// y > 0.  Real-pair arithmetic; region I is folded into region II, and
// region II is in the v = 1/u form (transit_tpu/opacities/voigt.py:116-206).
__device__ __forceinline__ float humlicek_k(float x, float y) {
  const float tr = y, ti = -x;              // t = y - i x
  const float ur = (y - x) * (y + x);       // u = t^2
  const float ui = -2.0f * x * y;
  const float s = fabsf(x) + y;
  float nr, ni, dr, di;
  if (s >= 5.5f) {
    // Region II: w = t (1.410474 v^2 + 0.5641896 v) / (1 + 3 v + 0.75 v^2)
    const float uinv = 1.0f / (ur * ur + ui * ui);
    const float vr = ur * uinv, vi = -ui * uinv;
    const float v2r = vr * vr - vi * vi, v2i = vr * vi + vi * vr;
    const float ar = 1.410474f * v2r + 0.5641896f * vr;
    const float ai = 1.410474f * v2i + 0.5641896f * vi;
    nr = tr * ar - ti * ai;
    ni = tr * ai + ti * ar;
    dr = 1.0f + 3.0f * vr + 0.75f * v2r;
    di = 3.0f * vi + 0.75f * v2i;
  } else if (y < 0.195f * fabsf(x) - 0.176f) {
    // Region IV: w = exp(u) - t P(u) / Q(u)
    const float pc[7] = {36183.31f, -3321.9905f, 1540.787f, -219.0313f,
                         35.76683f, -1.320522f, 0.56419f};
    const float qc[8] = {32066.6f, -24322.84f, 9022.228f, -2186.181f,
                         364.2191f, -61.57037f, 1.841439f, -1.0f};
    float pr = pc[6], pi = 0.0f;
#pragma unroll
    for (int c = 5; c >= 0; --c) {
      const float r = pr * ur - pi * ui;
      pi = pr * ui + pi * ur;
      pr = r + pc[c];
    }
    float qr = qc[7], qi = 0.0f;
#pragma unroll
    for (int c = 6; c >= 0; --c) {
      const float r = qr * ur - qi * ui;
      qi = qr * ui + qi * ur;
      qr = r + qc[c];
    }
    nr = tr * pr - ti * pi;
    ni = tr * pi + ti * pr;
    const float dinv = 1.0f / (qr * qr + qi * qi);
    const float re = (nr * qr + ni * qi) * dinv;
    return SQRTLN2PI * (expf(ur) * cosf(ui) - re);
  } else {
    // Region III: degree-4 / degree-5 rational in t
    const float nc[5] = {16.4955f, 20.20933f, 11.96482f, 3.778987f,
                         0.5642236f};
    const float dc[6] = {16.4955f, 38.82363f, 39.27121f, 21.69274f,
                         6.699398f, 1.0f};
    nr = nc[4]; ni = 0.0f;
#pragma unroll
    for (int c = 3; c >= 0; --c) {
      const float r = nr * tr - ni * ti;
      ni = nr * ti + ni * tr;
      nr = r + nc[c];
    }
    dr = dc[5]; di = 0.0f;
#pragma unroll
    for (int c = 4; c >= 0; --c) {
      const float r = dr * tr - di * ti;
      di = dr * ti + di * tr;
      dr = r + dc[c];
    }
  }
  const float dinv = 1.0f / (dr * dr + di * di);
  return SQRTLN2PI * ((nr * dr + ni * di) * dinv);
}

// k0 = gf e^(-c2 El/T) (1 - e^(-c2 nu/T)) coef0, in the plain version's
// order of operations.
__device__ __forceinline__ float strength(float gf, float el, float wv,
                                          float T, float cf0,
                                          float neg_expcte) {
  const float e1 = expf(__fdiv_rn(__fmul_rn(neg_expcte, el), T));
  const float e2 = expf(__fdiv_rn(__fmul_rn(neg_expcte, wv), T));
  return __fmul_rn(__fmul_rn(__fmul_rn(gf, e1), __fsub_rn(1.0f, e2)), cf0);
}

// Region II of w4 alone (voigt.py:_humlicek_w_r2): the v = 1/u rational
// with |u|^2 floored at 1, valid where |x| + y >= 5.5.
__device__ __forceinline__ float r2_k(float x, float y) {
  const float tr = y, ti = -x;
  const float ur = (y - x) * (y + x);
  const float ui = -2.0f * x * y;
  const float uinv = 1.0f / fmaxf(ur * ur + ui * ui, 1.0f);
  const float vr = ur * uinv, vi = -ui * uinv;
  const float v2r = vr * vr - vi * vi, v2i = 2.0f * vr * vi;
  const float cr = 1.410474f * v2r + 0.5641896f * vr;
  const float ci = 1.410474f * v2i + 0.5641896f * vi;
  const float nr = tr * cr - ti * ci;
  const float ni = tr * ci + ti * cr;
  const float dr = 1.0f + 3.0f * vr + 0.75f * v2r;
  const float di = 3.0f * vi + 0.75f * v2i;
  const float dinv = 1.0f / (dr * dr + di * di);
  return SQRTLN2PI * ((nr * dr + ni * di) * dinv);
}

// Two-term asymptotic pair (voigt.py:_w_asym2): Re w of
// (i/sqrt(pi)) (1/z + 1/(2 z^3)), |z|^2 floored at 1.
__device__ __forceinline__ float asym2_k(float x, float y) {
  const float rinv = 1.0f / fmaxf(x * x + y * y, 1.0f);
  const float ur = x * rinv, ui = -y * rinv;
  const float u2r = ur * ur - ui * ui, u2i = 2.0f * ur * ui;
  const float fi = ui * (1.0f + 0.5f * u2r) + 0.5f * ur * u2i;
  return SQRTLN2PI * (-fi * INV_SQRTPI);
}

// K(x, y) of a plan's wfn_tag: 0 w4, 1 r2, 2 asym2 (voigt.py:WFN_CODE).
template <int WFN>
__device__ __forceinline__ float voigt_k(float x, float y) {
  if (WFN == 1) return r2_k(x, y);
  if (WFN == 2) return asym2_k(x, y);
  return humlicek_k(x, y);
}

// The backward kernels' arithmetic.  The gradient is the Faddeeva
// identity's, w' = -2 z w + 2i/sqrt(pi) (voigt.py:_vkh_bwd), and needs
// Im w beside Re w.  The pair w, its partials and the per-pair terms are
// float32, as fast._block_val_bwd computes them (fast.py:612), from the
// forward's float32 values (x, y, 1/alphaD, rounded as the forward rounds
// them, so the kept lines and the runs of bins are the forward's); the
// sums over pairs and the chain to the cotangents are float64.
// Measured (tests/test_torch_grad_precision_main.py, on hot-Jupiter
// slices): the gradient in T and q with a float32 pair is within 5.3e-7
// of max of the float64 pair's.  The alphaD sum's per-pair term wr + x Kx'
// + y Ky' is O(|z|^-3) from O(|z|) parts, so the alphad_f cotangent itself
// is float32 rounding noise at 2.2e-4 of its max: two float32 pairs that
// round differently would differ by that much.  So the functions below
// take the plain version's (voigt.py) order of operations, each product
// and sum rounded on its own (the _rn intrinsics, which nvcc never
// contracts into FMAs), the divisions correctly rounded and the constants
// rounded from the same doubles: the pair equals the plain VJP's bit for
// bit (but for exp, cos and sin of region IV, within an ulp of the
// CPU's).  humlicek_k, r2_k and asym2_k stay as they are: the forward
// kernels' results are checked bit for bit.
__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }

// (ar + i ai)(br + i bi) as voigt.py's cmul rounds it.
__device__ __forceinline__ void cmul(float ar, float ai, float br, float bi,
                                     float& r, float& i) {
  r = fs(fm(ar, br), fm(ai, bi));
  i = fa(fm(ar, bi), fm(ai, br));
}

constexpr float C_A = (float)1.410474, C_B = (float)0.5641896;
constexpr float TWO_INV_SQRTPI = (float)1.1283791670955126;   // TWOOSQRTPI

// (Re w, Im w) of w4 (voigt.py:_humlicek_w), only the element's own
// region evaluated (the plain version selects among all three).
__device__ __forceinline__ void humlicek_w(float x, float y, float& wr,
                                           float& wi) {
  const float tr = y, ti = -x;
  const float ur = fm(fs(y, x), fa(y, x));
  const float ui = fm(fm(-2.0f, x), y);
  const bool in2 = fa(fabsf(x), y) >= 5.5f;
  const bool in4 = !in2 && y < fs(fm((float)0.195, fabsf(x)), (float)0.176);
  float nr, ni, dr, di;
  if (in2) {
    const float uinv = rcp(fa(fm(ur, ur), fm(ui, ui)));
    const float vr = fm(ur, uinv), vi = fm(-ui, uinv);
    float v2r, v2i;
    cmul(vr, vi, vr, vi, v2r, v2i);
    cmul(tr, ti, fa(fm(C_A, v2r), fm(C_B, vr)),
         fa(fm(C_A, v2i), fm(C_B, vi)), nr, ni);
    dr = fa(fa(1.0f, fm(3.0f, vr)), fm(0.75f, v2r));
    di = fa(fm(3.0f, vi), fm(0.75f, v2i));
  } else if (in4) {
    constexpr float pc[7] = {(float)36183.31, (float)-3321.9905,
                             (float)1540.787, (float)-219.0313,
                             (float)35.76683, (float)-1.320522,
                             (float)0.56419};
    constexpr float qc[8] = {(float)32066.6, (float)-24322.84,
                             (float)9022.228, (float)-2186.181,
                             (float)364.2191, (float)-61.57037,
                             (float)1.841439, -1.0f};
    float pr = pc[6], pi = 0.0f;
#pragma unroll
    for (int c = 5; c >= 0; --c) {
      cmul(pr, pi, ur, ui, pr, pi);
      pr = fa(pr, pc[c]);
    }
    float qr = qc[7], qi = 0.0f;
#pragma unroll
    for (int c = 6; c >= 0; --c) {
      cmul(qr, qi, ur, ui, qr, qi);
      qr = fa(qr, qc[c]);
    }
    cmul(tr, ti, pr, pi, nr, ni);
    dr = qr;
    di = qi;
  } else {
    constexpr float nc[5] = {(float)16.4955, (float)20.20933,
                             (float)11.96482, (float)3.778987,
                             (float)0.5642236};
    constexpr float dc[6] = {(float)16.4955, (float)38.82363,
                             (float)39.27121, (float)21.69274,
                             (float)6.699398, 1.0f};
    nr = nc[4];
    ni = 0.0f;
#pragma unroll
    for (int c = 3; c >= 0; --c) {
      cmul(nr, ni, tr, ti, nr, ni);
      nr = fa(nr, nc[c]);
    }
    dr = dc[5];
    di = 0.0f;
#pragma unroll
    for (int c = 4; c >= 0; --c) {
      cmul(dr, di, tr, ti, dr, di);
      dr = fa(dr, dc[c]);
    }
  }
  const float dinv = rcp(fa(fm(dr, dr), fm(di, di)));
  wr = fm(fa(fm(nr, dr), fm(ni, di)), dinv);
  wi = fm(fs(fm(ni, dr), fm(nr, di)), dinv);
  if (in4) {
    const float eu = expf(ur);
    wr = fs(fm(eu, cosf(ui)), wr);
    wi = fs(fm(eu, sinf(ui)), wi);
  }
}

// Region II alone (voigt.py:_humlicek_w_r2), |u|^2 floored at 1.
__device__ __forceinline__ void r2_w(float x, float y, float& wr,
                                     float& wi) {
  const float tr = y, ti = -x;
  const float ur = fm(fs(y, x), fa(y, x));
  const float ui = fm(fm(-2.0f, x), y);
  const float uinv = rcp(fmaxf(fa(fm(ur, ur), fm(ui, ui)), 1.0f));
  const float vr = fm(ur, uinv), vi = fm(-ui, uinv);
  const float v2r = fs(fm(vr, vr), fm(vi, vi));
  const float v2i = fm(fm(2.0f, vr), vi);
  const float cr = fa(fm(C_A, v2r), fm(C_B, vr));
  const float ci = fa(fm(C_A, v2i), fm(C_B, vi));
  const float nr = fs(fm(tr, cr), fm(ti, ci));
  const float ni = fa(fm(tr, ci), fm(ti, cr));
  const float dr = fa(fa(1.0f, fm(3.0f, vr)), fm(0.75f, v2r));
  const float di = fa(fm(3.0f, vi), fm(0.75f, v2i));
  const float dinv = rcp(fa(fm(dr, dr), fm(di, di)));
  wr = fm(fa(fm(nr, dr), fm(ni, di)), dinv);
  wi = fm(fs(fm(ni, dr), fm(nr, di)), dinv);
}

// The two-term asymptotic pair (voigt.py:_w_asym2), |z|^2 floored at 1.
__device__ __forceinline__ void asym2_w(float x, float y, float& wr,
                                        float& wi) {
  const float rinv = rcp(fmaxf(fa(fm(x, x), fm(y, y)), 1.0f));
  const float ur = fm(x, rinv), ui = fm(-y, rinv);
  const float u2r = fs(fm(ur, ur), fm(ui, ui));
  const float u2i = fm(fm(2.0f, ur), ui);
  const float h = fa(1.0f, fm(0.5f, u2r));
  const float fr = fs(fm(ur, h), fm(fm(0.5f, ui), u2i));
  const float fi = fa(fm(ui, h), fm(fm(0.5f, ur), u2i));
  constexpr float inv_sqrtpi = (float)(0.5 * 1.1283791670955126);
  wr = fm(-fi, inv_sqrtpi);
  wi = fm(fr, inv_sqrtpi);
}

template <int WFN>
__device__ __forceinline__ void voigt_w(float x, float y, float& wr,
                                        float& wi) {
  if (WFN == 1) return r2_w(x, y, wr, wi);
  if (WFN == 2) return asym2_w(x, y, wr, wi);
  humlicek_w(x, y, wr, wi);
}

// A kept line's bin sums (fast._block_val_bwd, fast.py:647-651), the
// cotangent gb at x = min(x_raw, 1e8) added in: s1 += gb wr,
// s2 += gb (wr + x Kx' [x_raw < 1e8] + y Ky'), s3 += gb Ky', with the
// Faddeeva partials Kx' = -2 (x wr - y wi), Ky' = 2 (x wi + y wr) -
// 2/sqrt(pi) (voigt.faddeeva_partials): each term float32 in the plain
// version's order (kernel_lbl.voigt_bin_sums), its sum float64.
template <int WFN>
__device__ __forceinline__ void add_bin_sums(float x_raw, float y, float gb,
                                             double& s1, double& s2,
                                             double& s3) {
  const float x = fminf(x_raw, 1e8f);
  float wr, wi;
  voigt_w<WFN>(x, y, wr, wi);
  const float kxp = fm(-2.0f, fs(fm(x, wr), fm(y, wi)));
  const float kyp = fs(fm(2.0f, fa(fm(x, wi), fm(y, wr))), TWO_INV_SQRTPI);
  const float fr = x_raw < 1e8f ? fm(x, kxp) : 0.0f;
  s1 += (double)fm(gb, wr);
  s2 += (double)fm(gb, fa(fa(wr, fr), fm(y, kyp)));
  s3 += (double)fm(gb, kyp);
}

// A kept line's cotangents from its bin sums (fast.py:651-677): out[0]
// the temperature's, then coef0's, densm's, alphal's and alphad_f's of its
// (layer, isotope) cells.  k = k0 dd wl is the weighted strength, dd the
// density, wl the decimated shell's halo weight (1 for a line tile).
__device__ __forceinline__ void chain_terms(double out[5], double s1,
                                            double s2, double s3,
                                            double inv, double k, double k0,
                                            double dd, double wl, double cf0,
                                            double s, double e1, double e2,
                                            double gf, double el, double wv,
                                            double T, double expcte) {
  constexpr double C = 0.46971863934982566689;        // sqrt(ln2/pi)
  constexpr double CS = C * 0.83255461115769775635;   // x sqrt(ln2)
  const double gk = C * inv * s1;
  const double g_inv = C * k * s2;
  const double gk0 = gk * (dd * wl);
  out[0] = gk0 * cf0 * (expcte / (T * T)) * gf * e1 *
           (el * (1.0 - e2) - wv * e2);
  out[1] = gk0 * s;
  out[2] = gk * k0 * wl;
  out[3] = CS * inv * inv * k * s3;
  out[4] = -g_inv * inv * inv * wv;
}

// Adds NV values v into the block's shared float64 cells red[cell + i *
// step], summed first over the lanes of the warp with the same key (key
// < 0: nothing to add), then one shared atomic per key and cell: the
// lines of a layer all add into the same few cells, which per-lane
// atomics would serialise.  scr: the warp's 32 * NV doubles of scratch.
// Every lane of the warp calls it.
template <int NV>
__device__ __forceinline__ void warp_cells(double* red, double* scr,
                                           int key, int cell, int step,
                                           const double* v) {
  if (!__any_sync(FULL, key >= 0)) return;
  const int lane = threadIdx.x & 31;
  const unsigned grp = __match_any_sync(FULL, key);
#pragma unroll
  for (int i = 0; i < NV; ++i) scr[lane * NV + i] = v[i];
  __syncwarp();
  if (key >= 0 && lane == __ffs(grp) - 1) {
    double t[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) t[i] = 0.0;
    for (unsigned m = grp; m; m &= m - 1) {
      const int l = __ffs(m) - 1;
#pragma unroll
      for (int i = 0; i < NV; ++i) t[i] += scr[l * NV + i];
    }
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (t[i] != 0.0) atomicAdd(red + cell + i * step, t[i]);
  }
  __syncwarp();
}

// A thread's sums of its entries' cotangents when its layer is fixed: the
// temperature's, and per table (coef0, densm, alphal, alphad_f) the first
// NISO_REG isotopes', in the thread's own NACC float64 slots of shared
// memory (slot k at p[k * nt], nt the block's threads: no atomics, no
// registers); a higher isotope's go to the shared cells at once.  flush()
// adds them to the block's cells, summed over the warp's lanes of the
// same layer (warp_cells).
constexpr int NISO_REG = 4;
constexpr int NACC = 1 + 4 * NISO_REG;
struct CellAcc {
  double* p;
  int nt;
  __device__ __forceinline__ CellAcc(double* slots, int nthreads)
      : p(slots + threadIdx.x), nt(nthreads) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) p[k * nt] = 0.0;
  }
  __device__ __forceinline__ void add(const double v[5], int is,
                                      double* row, int niso) {
    p[0] += v[0];
    if (is < NISO_REG) {
#pragma unroll
      for (int k = 0; k < 4; ++k) p[(1 + k * NISO_REG + is) * nt] += v[1 + k];
    } else {
      for (int k = 0; k < 4; ++k) atomicAdd(row + 1 + k * niso + is, v[1 + k]);
    }
  }
  // Every lane of the warp calls it; on: the lane has a layer ll.
  __device__ __forceinline__ void flush(double* red, double* scr, bool on,
                                        int ll, int ncell, int niso) {
    const double t = p[0];
    warp_cells<1>(red, scr, on ? ll : -1, ll * ncell, 0, &t);
#pragma unroll
    for (int i = 0; i < NISO_REG; ++i) {
      double v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = p[(1 + k * NISO_REG + i) * nt];
      warp_cells<4>(red, scr, on && i < niso ? ll * 64 + i : -1,
                    ll * ncell + 1 + i, niso, v);
    }
  }
};

// The strength chain's parts for the backward: e1 = e^(-c2 El/T),
// e2 = e^(-c2 nu/T) and s = gf e1 (1 - e2), rounded as strength() rounds
// them (k0 = s coef0).  The divisions by T are RN(x r) corrected once
// (Markstein, as layer_kmax divides; r = RN(1/T), the thread's layer's):
// the correctly rounded x / T, so the parts equal strength()'s bit for
// bit.
__device__ __forceinline__ void strength_parts(float gf, float el,
                                               float wv, float T, float r,
                                               float neg_expcte, float& e1,
                                               float& e2, float& s) {
  const float x1 = __fmul_rn(neg_expcte, el), x2 = __fmul_rn(neg_expcte, wv);
  const float q1 = __fmul_rn(x1, r), q2 = __fmul_rn(x2, r);
  e1 = expf(__fmaf_rn(__fmaf_rn(-q1, T, x1), r, q1));
  e2 = expf(__fmaf_rn(__fmaf_rn(-q2, T, x2), r, q2));
  s = __fmul_rn(__fmul_rn(gf, e1), __fsub_rn(1.0f, e2));
}

// The block's float64 cells `red` (rows of `ncell` cells, nlay of them)
// into the global sums acc (nl, ncell): one atomic per block and nonzero
// cell; row ll is layer rows[l0 + ll] (rows null: l0 + ll).
__device__ __forceinline__ void flush_cells(const double* red, double* acc,
                                            const int* rows, int l0,
                                            int nlay, int ncell) {
  for (int i = threadIdx.x; i < nlay * ncell; i += blockDim.x) {
    const double v = red[i];
    if (v != 0.0) {
      const int ll = i / ncell;
      const int L = rows ? rows[l0 + ll] : l0 + ll;
      atomicAdd(acc + (size_t)L * ncell + (i - ll * ncell), v);
    }
  }
}

}  // namespace
