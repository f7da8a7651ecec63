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
// Im w beside Re w.  It runs in float64 from the forward's float32 values
// (x, y, 1/alphaD, the strength chain's parts, all rounded as the forward
// rounds them, so the kept lines and the runs of bins are the forward's):
// the cotangents of alphaL and alphaD are sums that cancel (the profile's
// area does not depend on either width) of terms that cancel (far from the
// line w + z w' is O(|z|^-3) from O(|z|) parts), so in float32 they would
// be rounding noise.  The plain version (kernel_lbl.voigt_bin_sums,
// chain_vjp) does the same.  H100's FP64 rate is half its FP32 rate.
//
// (Re w, Im w) of w4 (the regions of humlicek_k, which stays as it is:
// the forward kernels' results are checked bit for bit), of its region II
// alone (r2_k) and of the two-term asymptotic pair (asym2_k), in float64.
__device__ __forceinline__ void humlicek_w(double x, double y, double& wr,
                                           double& wi) {
  const double tr = y, ti = -x;
  const double ur = (y - x) * (y + x);
  const double ui = -2.0 * x * y;
  const double s = fabs(x) + y;
  double nr, ni, dr, di;
  if (s >= 5.5) {
    const double uinv = 1.0 / (ur * ur + ui * ui);
    const double vr = ur * uinv, vi = -ui * uinv;
    const double v2r = vr * vr - vi * vi, v2i = 2.0 * vr * vi;
    const double ar = 1.410474 * v2r + 0.5641896 * vr;
    const double ai = 1.410474 * v2i + 0.5641896 * vi;
    nr = tr * ar - ti * ai;
    ni = tr * ai + ti * ar;
    dr = 1.0 + 3.0 * vr + 0.75 * v2r;
    di = 3.0 * vi + 0.75 * v2i;
  } else if (y < 0.195 * fabs(x) - 0.176) {
    const double pc[7] = {36183.31, -3321.9905, 1540.787, -219.0313,
                          35.76683, -1.320522, 0.56419};
    const double qc[8] = {32066.6, -24322.84, 9022.228, -2186.181,
                          364.2191, -61.57037, 1.841439, -1.0};
    double pr = pc[6], pi = 0.0;
#pragma unroll
    for (int c = 5; c >= 0; --c) {
      const double r = pr * ur - pi * ui;
      pi = pr * ui + pi * ur;
      pr = r + pc[c];
    }
    double qr = qc[7], qi = 0.0;
#pragma unroll
    for (int c = 6; c >= 0; --c) {
      const double r = qr * ur - qi * ui;
      qi = qr * ui + qi * ur;
      qr = r + qc[c];
    }
    nr = tr * pr - ti * pi;
    ni = tr * pi + ti * pr;
    const double dinv = 1.0 / (qr * qr + qi * qi);
    double sn, cs;
    sincos(ui, &sn, &cs);
    const double eu = exp(ur);
    wr = eu * cs - (nr * qr + ni * qi) * dinv;
    wi = eu * sn - (ni * qr - nr * qi) * dinv;
    return;
  } else {
    const double nc[5] = {16.4955, 20.20933, 11.96482, 3.778987, 0.5642236};
    const double dc[6] = {16.4955, 38.82363, 39.27121, 21.69274, 6.699398,
                          1.0};
    nr = nc[4]; ni = 0.0;
#pragma unroll
    for (int c = 3; c >= 0; --c) {
      const double r = nr * tr - ni * ti;
      ni = nr * ti + ni * tr;
      nr = r + nc[c];
    }
    dr = dc[5]; di = 0.0;
#pragma unroll
    for (int c = 4; c >= 0; --c) {
      const double r = dr * tr - di * ti;
      di = dr * ti + di * tr;
      dr = r + dc[c];
    }
  }
  const double dinv = 1.0 / (dr * dr + di * di);
  wr = (nr * dr + ni * di) * dinv;
  wi = (ni * dr - nr * di) * dinv;
}

__device__ __forceinline__ void r2_w(double x, double y, double& wr,
                                     double& wi) {
  const double tr = y, ti = -x;
  const double ur = (y - x) * (y + x);
  const double ui = -2.0 * x * y;
  const double uinv = 1.0 / fmax(ur * ur + ui * ui, 1.0);
  const double vr = ur * uinv, vi = -ui * uinv;
  const double v2r = vr * vr - vi * vi, v2i = 2.0 * vr * vi;
  const double cr = 1.410474 * v2r + 0.5641896 * vr;
  const double ci = 1.410474 * v2i + 0.5641896 * vi;
  const double nr = tr * cr - ti * ci;
  const double ni = tr * ci + ti * cr;
  const double dr = 1.0 + 3.0 * vr + 0.75 * v2r;
  const double di = 3.0 * vi + 0.75 * v2i;
  const double dinv = 1.0 / (dr * dr + di * di);
  wr = (nr * dr + ni * di) * dinv;
  wi = (ni * dr - nr * di) * dinv;
}

__device__ __forceinline__ void asym2_w(double x, double y, double& wr,
                                        double& wi) {
  const double rinv = 1.0 / fmax(x * x + y * y, 1.0);
  const double ur = x * rinv, ui = -y * rinv;
  const double u2r = ur * ur - ui * ui, u2i = 2.0 * ur * ui;
  const double fr = ur * (1.0 + 0.5 * u2r) - 0.5 * ui * u2i;
  const double fi = ui * (1.0 + 0.5 * u2r) + 0.5 * ur * u2i;
  constexpr double inv_sqrtpi = 0.56418958354775628695;
  wr = -fi * inv_sqrtpi;
  wi = fr * inv_sqrtpi;
}

template <int WFN>
__device__ __forceinline__ void voigt_w(double x, double y, double& wr,
                                        double& wi) {
  if (WFN == 1) return r2_w(x, y, wr, wi);
  if (WFN == 2) return asym2_w(x, y, wr, wi);
  humlicek_w(x, y, wr, wi);
}

// The strength chain's parts for the backward: e1 = e^(-c2 El/T),
// e2 = e^(-c2 nu/T) and s = gf e1 (1 - e2), rounded as strength() rounds
// them (k0 = s coef0).
__device__ __forceinline__ void strength_parts(float gf, float el, float wv,
                                               float T, float neg_expcte,
                                               float& e1, float& e2,
                                               float& s) {
  e1 = expf(__fdiv_rn(__fmul_rn(neg_expcte, el), T));
  e2 = expf(__fdiv_rn(__fmul_rn(neg_expcte, wv), T));
  s = __fmul_rn(__fmul_rn(gf, e1), __fsub_rn(1.0f, e2));
}

// A kept line's bin sums (fast._block_val_bwd, fast.py:647-651), the
// cotangent gb at x = min(x_raw, 1e8) added in: s1 += gb wr,
// s2 += gb (wr + x Kx' [x_raw < 1e8] + y Ky'), s3 += gb Ky', with the
// Faddeeva partials Kx' = -2 (x wr - y wi), Ky' = 2 (x wi + y wr) -
// 2/sqrt(pi).
template <int WFN>
__device__ __forceinline__ void add_bin_sums(float x_raw, float y, float gb,
                                             double& s1, double& s2,
                                             double& s3) {
  constexpr double two_inv_sqrtpi = 1.12837916709551257389;
  const double x = fminf(x_raw, 1e8f), yd = y, g = gb;
  double wr, wi;
  voigt_w<WFN>(x, yd, wr, wi);
  const double kxp = -2.0 * (x * wr - yd * wi);
  const double kyp = 2.0 * (x * wi + yd * wr) - two_inv_sqrtpi;
  s1 += g * wr;
  s2 += g * (wr + (x_raw < 1e8f ? x * kxp : 0.0) + yd * kyp);
  s3 += g * kyp;
}

// Chains a kept line's bin sums to its cotangents (fast.py:651-677) and
// adds them to the block's float64 cells of its layer, `red` = (1 + 4 niso)
// cells: [0] the temperature, then per isotope coef0, densm, alphal,
// alphad_f.  k = k0 dd wl is the weighted strength, dd the density, wl the
// decimated shell's halo weight (1 for a line tile).
__device__ __forceinline__ void chain_add(double* red, int niso, int is,
                                          double s1, double s2, double s3,
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
  atomicAdd(red, gk0 * cf0 * (expcte / (T * T)) * gf * e1 *
                     (el * (1.0 - e2) - wv * e2));
  atomicAdd(red + 1 + is, gk0 * s);
  atomicAdd(red + 1 + niso + is, gk * k0 * wl);
  atomicAdd(red + 1 + 2 * niso + is, CS * inv * inv * k * s3);
  atomicAdd(red + 1 + 3 * niso + is, -g_inv * inv * inv * wv);
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
