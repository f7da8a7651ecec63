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


}  // namespace
