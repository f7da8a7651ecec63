// Line extinction on the unbanded tile plan: the Hopper counterpart of the
// Pallas kernel transit_tpu/opacities/pallas_lbl.py:_kernel (launched by
// pallas_extinction).
//
// For each tile of tw coarse bins, layer and bin it sums over the tile's
// lines
//     k * K(x, y) / alphaD,
//     k  = gf e^(-c2 El/T) (1 - e^(-c2 nu/T)) coef0 dens   (0 when the line's
//          k0 < ethresh * kmax, extinction.c:400-427),
//     K  = Humlicek w4 Voigt, x = sqrt(ln2) |nu_bin - nu| / alphaD,
//          y = sqrt(ln2) alphaL / alphaD,
// where |nu_bin - nu| <= nwidth * max(alphaD, alphaL).
//
// What bounds it: FP32 arithmetic.  A Voigt evaluation costs ~10^2 flops
// (a complex rational and one divide; region IV adds exp and cos), against
// 17 bytes per line that are read once per tile and layer block.  The
// design therefore spends nothing on memory tricks and keeps the
// arithmetic lean:
//   * one block per (tile, block of lb layers); a thread owns one
//     (layer, bin) output and accumulates it in f32 registers, with a
//     Kahan compensation term;
//   * the tile's lines are staged through shared memory in chunks of CH;
//     the strength chain and the widths are computed once per
//     (layer, line) into shared memory, not once per bin;
//   * the per-isotope tables are indexed directly (no one-hot product);
//   * the loop stops at the tile's line count, not at lmax, and a line
//     whose strength was dropped or whose wing misses the bin skips the
//     Voigt evaluation — the Pallas kernel evaluates every padded element;
//   * each element takes only its own Voigt region's rational, where the
//     TPU's branch-free form computes all three.
// Ragged layer blocks and the ragged last tile are masked, not padded.
//
// Rounding: the bin wavenumber (wn_i + dwn*(tile*tw) + dwn*bin), x, and the
// strength chain use the _rn intrinsics, which the compiler never contracts
// into FMAs, so they round as the plain PyTorch version's separate ops do.
// Build without --use_fast_math (expf/cosf must stay accurate to ~1 ulp).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CH = 64;            // lines staged per chunk
constexpr int MAX_THREADS = 256;  // lb * tw <= MAX_THREADS
constexpr float SQRTLN2 = 0.83255461115769775635f;
constexpr float SQRTLN2PI = 0.46971863934982566689f;

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

__global__ void __launch_bounds__(MAX_THREADS)
line_tile_kernel(const float* __restrict__ wavn,
                 const float* __restrict__ elow,
                 const float* __restrict__ gf,
                 const int* __restrict__ iso,
                 const unsigned char* __restrict__ mask,
                 const int* __restrict__ tile_nlines,
                 const float* __restrict__ temps,
                 const float* __restrict__ alphal,
                 const float* __restrict__ alphad_f,
                 const float* __restrict__ coef0,
                 const float* __restrict__ densm,
                 const float* __restrict__ kmax,
                 float* __restrict__ out,
                 int nl, int lmax, int niso, int tw, int lb, int n_coarse,
                 float wn_i, float dwn, float ethresh, float nwidth,
                 float neg_expcte) {
  extern __shared__ float smem[];
  float* s_wv = smem;                 // (CH,)   line wavenumber
  float* s_k = s_wv + CH;             // (CH, lb) strength x density
  float* s_inv = s_k + CH * lb;       // (CH, lb) 1 / alphaD
  float* s_y = s_inv + CH * lb;       // (CH, lb) y
  float* s_wing = s_y + CH * lb;      // (CH, lb) wing half-width

  const int tile = blockIdx.x;
  const int l0 = blockIdx.y * lb;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int ll = tid / tw;
  const int b = tid - ll * tw;
  const int layer = l0 + ll;
  const int col = tile * tw + b;
  const bool active = ll < lb && layer < nl && col < n_coarse;
  const float wn = __fadd_rn(__fadd_rn(wn_i, __fmul_rn(dwn, (float)(tile * tw))),
                             __fmul_rn(dwn, (float)b));
  const int n = tile_nlines[tile];
  const size_t row = (size_t)tile * lmax;
  float acc = 0.0f, comp = 0.0f;

  for (int c0 = 0; c0 < n; c0 += CH) {
    const int cn = min(CH, n - c0);
    __syncthreads();                  // the previous chunk is consumed
    for (int e = tid; e < cn * lb; e += nthreads) {
      const int j = e / lb;
      const int lj = e - j * lb;
      const int L = l0 + lj;
      const size_t g = row + c0 + j;
      const float wv = wavn[g];
      if (lj == 0) s_wv[j] = wv;
      float k = 0.0f, inv = 1.0f, y = 0.0f, wing = -1.0f;
      if (L < nl) {
        const float T = temps[L];
        const size_t ti = (size_t)L * niso + iso[g];
        const float aL = alphal[ti];
        const float e1 = expf(__fdiv_rn(__fmul_rn(neg_expcte, elow[g]), T));
        const float e2 = expf(__fdiv_rn(__fmul_rn(neg_expcte, wv), T));
        const float k0 = __fmul_rn(
            __fmul_rn(__fmul_rn(gf[g], e1), __fsub_rn(1.0f, e2)), coef0[ti]);
        if (mask[g] && k0 >= __fmul_rn(ethresh, kmax[L]))
          k = __fmul_rn(k0, densm[ti]);
        const float aD = __fmul_rn(alphad_f[ti], wv);
        inv = __fdiv_rn(1.0f, aD);
        y = __fmul_rn(__fmul_rn(SQRTLN2, aL), inv);
        wing = __fmul_rn(nwidth, fmaxf(aD, aL));
      }
      s_k[e] = k;
      s_inv[e] = inv;
      s_y[e] = y;
      s_wing[e] = wing;
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < cn; ++j) {
        const int e = j * lb + ll;
        const float k = s_k[e];
        const float dist = fabsf(__fsub_rn(wn, s_wv[j]));
        if (k != 0.0f && dist <= s_wing[e]) {
          const float inv = s_inv[e];
          const float x = __fmul_rn(__fmul_rn(SQRTLN2, dist), inv);
          const float prof = __fmul_rn(humlicek_k(x, s_y[e]), inv);
          // Compensated (Kahan) sum: a bin adds up hundreds of lines one
          // by one, where the plain version's reduction is a tree.
          const float term = __fsub_rn(__fmul_rn(prof, k), comp);
          const float t = __fadd_rn(acc, term);
          comp = __fsub_rn(__fsub_rn(t, acc), term);
          acc = t;
        }
      }
    }
  }
  if (active) out[(size_t)layer * n_coarse + col] = acc;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// Pointers are device pointers to contiguous tensors: line tiles
// (ntiles, lmax) wavn/elow/gf f32, iso int32, mask bool; tile_nlines
// (ntiles,) int32; temps and kmax (nl,); the isotope tables
// (nl, niso) f32; out (nl, n_coarse) f32, fully written.
extern "C" int line_tile_extinction(
    const void* wavn, const void* elow, const void* gf, const void* iso,
    const void* mask, const void* tile_nlines, const void* temps,
    const void* alphal, const void* alphad_f, const void* coef0,
    const void* densm, const void* kmax, void* out,
    int nl, int ntiles, int lmax, int niso, int tw, int n_coarse,
    float wn_i, float dwn, float ethresh, float nwidth, float neg_expcte,
    void* stream) {
  if (nl <= 0 || ntiles <= 0 || tw <= 0 || tw > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  int lb = MAX_THREADS / tw;
  if (lb > 32) lb = 32;
  if (lb > nl) lb = nl;
  const dim3 grid(ntiles, (nl + lb - 1) / lb);
  const dim3 block(lb * tw);
  const size_t shmem = sizeof(float) * CH * (1 + 4 * lb);
  line_tile_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
      (const float*)wavn, (const float*)elow, (const float*)gf,
      (const int*)iso, (const unsigned char*)mask, (const int*)tile_nlines,
      (const float*)temps, (const float*)alphal, (const float*)alphad_f,
      (const float*)coef0, (const float*)densm, (const float*)kmax,
      (float*)out, nl, lmax, niso, tw, lb, n_coarse, wn_i, dwn, ethresh,
      nwidth, neg_expcte);
  return (int)cudaGetLastError();
}
