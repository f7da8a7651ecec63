// Host-side line-list preprocessing of the port: three loops that are
// interpreter-bound in Python at ExoMol scale (1e6..1e9 lines).
//
//  * group_partition: the sequential co-add group partition of exact
//    mode (the scalar loop of the reference's computemolext pass 2,
//    transit/src/extinction.c:430-462), one pass over the sorted list.
//  * argsort_iso_wl: the stable argsort by (isotope, wavelength) of the
//    TLI line order, np.lexsort((wl, isoid))'s result in ~O(n).
//  * parse_fixed_floats: fixed-width ASCII float columns of HITRAN .par
//    records, strtod's values in the C locale.
//
// Plain C interface, no Python headers: built with the host C++ compiler
// into a shared library and loaded with ctypes
// (transit_tpu_torch/opacities/_build.py, transit_tpu_torch/_native.py).
// Callers allocate every output.

#include <locale.h>
#include <stdlib.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// group_partition: the co-add groups of the sorted lines (wavn, isoid),
// each n long, on the oversampled grid owns (onwn points).  Writes gid
// (n) and, per group, primary, inrange, iown and idwn (each n long, the
// first ng used); returns ng.
//
// A group starts at the first line not yet taken.  Outside [wn_i,
// wn_top] it stays a group of one (inrange 0).  Otherwise its grid point
// is the nearest oversampled bin (C truncation of (w - wn_i) / odwn, then
// one step up when strictly nearer), and it takes the following lines of
// the same isotope strictly within odwn of that point.
int64_t group_partition(const double* wavn, const int32_t* isoid, int64_t n,
                        const double* owns, int64_t onwn, double wn_i,
                        double odwn, double dwn, double wn_top, int32_t* gid,
                        int32_t* primary, uint8_t* inrange, int64_t* iown,
                        int64_t* idwn) {
  int64_t ng = 0;
  int64_t i = 0;
  while (i < n) {
    const int32_t g = (int32_t)ng;
    const double w = wavn[i];
    gid[i] = g;
    primary[ng] = (int32_t)i;
    if (w < wn_i || w > wn_top) {
      inrange[ng] = 0;
      iown[ng] = 0;
      idwn[ng] = 0;
      ++ng;
      ++i;
      continue;
    }
    int64_t io = (int64_t)((w - wn_i) / odwn);  // C truncation, w >= wn_i
    if (io + 1 < onwn && std::fabs(w - owns[io + 1]) < std::fabs(w - owns[io]))
      ++io;
    const double center = owns[io];
    int64_t j = i + 1;
    while (j < n && isoid[j] == isoid[i] &&
           std::fabs(wavn[j] - center) < odwn) {
      gid[j] = g;
      ++j;
    }
    inrange[ng] = 1;
    iown[ng] = io;
    idwn[ng] = (int64_t)((w - wn_i) / dwn);
    ++ng;
    i = j;
  }
  return ng;
}

// argsort_iso_wl: the permutation (out, n) that sorts the lines by
// (isoid, wl), stable: np.lexsort((wl, isoid)).  -0.0 equals +0.0, NaNs
// of either sign sort last, ties keep their input order.  Returns 0, or
// 1 when the isotope range exceeds 2^22 (nothing written).
//
// The wavelengths map through an order-preserving f64 -> u64 transform
// (all bits flipped for negatives, the sign bit for positives; -0.0 made
// +0.0, NaN the largest key).  One scatter pass by the top varying bits
// below the keys' common prefix partitions them into buckets of ~4K
// lines (2^10 to 2^20 buckets), each then sorted in cache by (key,
// index); a stable counting sort on isoid, read through the
// permutation, ends it.  ~3 passes over the arrays where an LSD radix
// makes 7-8.
int argsort_iso_wl(const int32_t* isoid, const double* wl, int64_t n,
                   int64_t* out) {
  int64_t iso_min = 0, iso_max = 0;
  if (n > 0) {
    iso_min = iso_max = isoid[0];
    for (int64_t i = 1; i < n; ++i) {
      iso_min = std::min<int64_t>(iso_min, isoid[i]);
      iso_max = std::max<int64_t>(iso_max, isoid[i]);
    }
  }
  const size_t niso = (size_t)(iso_max - iso_min) + 1;
  if (niso > ((size_t)1 << 22)) return 1;

  std::vector<uint64_t> key_a(n), key_b(n);
  std::vector<int64_t> idx_b(n);
  for (int64_t i = 0; i < n; ++i) {
    const double v = wl[i] + 0.0;
    uint64_t k;
    if (std::isnan(v)) {
      k = ~UINT64_C(0);
    } else {
      std::memcpy(&k, &v, sizeof(k));
      k ^= (k >> 63) ? ~UINT64_C(0) : (UINT64_C(1) << 63);
    }
    key_a[i] = k;
    out[i] = i;
  }
  uint64_t* ka = key_a.data();
  uint64_t* kb = key_b.data();
  int64_t* ia = out;
  int64_t* ib = idx_b.data();

  if (n > 1) {
    uint64_t kmin = ka[0], kmax = ka[0];
    for (int64_t i = 1; i < n; ++i) {
      kmin = std::min(kmin, ka[i]);
      kmax = std::max(kmax, ka[i]);
    }
    int bits = 10;
    const double want = (double)n / 4096.0;
    while ((1 << bits) < want && bits < 20) ++bits;
    const uint64_t range = kmax - kmin;
    int top = 0;  // the highest varying bit, plus one
    for (int b = 63; b >= 0; --b)
      if ((range >> b) & 1) {
        top = b + 1;
        break;
      }
    const int shift = top > bits ? top - bits : 0;
    const size_t nbuck = (size_t)(range >> shift) + 1;
    std::vector<int64_t> off(nbuck + 1, 0);
    for (int64_t i = 0; i < n; ++i) ++off[(size_t)((ka[i] - kmin) >> shift) + 1];
    for (size_t d = 1; d <= nbuck; ++d) off[d] += off[d - 1];
    std::vector<int64_t> cur(off.begin(), off.end() - 1);
    for (int64_t i = 0; i < n; ++i) {
      const int64_t dst = cur[(size_t)((ka[i] - kmin) >> shift)]++;
      kb[dst] = ka[i];
      ib[dst] = ia[i];
    }
    std::swap(ka, kb);
    std::swap(ia, ib);
    // The scatter kept the input order within a bucket; the index breaks
    // ties, so each bucket's sort is stable:
    std::vector<std::pair<uint64_t, int64_t>> tmp;
    for (size_t d = 0; d < nbuck; ++d) {
      const int64_t lo = off[d], hi = off[d + 1];
      if (hi - lo < 2) continue;
      tmp.resize((size_t)(hi - lo));
      for (int64_t i = lo; i < hi; ++i) tmp[(size_t)(i - lo)] = {ka[i], ia[i]};
      std::sort(tmp.begin(), tmp.end());
      for (int64_t i = lo; i < hi; ++i) ia[i] = tmp[(size_t)(i - lo)].second;
    }
  }

  if (niso > 1) {
    std::vector<int64_t> off(niso + 1, 0);
    for (int64_t i = 0; i < n; ++i) ++off[(size_t)(isoid[i] - iso_min) + 1];
    for (size_t d = 1; d <= niso; ++d) off[d] += off[d - 1];
    for (int64_t i = 0; i < n; ++i) {
      const int64_t src = ia[i];
      ib[off[(size_t)(isoid[src] - iso_min)]++] = src;
    }
    std::swap(ia, ib);
  }
  if (ia != out) std::memcpy(out, ia, (size_t)n * sizeof(int64_t));
  return 0;
}

// parse_fixed_floats: field k (k < n) is the `width` bytes at
// data + k * recsize + offset (at most 63 of them); out[k] is strtod's
// value of it in the C locale, whatever the process locale: leading
// white space skipped, the parse ending at the first byte that is not
// part of a number, a blank field 0.0.  Returns 0, 1 when the records
// overrun the `len` bytes of data, 2 when the C locale cannot be made.
int parse_fixed_floats(const char* data, int64_t len, int64_t recsize,
                       int64_t offset, int64_t width, int64_t n, double* out) {
  if (n <= 0) return 0;
  if (offset < 0 || width < 0 || (n - 1) * recsize + offset + width > len)
    return 1;
  static const locale_t c_locale = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  if (c_locale == (locale_t)0) return 2;
  const int64_t w = width < 63 ? width : 63;
  char tmp[64];
  for (int64_t k = 0; k < n; ++k) {
    std::memcpy(tmp, data + k * recsize + offset, (size_t)w);
    tmp[w] = '\0';
    out[k] = strtod_l(tmp, nullptr, c_locale);
  }
  return 0;
}

}  // extern "C"
