// Line extinction on a tile plan: the Hopper counterpart of the Pallas
// kernel transit_tpu/opacities/pallas_lbl.py:_kernel (launched by
// pallas_extinction), of the near tiles and stride-1 far shells of the
// banded path (fast._run_tiles / _block_primal with a per-layer wing
// cutoff, fast.py:554-571, 690-837), and of the per-layer kmax scan
// (pallas_lbl.py:127-133, fast._kmax_scan).
//
// A launch covers one tile class of a plan (the global tile of each row
// of the line tensors in `tiles`) on a list of layer rows (`rows`, the
// band's layers), and writes, or with `accumulate` adds, its sums into
// those rows and the tiles' columns of the (nl, n_coarse) output.  K is
// the Voigt function of the plan (w4; r2 for a stride-1 far shell).
//
// For each tile of tw coarse bins, layer and bin, line_tile_kernel sums
// over the tile's lines
//     k * K(x, y) / alphaD,
//     k  = gf e^(-c2 El/T) (1 - e^(-c2 nu/T)) coef0 dens   (0 when the line's
//          k0 < ethresh * kmax, extinction.c:400-427),
//     K  = Humlicek w4 Voigt (or a far-wing kernel), x = sqrt(ln2)
//          |nu_bin - nu| / alphaD clamped at 1e8,
//          y = sqrt(ln2) alphaL / alphaD,
// where |nu_bin - nu| <= nwidth * max(alphaD, alphaL).
//
// What bounds it: FP32 arithmetic, and on this data most of the work is
// dead.  Of the (layer, bin, line) triples of the tile plan only ~3% are
// kept lines inside their wing, and their bins form one contiguous run per
// (layer, line): the distance to the line is monotone on each side of it.
// So the kernel never tests pairs; it finds runs and evaluates only them:
//   * one block per (tile, block of lb layers).  A window of the tile's
//     lines that can reach it at all is found first; the window goes
//     through in chunks of CH lines, a thread taking SEG consecutive
//     (layer, line) elements of a chunk.  A chunk's line rows are loaded
//     two chunks ahead and staged one chunk ahead (double buffer);
//   * set-up: per element the wing and the run [b0, b1] of the tile's bins
//     inside it (find_run: seeded at the nearest bin, settled with the
//     exact test); only a line that reaches the tile pays the strength
//     chain, and only a kept one 1/alphaD and y;
//   * compaction: one block-wide scan of the live (kept, reaching)
//     elements and their run lengths lists them layer by layer in line
//     order, and numbers their (bin, line) pairs;
//   * evaluation: every thread takes pairs off that list, so the Voigt runs
//     on all lanes, and writes k K / alphaD to a shared-memory slot; a chunk
//     with more pairs than CAP slots goes in rounds;
//   * summation: the thread that owns (layer, bin) walks its layer's list
//     and adds its terms in line order with a Kahan compensation carried
//     across chunks: the same terms in the same order as a thread that
//     walks every line, with no float atomics.
// Each element takes only its own Voigt region's rational, where the TPU's
// branch-free form computes all three.  Ragged layer blocks and the ragged
// last tile are masked, not padded.
//
// layer_kmax_kernel: kmax[L] = max over the line list of k0 (the chain
// above without dens); its design is described at the kernel.
//
// Rounding: the bin wavenumber ((wa + dwn*bin) + wb: wa = wn_i +
// dwn*(tile*tw), wb = 0 as the Pallas kernel rounds it; with bins_first,
// wa = wn_i, wb = dwn*(tile*tw) as fast._run_tiles does), x, and the
// strength chain use the _rn intrinsics, which the compiler never contracts
// into FMAs, so they round as the plain PyTorch version's separate ops do.
// Build without --use_fast_math (expf/cosf must stay accurate to ~1 ulp).

#include "voigt.cuh"

namespace {

constexpr int NT = 256;           // threads per line-tile block
constexpr int OWN = 2;            // (layer, bin) owners per thread
constexpr int MAX_TW = OWN * NT;  // widest tile: lb * tw <= OWN * NT
constexpr int SEG = 4;            // (layer, line) elements per thread
constexpr int NE = NT * SEG;      // elements per chunk: lb * CH <= NE
constexpr int CAP = 4096;         // pair slots per evaluation round
constexpr int MAX_LB = 32;        // layers per block (5 bits of a slot code)
constexpr int NWARP = NT / 32;

// Bin b of the tile at (wa + dwn*b) + wb (see Rounding above).
__device__ __forceinline__ float bin_wn(float wa, float wb, float dwn,
                                        int b) {
  return __fadd_rn(__fadd_rn(wa, __fmul_rn(dwn, (float)b)), wb);
}

__device__ __forceinline__ int layer_of(const int* rows, int i) {
  return rows ? rows[i] : i;
}

// The run [b0, b1] of the tile's bins b with |wn_b - wv| <= wing; false
// when there is none.  The set is an interval, since wn_b rises with b and
// the rounded distance is monotone on each side of wv.  Seeded at the bin
// nearest the line (clamped to the tile) and settled with the exact test,
// so the seed's rounding never changes the answer.  If the seed bin is
// out, the run can only lie toward the line: walk that way until a bin is
// in, or the walk passes the line (every farther bin is out) or the tile.
__device__ __forceinline__ bool find_run(float wa, float wb, float dwn,
                                         float inv_dwn, int tw, float wv,
                                         float wing, int& b0, int& b1) {
  const float c =
      rintf(__fmul_rn(__fsub_rn(wv, __fadd_rn(wa, wb)), inv_dwn));
  int s = (int)fminf(fmaxf(c, 0.0f), (float)(tw - 1));
  float w = bin_wn(wa, wb, dwn, s);
  if (!(fabsf(__fsub_rn(w, wv)) <= wing)) {
    const int step = w < wv ? 1 : -1;
    for (;;) {
      s += step;
      if (s < 0 || s >= tw) return false;
      w = bin_wn(wa, wb, dwn, s);
      if (fabsf(__fsub_rn(w, wv)) <= wing) break;
      if (step > 0 ? w >= wv : w <= wv) return false;
    }
  }
  b0 = s;
  b1 = s;
  while (b0 > 0 &&
         fabsf(__fsub_rn(bin_wn(wa, wb, dwn, b0 - 1), wv)) <= wing)
    --b0;
  while (b1 < tw - 1 &&
         fabsf(__fsub_rn(bin_wn(wa, wb, dwn, b1 + 1), wv)) <= wing)
    ++b1;
  return true;
}

// Shared-memory layout of line_tile_kernel (dynamic, > 48 KB).
struct Rows {                     // a chunk's line rows, staged
  float wv[NT], el[NT], gf[NT];
  int iso[NT];                    // -1: masked
};
static_assert(NT <= 2048 && MAX_LB <= 32 && MAX_TW <= 1024,
              "slot codes' and run codes' bit fields");
constexpr size_t SMEM_BYTES =
    3 * NE * sizeof(float)            // s_k, s_inv, s_y
    + NE * sizeof(unsigned)           // s_run
    + NE * sizeof(int2)               // s_ent
    + CAP * sizeof(unsigned)          // s_slot
    + 2 * sizeof(Rows)                // s_rows, double-buffered
    + (MAX_LB + 1) * sizeof(int)      // s_lfirst
    + NWARP * sizeof(unsigned)        // s_scan
    + (2 * NWARP + 1) * sizeof(int);  // s_win, s_nchain

template <int WFN>
__global__ void __launch_bounds__(NT, 4)
line_tile_kernel(const float* __restrict__ wavn,
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
                 int nrows, int lmax, int niso, int tw, int lb,
                 int n_coarse, int accumulate, int bins_first, float wn_i,
                 float dwn, float ethresh, float nwidth, float neg_expcte) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_k = reinterpret_cast<float*>(smem);   // (lb, CH) k
  float* s_inv = s_k + NE;                       // (lb, CH) 1 / alphaD
  float* s_y = s_inv + NE;                       // (lb, CH) y
  unsigned* s_run = reinterpret_cast<unsigned*>(s_y + NE);
  int2* s_ent = reinterpret_cast<int2*>(s_run + NE);  // live list
  unsigned* s_slot = reinterpret_cast<unsigned*>(s_ent + NE);
  Rows* s_rows = reinterpret_cast<Rows*>(s_slot + CAP);
  int* s_lfirst = reinterpret_cast<int*>(s_rows + 2);
  unsigned* s_scan = reinterpret_cast<unsigned*>(s_lfirst + MAX_LB + 1);
  int* s_win = reinterpret_cast<int*>(s_scan + NWARP);
  int* s_nchain = s_win + 2 * NWARP;

  const int tile = tiles ? tiles[blockIdx.x] : (int)blockIdx.x;
  const int l0 = blockIdx.y * lb;
  const int nlay = min(lb, nrows - l0);  // the block's layers
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tpl = NT / lb;                 // set-up threads per layer
  const int seg = min(SEG, NT / tpl);      // elements per set-up thread
  const int CH = tpl * seg;                // lines per chunk, <= NT
  // Set-up role: layer lj, elements (lj, jseg .. jseg + seg - 1).
  const int lj = tid / tpl;
  const int jseg = (tid - lj * tpl) * seg;
  const bool setup = lj < nlay;
  const int L = setup ? layer_of(rows, l0 + lj) : 0;
  // Owner roles: (layer ll, bin b), OWN per thread for tiles wider than NT.
  int o_ll[OWN], o_b[OWN];
  bool o_on[OWN];
  size_t o_at[OWN];
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int ob = tid + o * NT;
    o_ll[o] = ob / tw;
    o_b[o] = ob - o_ll[o] * tw;
    const int col = tile * tw + o_b[o];
    o_on[o] = o_ll[o] < nlay && col < n_coarse;
    o_at[o] = o_on[o] ? (size_t)layer_of(rows, l0 + o_ll[o]) * n_coarse + col
                      : 0;
  }

  const float toff = __fmul_rn(dwn, (float)(tile * tw));
  const float wa = bins_first ? wn_i : __fadd_rn(wn_i, toff);
  const float wb = bins_first ? toff : 0.0f;
  const float inv_dwn = 1.0f / dwn;
  const size_t row = (size_t)blockIdx.x * lmax;
  float T = 1.0f, thr = 0.0f;
  if (setup) {
    T = temps[L];
    thr = __fmul_rn(ethresh, kmax[L]);
  }
  if (tid == 0) *s_nchain = 0;

  // The block's window of lines [jlo, jhi): every unmasked line whose wing
  // can reach a bin of the tile in one of the block's layers lies in it.
  // A wing is nwidth * max(alphad_f * nu, alphaL), each rounded operation
  // is monotone, so with the block's largest alphad_f and alphaL it is at
  // most `reach`; a line farther than reach from the tile's first and last
  // bins (with a margin for the rounding of the distance) reaches none.
  // (A far shell's two line ranges are one sorted list with a gap; the
  // window does not depend on the order.)
  float dfmax = 0.0f, almax = 0.0f;       // each warp reduces the tables
  for (int t = lane; t < nlay * niso; t += 32) {
    const int ti = layer_of(rows, l0 + t / niso) * niso + t % niso;
    dfmax = fmaxf(dfmax, alphad_f[ti]);
    almax = fmaxf(almax, alphal[ti]);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    dfmax = fmaxf(dfmax, __shfl_xor_sync(FULL, dfmax, o));
    almax = fmaxf(almax, __shfl_xor_sync(FULL, almax, o));
  }
  const double wn_first = bin_wn(wa, wb, dwn, 0);
  const double wn_last = bin_wn(wa, wb, dwn, tw - 1);
  int jlo = lmax, jhi = 0;
#pragma unroll 4
  for (int t = tid; t < lmax; t += NT) {
    const bool on = mask[row + t];
    const float wvf = wavn[row + t];
    const double wv = wvf, reach = 1.000001 * (double)__fmul_rn(
        nwidth, fmaxf(__fmul_rn(dfmax, wvf), almax));
    if (on && wn_first - wv <= reach && wv - wn_last <= reach) {
      jlo = min(jlo, t);
      jhi = t + 1;
    }
  }
  jlo = __reduce_min_sync(FULL, jlo);
  jhi = __reduce_max_sync(FULL, jhi);
  if (lane == 0) {
    s_win[warp] = jlo;
    s_win[NWARP + warp] = jhi;
  }
  __syncthreads();
  for (int w = 0; w < NWARP; ++w) {
    jlo = min(jlo, s_win[w]);
    jhi = max(jhi, s_win[NWARP + w]);
  }

  float acc[OWN], comp[OWN];
#pragma unroll
  for (int o = 0; o < OWN; ++o) acc[o] = comp[o] = 0.0f;
  // Thread 0: the block's live entries and pairs, for stats.
  unsigned long long n_live = 0, n_pair = 0;

  // Line rows: chunk k is staged in s_rows[k & 1] during chunk k - 1, from
  // registers loaded during chunk k - 2, so the loads' latency hides
  // behind a chunk of work and the staging needs no barrier of its own.
  float r_wv = 0.0f, r_el = 0.0f, r_gf = 0.0f;
  int r_iso = -1;
  auto load = [&](int c) {
    if (tid < min(CH, jhi - c)) {
      const size_t g = row + c + tid;
      r_wv = wavn[g];
      r_el = elow[g];
      r_gf = gf[g];
      r_iso = mask[g] ? iso[g] : -1;
    }
  };
  auto stage = [&](Rows& r, int c) {
    if (tid < min(CH, jhi - c)) {
      r.wv[tid] = r_wv;
      r.el[tid] = r_el;
      r.gf[tid] = r_gf;
      r.iso[tid] = r_iso;
    }
  };
  load(jlo);
  stage(s_rows[0], jlo);
  load(jlo + CH);
  __syncthreads();

  for (int c0 = jlo, k = 0; c0 < jhi; c0 += CH, ++k) {
    const int cn = min(CH, jhi - c0);
    const Rows& rw = s_rows[k & 1];
    __syncthreads();                      // the previous chunk is consumed
    stage(s_rows[(k + 1) & 1], c0 + CH);
    load(c0 + 2 * CH);

    // 1. Set-up: per element the wing and its run of the tile's bins
    //    (find_run); for a line that reaches the tile, its strength, and
    //    for a kept one k, 1/alphaD and y.
    int nchain = 0, nlive = 0, npair = 0;
    for (int i = 0; i < seg; ++i) {
      const int j = jseg + i;
      const int e = lj * CH + j;
      unsigned run = 0;
      if (setup && j < cn && rw.iso[j] >= 0) {
        const float wv = rw.wv[j];
        const int ti = L * niso + rw.iso[j];
        const float aL = alphal[ti];
        const float aD = __fmul_rn(alphad_f[ti], wv);
        const float wing = __fmul_rn(nwidth, fmaxf(aD, aL));
        int b0, b1;
        if (find_run(wa, wb, dwn, inv_dwn, tw, wv, wing, b0, b1)) {
          ++nchain;
          const float k0 = strength(rw.gf[j], rw.el[j], wv, T, coef0[ti],
                                    neg_expcte);
          if (k0 >= thr) {
            const float inv = __fdiv_rn(1.0f, aD);
            s_k[e] = __fmul_rn(k0, densm[ti]);
            s_inv[e] = inv;
            s_y[e] = __fmul_rn(__fmul_rn(SQRTLN2, aL), inv);
            run = 1u << 20 | (unsigned)b1 << 10 | (unsigned)b0;
            ++nlive;
            npair += b1 - b0 + 1;
          }
        }
      }
      if (lj < lb) s_run[e] = run;
    }
    if (stats) {
      nchain = __reduce_add_sync(FULL, nchain);
      if (lane == 0) atomicAdd(s_nchain, nchain);
    }

    // 2. Compaction: exclusive block scan of (live, pairs), packed 11 | 21
    //    bits (per chunk at most NE and NE * MAX_TW / 4), lists the live
    //    elements layer by layer in line order and numbers their
    //    (bin, line) pairs.
    const unsigned mine = (unsigned)nlive << 21 | (unsigned)npair;
    unsigned v = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned u = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) s_scan[warp] = v;
    __syncthreads();
    if (warp == 0) {
      unsigned w = lane < NWARP ? s_scan[lane] : 0u;
#pragma unroll
      for (int o = 1; o < NWARP; o <<= 1) {
        const unsigned u = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w += u;
      }
      if (lane < NWARP) s_scan[lane] = w;
    }
    __syncthreads();
    const unsigned excl = v - mine + (warp > 0 ? s_scan[warp - 1] : 0u);
    const unsigned total = s_scan[NWARP - 1];
    const int live_base = (int)(excl >> 21);
    const int pair_base = (int)(excl & 0x1fffff);
    const int P = (int)(total & 0x1fffff);
    if (tid == 0) {
      n_live += total >> 21;
      n_pair += P;
    }
    {
      int q = live_base, p = pair_base;
      for (int i = 0; i < seg && lj < lb; ++i) {
        const unsigned run = s_run[lj * CH + jseg + i];
        if (run) {
          const int b0 = run & 1023, b1 = run >> 10 & 1023;
          s_ent[q++] = make_int2(p, b0 | (b1 - b0) << 16);
          p += b1 - b0 + 1;
        }
      }
      if (lj < lb && jseg == 0) s_lfirst[lj] = live_base;
      if (tid == 0) s_lfirst[lb] = (int)(total >> 21);
    }

    // 3. + 4. Evaluate the pairs, CAP at a time, then sum them per owner.
    for (int r0 = 0; r0 < P; r0 += CAP) {
      const int rn = min(CAP, P - r0);
      if (lj < lb && npair && pair_base < r0 + rn &&
          pair_base + npair > r0) {
        int p = pair_base - r0;
        for (int i = 0; i < seg; ++i) {
          const int j = jseg + i;
          const unsigned run = s_run[lj * CH + j];
          if (!run) continue;
          const int b0 = run & 1023, b1 = run >> 10 & 1023;
          for (int bb = b0; bb <= b1; ++bb, ++p)
            if ((unsigned)p < (unsigned)rn)
              s_slot[p] = (unsigned)j | (unsigned)lj << 11 |
                          (unsigned)bb << 16;
        }
      }
      __syncthreads();
      for (int s = tid; s < rn; s += NT) {
        const unsigned code = s_slot[s];
        const int j = code & 2047;
        const int e = (int)(code >> 11 & 31) * CH + j;
        const float dist = fabsf(__fsub_rn(
            bin_wn(wa, wb, dwn, (int)(code >> 16)), rw.wv[j]));
        const float inv = s_inv[e];
        const float x =
            fminf(__fmul_rn(__fmul_rn(SQRTLN2, dist), inv), 1e8f);
        const float prof = __fmul_rn(voigt_k<WFN>(x, s_y[e]), inv);
        s_slot[s] = __float_as_uint(__fmul_rn(prof, s_k[e]));
      }
      __syncthreads();
#pragma unroll
      for (int o = 0; o < OWN; ++o) {
        if (!o_on[o]) continue;
        const int qb = s_lfirst[o_ll[o] + 1];
#pragma unroll 4
        for (int q = s_lfirst[o_ll[o]]; q < qb; ++q) {
          const int2 en = s_ent[q];              // (first pair, b0 | len-1)
          const int d = o_b[o] - (en.y & 0xffff);
          const int p = en.x + d - r0;
          if ((unsigned)d <= (unsigned)(en.y >> 16) &&
              (unsigned)p < (unsigned)rn) {
            // Compensated (Kahan) sum: a bin adds up hundreds of lines one
            // by one, where the plain version's reduction is a tree.
            const float term =
                __fsub_rn(__uint_as_float(s_slot[p]), comp[o]);
            const float t = __fadd_rn(acc[o], term);
            comp[o] = __fsub_rn(__fsub_rn(t, acc[o]), term);
            acc[o] = t;
          }
        }
      }
      if (r0 + CAP < P) __syncthreads();  // else the next chunk's first
    }
  }
#pragma unroll
  for (int o = 0; o < OWN; ++o)
    if (o_on[o])
      out[o_at[o]] = accumulate ? __fadd_rn(out[o_at[o]], acc[o]) : acc[o];
  if (stats) {
    __syncthreads();
    if (tid == 0 && *s_nchain) {
      atomicAdd(&stats[0], (unsigned long long)*s_nchain);
      atomicAdd(&stats[1], n_live);
      atomicAdd(&stats[2], n_pair);
    }
  }
}

template <int WFN>
int launch_line_tile(dim3 grid, cudaStream_t stream, const float* wavn,
                     const float* elow, const float* gf, const int* iso,
                     const unsigned char* mask, const int* tiles,
                     const int* rows, const float* temps,
                     const float* alphal, const float* alphad_f,
                     const float* coef0, const float* densm,
                     const float* kmax, float* out,
                     unsigned long long* stats, int nrows, int lmax,
                     int niso, int tw, int lb, int n_coarse, int accumulate,
                     int bins_first, float wn_i, float dwn, float ethresh,
                     float nwidth, float neg_expcte) {
  cudaError_t err = cudaFuncSetAttribute(
      line_tile_kernel<WFN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  line_tile_kernel<WFN><<<grid, NT, SMEM_BYTES, stream>>>(
      wavn, elow, gf, iso, mask, tiles, rows, temps, alphal, alphad_f,
      coef0, densm, kmax, out, stats, nrows, lmax, niso, tw, lb, n_coarse,
      accumulate, bins_first, wn_i, dwn, ethresh, nwidth, neg_expcte);
  return (int)cudaGetLastError();
}

// The kmax scan (pallas_lbl.py:127-133, fast._kmax_scan): per layer, the
// max over the full line list of k0 = gf e^(-c2 El/T) (1 - e^(-c2 nu/T))
// coef0.  What bounds it: the two exps of each (layer, line) chain on the
// SFU (MUFU.EX2, a quarter of the FP32 rate), then FP32.  The design:
//   * each block takes KM_LAYERS layers, with their temperatures, the
//     reciprocals r = RN(1/T) and their coef0 rows in shared memory, so the
//     line list is read ceil(nl / KM_LAYERS) times (4 for 100 layers);
//   * a thread reads a line once and forms c2 El and c2 nu once for all
//     its layers;
//   * each quotient is q = RN(x r) corrected once (Markstein): q' =
//     fma(fma(-q, T, x), r, q), the correctly rounded x / T, with no
//     division and no MUFU.RCP in the chain, so a chain equals the plain
//     version's bit for bit and the max is order-free (an atomic max on
//     the float's bits across blocks);
//   * the grid is a whole number of waves of resident blocks.
constexpr int KM_THREADS = 256;
constexpr int KM_LAYERS = 25;      // layers per block, maxima in registers
constexpr int KM_MAX_ISO = 64;     // isotopes of the coef0 rows in shared

// Atomic max of a float by its bit pattern: a non-negative float orders
// as a signed int, a negative one in reverse as an unsigned int.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (!(v < 0.0f))
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// x / T correctly rounded from r = RN(1/T): one Markstein correction of
// RN(x r).
__device__ __forceinline__ float div_by(float x, float T, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, T, x), r, q);
}

__global__ void __launch_bounds__(KM_THREADS, 2)
layer_kmax_kernel(const float* __restrict__ wavn,
                  const float* __restrict__ elow,
                  const float* __restrict__ gf,
                  const int* __restrict__ iso,
                  const float* __restrict__ temps,
                  const float* __restrict__ coef0,
                  float* __restrict__ kmax,
                  int nlines, int nl, int niso, float neg_expcte) {
  __shared__ float s_coef[KM_MAX_ISO * KM_LAYERS];   // (iso, layer)
  __shared__ float s_red[KM_THREADS / 32][KM_LAYERS];
  const int l0 = blockIdx.y * KM_LAYERS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < niso * KM_LAYERS; i += KM_THREADS) {
    const int is = i / KM_LAYERS, a = i - is * KM_LAYERS;
    s_coef[i] = l0 + a < nl ? coef0[(size_t)(l0 + a) * niso + is] : 0.0f;
  }
  float T[KM_LAYERS], r[KM_LAYERS], m[KM_LAYERS];
#pragma unroll
  for (int a = 0; a < KM_LAYERS; ++a) {
    T[a] = l0 + a < nl ? temps[l0 + a] : 1.0f;
    r[a] = __frcp_rn(T[a]);
    m[a] = -INFINITY;
  }
  __syncthreads();
  for (int i = blockIdx.x * KM_THREADS + threadIdx.x; i < nlines;
       i += gridDim.x * KM_THREADS) {
    const float g = gf[i];
    const float x1 = __fmul_rn(neg_expcte, elow[i]);
    const float x2 = __fmul_rn(neg_expcte, wavn[i]);
    const float* cf = s_coef + iso[i] * KM_LAYERS;
#pragma unroll
    for (int a = 0; a < KM_LAYERS; ++a) {
      // strength() of voigt.cuh with the divisions hoisted.
      const float e1 = expf(div_by(x1, T[a], r[a]));
      const float e2 = expf(div_by(x2, T[a], r[a]));
      const float k0 = __fmul_rn(
          __fmul_rn(__fmul_rn(g, e1), __fsub_rn(1.0f, e2)), cf[a]);
      m[a] = fmaxf(m[a], k0);
    }
  }
#pragma unroll
  for (int a = 0; a < KM_LAYERS; ++a) {
    float v = m[a];
#pragma unroll
    for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    if (lane == 0) s_red[warp][a] = v;
  }
  __syncthreads();
  if (threadIdx.x < KM_LAYERS && l0 + (int)threadIdx.x < nl) {
    float v = s_red[0][threadIdx.x];
    for (int w = 1; w < KM_THREADS / 32; ++w)
      v = fmaxf(v, s_red[w][threadIdx.x]);
    atomic_max_float(&kmax[l0 + threadIdx.x], v);
  }
}

// The backward of line_tile_kernel: the counterpart of
// fast._block_val_bwd without a line weight (fast.py:608-680), the analytic
// VJP of the JAX path's tile blocks (jnp code that XLA fuses, not Pallas).
// Given the cotangent g (nl, n_coarse) of the output, for each live (layer,
// tile, line) entry (kept, and its wing reaches a bin of the tile: the
// forward's run [b0, b1] from find_run) it takes three sums over the run's
// bins (add_bin_sums: the Voigt pair and its Faddeeva partials recomputed
// in float32, no residuals, the sums float64), chains them to the line's
// cotangents (chain_terms, float64) and adds those to the layer's
// temperature and (layer, isotope) table cells.
//
// What bounds it: per live entry its set-up and chain (on the main path
// 13.0e6 entries with 2.3 pairs each), per pair the Voigt pair (30.3e6 on
// the main path; 297.5e6 at 0.05 cm-1, 13 per entry).  The design:
//   * one launch per band: a block takes one tile of one of the band's
//     tile classes (near and stride-1 shell classes, from a table passed
//     by value) and a block of lb of the band's layer rows (all of them,
//     as shared memory allows); the layers' temperatures, thresholds and
//     table rows and the tile's g columns are staged in shared memory;
//   * the forward's window [jlo, jhi) of lines that can reach the tile,
//     walked in chunks of BNE lines staged in shared memory;
//   * one pass: thread tid keeps to layer tid % nlay and takes every
//     ns-th line of a chunk, so the lanes of a warp read one line for
//     their layers and find similar runs; per element its set-up
//     (find_run, the strength with T's reciprocal hoisted, the keep
//     test), its run of pairs and its chain;
//   * the thread sums its entries' cotangents in its own shared slots
//     (CellAcc) and adds them once, summed over the lanes of a warp with
//     the same cell, before one shared atomic per cell;
//   * one float64 atomic per block and nonzero cell into the global sums
//     (nl, 1 + 4 niso): a temperature's cotangent sums ~30e6 terms of both
//     signs on the main path, which float32 atomics would make drift.
// One pass, not a set-up pass, a block scan and the pairs dealt out
// evenly to the lanes: timed with per-element cell adds, that compacted
// design was slower than one pass at 0.05 cm-1 (13 pairs an entry) and
// 10% faster on the main path (2.3 pairs an entry); one pass with the
// per-thread cell slots is faster than both (PERF.md §6).
constexpr int BT = 256;               // threads per backward block
constexpr int BNE = 512;              // lines per chunk
constexpr int BWARP = BT / 32;
constexpr int MAX_CLASSES = 16;
constexpr int BWD_MAX_LB = 256;       // layers per block

// One tile class of a backward launch: its line tensors (ntiles, lmax),
// the global tile of each row (null: row i is tile i), tile width, Voigt
// function (0 w4, 1 r2) and its first block.
struct LineClass {
  const float* wavn;
  const float* elow;
  const float* gf;
  const int* iso;
  const unsigned char* mask;
  const int* tiles;
  int ntiles, lmax, tw, wfn, blk0;
};
struct LineClasses {
  int n;
  LineClass c[MAX_CLASSES];
};

// Shared memory of line_tile_bwd_kernel: fixed arrays, then per layer its
// table rows (lb, niso) float4 (alphal, alphad_f, coef0, densm), cells
// (lb, ncell) f64, staged cotangents (lb, tw), T and threshold.
struct BwdShared {
  double acc[NACC * BT];              // the threads' CellAcc slots
  double scr[BWARP * 32 * 4];         // warp_cells scratch
  float wv[BNE], el[BNE], gf[BNE];    // a chunk's line rows
  int iso[BNE];                       // -1: masked
  int win[2 * BWARP];
};
constexpr size_t BWD_FIXED = (sizeof(BwdShared) + 15) / 16 * 16;

template <int WFN>
__device__ __forceinline__ void run_sums(const float* gl, int b0, int b1,
                                         float wa, float wb, float dwn,
                                         float wv, float inv, float y,
                                         double& s1, double& s2,
                                         double& s3) {
  for (int b = b0; b <= b1; ++b) {
    const float gb = gl[b];
    if (gb == 0.0f) continue;
    const float dist = fabsf(__fsub_rn(bin_wn(wa, wb, dwn, b), wv));
    add_bin_sums<WFN>(__fmul_rn(__fmul_rn(SQRTLN2, dist), inv), y, gb, s1,
                      s2, s3);
  }
}

__global__ void __launch_bounds__(BT, 3)
line_tile_bwd_kernel(const __grid_constant__ LineClasses cls,
                     const int* __restrict__ rows,
                     const float* __restrict__ temps,
                     const float* __restrict__ alphal,
                     const float* __restrict__ alphad_f,
                     const float* __restrict__ coef0,
                     const float* __restrict__ densm,
                     const float* __restrict__ kmax,
                     const float* __restrict__ g,
                     double* __restrict__ acc,
                     int nrows, int lb, int tw_max, int niso, int n_coarse,
                     int bins_first, float wn_i, float dwn, float ethresh,
                     float nwidth, float neg_expcte) {
  extern __shared__ __align__(16) unsigned char smem[];
  BwdShared& sh = *reinterpret_cast<BwdShared*>(smem);
  const int ncell = 1 + 4 * niso;
  float4* s_tab = reinterpret_cast<float4*>(smem + BWD_FIXED);
  double* s_red = reinterpret_cast<double*>(s_tab + lb * niso);
  float* s_g = reinterpret_cast<float*>(s_red + lb * ncell);  // (lb, tw)
  float* s_T = s_g + lb * tw_max;
  float* s_thr = s_T + lb;

  // The block's class and tile.
  int c = 0;
  while (c + 1 < cls.n && (int)blockIdx.x >= cls.c[c + 1].blk0) ++c;
  const float* wavn = cls.c[c].wavn;
  const float* elow = cls.c[c].elow;
  const float* gfa = cls.c[c].gf;
  const int* isoa = cls.c[c].iso;
  const unsigned char* mask = cls.c[c].mask;
  const int lmax = cls.c[c].lmax, tw = cls.c[c].tw, wfn = cls.c[c].wfn;
  const int r = (int)blockIdx.x - cls.c[c].blk0;
  const int tile = cls.c[c].tiles ? cls.c[c].tiles[r] : r;

  const int l0 = blockIdx.y * lb;
  const int nlay = min(lb, nrows - l0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // The layers' values, the tile's cotangents, zero cells.
  for (int i = tid; i < nlay * ncell; i += BT) s_red[i] = 0.0;
  for (int i = tid; i < nlay; i += BT) {
    const int L = layer_of(rows, l0 + i);
    s_T[i] = temps[L];
    s_thr[i] = __fmul_rn(ethresh, kmax[L]);
  }
  for (int i = tid; i < nlay * niso; i += BT) {
    const int ti = layer_of(rows, l0 + i / niso) * niso + i % niso;
    s_tab[i] = make_float4(alphal[ti], alphad_f[ti], coef0[ti], densm[ti]);
  }
  for (int i = tid; i < nlay * tw; i += BT) {
    const int ll = i / tw, col = tile * tw + (i - ll * tw);
    s_g[i] = col < n_coarse
                 ? g[(size_t)layer_of(rows, l0 + ll) * n_coarse + col]
                 : 0.0f;
  }
  CellAcc cells(sh.acc, BT);
  __syncthreads();

  const float toff = __fmul_rn(dwn, (float)(tile * tw));
  const float wa = bins_first ? wn_i : __fadd_rn(wn_i, toff);
  const float wb = bins_first ? toff : 0.0f;
  const float inv_dwn = 1.0f / dwn;
  const size_t row = (size_t)r * lmax;

  // The block's window of lines [jlo, jhi), as line_tile_kernel finds it.
  float dfmax = 0.0f, almax = 0.0f;
  for (int t = lane; t < nlay * niso; t += 32) {
    dfmax = fmaxf(dfmax, s_tab[t].y);
    almax = fmaxf(almax, s_tab[t].x);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    dfmax = fmaxf(dfmax, __shfl_xor_sync(FULL, dfmax, o));
    almax = fmaxf(almax, __shfl_xor_sync(FULL, almax, o));
  }
  const double wn_first = bin_wn(wa, wb, dwn, 0);
  const double wn_last = bin_wn(wa, wb, dwn, tw - 1);
  int jlo = lmax, jhi = 0;
  for (int t = tid; t < lmax; t += BT) {
    const bool on = mask[row + t];
    const float wvf = wavn[row + t];
    const double wv = wvf, reach = 1.000001 * (double)__fmul_rn(
        nwidth, fmaxf(__fmul_rn(dfmax, wvf), almax));
    if (on && wn_first - wv <= reach && wv - wn_last <= reach) {
      jlo = min(jlo, t);
      jhi = t + 1;
    }
  }
  jlo = __reduce_min_sync(FULL, jlo);
  jhi = __reduce_max_sync(FULL, jhi);
  if (lane == 0) {
    sh.win[warp] = jlo;
    sh.win[BWARP + warp] = jhi;
  }
  __syncthreads();
  for (int w = 0; w < BWARP; ++w) {
    jlo = min(jlo, sh.win[w]);
    jhi = max(jhi, sh.win[BWARP + w]);
  }

  // The thread's layer and lines: layer tid % nlay, every ns-th line from
  // tid / nlay.
  const int ll = tid % nlay, s0 = tid / nlay;
  const int ns = BT / nlay + (ll < BT % nlay ? 1 : 0);
  const float T = s_T[ll], rT = __frcp_rn(T), thr = s_thr[ll];
  const double expcte = -(double)neg_expcte;
  const float* gl = s_g + ll * tw;
  for (int c0 = jlo; c0 < jhi; c0 += BNE) {
    const int cn = min(BNE, jhi - c0);
    __syncthreads();                      // the previous chunk is consumed
    for (int j = tid; j < cn; j += BT) {
      const size_t gi = row + c0 + j;
      sh.wv[j] = wavn[gi];
      sh.el[j] = elow[gi];
      sh.gf[j] = gfa[gi];
      sh.iso[j] = mask[gi] ? isoa[gi] : -1;
    }
    __syncthreads();
    for (int j = s0; j < cn; j += ns) {
      const int is = sh.iso[j];
      if (is < 0) continue;
      const float4 tb = s_tab[ll * niso + is];
      const float wv = sh.wv[j];
      const float aD = __fmul_rn(tb.y, wv);
      const float wing = __fmul_rn(nwidth, fmaxf(aD, tb.x));
      int b0, b1;
      if (!find_run(wa, wb, dwn, inv_dwn, tw, wv, wing, b0, b1)) continue;
      float e1, e2, sj;
      strength_parts(sh.gf[j], sh.el[j], wv, T, rT, neg_expcte, e1, e2,
                       sj);
      const float k0 = __fmul_rn(sj, tb.z);
      if (!(k0 >= thr)) continue;
      const float inv = __fdiv_rn(1.0f, aD);
      const float y = __fmul_rn(__fmul_rn(SQRTLN2, tb.x), inv);
      double s1 = 0.0, s2 = 0.0, s3 = 0.0;
      if (wfn == 0)
        run_sums<0>(gl, b0, b1, wa, wb, dwn, wv, inv, y, s1, s2, s3);
      else
        run_sums<1>(gl, b0, b1, wa, wb, dwn, wv, inv, y, s1, s2, s3);
      double t[5];
      chain_terms(t, s1, s2, s3, inv, __fmul_rn(k0, tb.w), k0, tb.w, 1.0,
                  tb.z, sj, e1, e2, sh.gf[j], sh.el[j], wv, T, expcte);
      cells.add(t, is, s_red + ll * ncell, niso);
    }
  }
  cells.flush(s_red, sh.scr + warp * 32 * 4, true, ll, ncell, niso);
  __syncthreads();
  flush_cells(s_red, acc, rows, l0, nlay, ncell);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// Pointers are device pointers to contiguous tensors: line tiles
// (ntiles, lmax) wavn/elow/gf f32, iso int32, mask bool; tiles (ntiles,)
// int32, the global tile of each row (null: row i is tile i); rows
// (nrows,) int32, the layers computed (null: layers 0 .. nrows-1); temps
// and kmax (nl,); the isotope tables (nl, niso) f32; out (nl, n_coarse)
// f32, of which the launch writes (or with accumulate, adds to) the rows'
// and tiles' block.  wfn selects K: 0 w4 (near tiles), 1 r2 (stride-1
// shells; the planner never tags one asym2).  stats, if not
// null, is (3,) uint64 and gets the (layer, line) chains computed, the
// live (layer, tile, line) entries and the (layer, bin, line) pairs
// evaluated added to it.
extern "C" int line_tile_extinction(
    const void* wavn, const void* elow, const void* gf, const void* iso,
    const void* mask, const void* tiles, const void* rows,
    const void* temps, const void* alphal, const void* alphad_f,
    const void* coef0, const void* densm, const void* kmax, void* out,
    void* stats, int nrows, int ntiles, int lmax, int niso, int tw,
    int n_coarse, int accumulate, int bins_first, int wfn, float wn_i,
    float dwn, float ethresh, float nwidth, float neg_expcte, void* stream) {
  if (nrows <= 0 || ntiles <= 0 || lmax <= 0 || tw <= 0 || tw > MAX_TW ||
      wfn < 0 || wfn > 1)
    return (int)cudaErrorInvalidValue;
  int lb = NT / tw;
  if (lb < 1) lb = 1;
  if (lb > MAX_LB) lb = MAX_LB;
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
                  (unsigned long long*)stats, nrows, lmax, niso, tw, lb,
                  n_coarse, accumulate, bins_first, wn_i, dwn, ethresh,
                  nwidth, neg_expcte);
  };
  if (wfn == 0) return go(&launch_line_tile<0>);
  return go(&launch_line_tile<1>);
}

// kmax (nl,) f32 must hold its floor (-inf, or 0 as the banded path's
// scan starts) on entry; it gets the max over the line
// list (wavn, elow, gf f32, iso int32, each (nlines,)) of k0 at the layer's
// temperature temps (nl,) and strength coefficient coef0 (nl, niso),
// niso <= 64.
extern "C" int layer_kmax(const void* wavn, const void* elow, const void* gf,
                          const void* iso, const void* temps,
                          const void* coef0, void* kmax, int nlines, int nl,
                          int niso, float neg_expcte, void* stream) {
  if (nlines <= 0 || nl <= 0 || niso <= 0 || niso > KM_MAX_ISO)
    return (int)cudaErrorInvalidValue;
  // A whole number of waves: the resident blocks of all SMs, shared by
  // the layer blocks.
  static int waves = 0;
  if (!waves) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, layer_kmax_kernel, KM_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    waves = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int ny = (nl + KM_LAYERS - 1) / KM_LAYERS;
  int bx = waves / ny;
  const int need = (nlines + KM_THREADS - 1) / KM_THREADS;
  if (bx > need) bx = need;
  if (bx < 1) bx = 1;
  layer_kmax_kernel<<<dim3(bx, ny), KM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)wavn, (const float*)elow, (const float*)gf,
      (const int*)iso, (const float*)temps, (const float*)coef0,
      (float*)kmax, nlines, nl, niso, neg_expcte);
  return (int)cudaGetLastError();
}

// The backward of the line-tile launches of one band (or of the unbanded
// plan's one launch), in one launch: nclass tile classes, each as
// line_tile_extinction takes it, given by the HOST arrays ptrs (nclass x
// 6: wavn, elow, gf, iso, mask, tiles, device pointers; tiles may be
// null) and ints (nclass x 4: ntiles, lmax, tw <= 512, wfn 0 w4 or 1
// r2); the same rows, temps, tables, kmax, n_coarse and bins_first for
// all.  g (nl, n_coarse) f32 is the cotangent of the output; acc (nl, 1 +
// 4 niso) f64 gets, per layer, the cotangents of temps, then per isotope
// of coef0, densm, alphal and alphad_f added (float64 atomics).
// niso <= 64, nclass <= 16.
extern "C" int line_tile_backward(
    const long long* ptrs, const int* ints, int nclass, const void* rows,
    const void* temps, const void* alphal, const void* alphad_f,
    const void* coef0, const void* densm, const void* kmax, const void* g,
    void* acc, int nrows, int niso, int n_coarse, int bins_first,
    float wn_i, float dwn, float ethresh, float nwidth, float neg_expcte,
    void* stream) {
  if (nrows <= 0 || nclass <= 0 || nclass > MAX_CLASSES || niso <= 0 ||
      niso > 64)
    return (int)cudaErrorInvalidValue;
  LineClasses cls;
  cls.n = nclass;
  int nblk = 0, tw_max = 0;
  for (int i = 0; i < nclass; ++i) {
    LineClass& c = cls.c[i];
    const long long* p = ptrs + 6 * i;
    c.wavn = (const float*)p[0];
    c.elow = (const float*)p[1];
    c.gf = (const float*)p[2];
    c.iso = (const int*)p[3];
    c.mask = (const unsigned char*)p[4];
    c.tiles = (const int*)p[5];
    c.ntiles = ints[4 * i];
    c.lmax = ints[4 * i + 1];
    c.tw = ints[4 * i + 2];
    c.wfn = ints[4 * i + 3];
    if (c.ntiles <= 0 || c.lmax <= 0 || c.tw <= 0 || c.tw > MAX_TW ||
        c.wfn < 0 || c.wfn > 1 || !c.wavn || !c.elow || !c.gf || !c.iso ||
        !c.mask)
      return (int)cudaErrorInvalidValue;
    c.blk0 = nblk;
    nblk += c.ntiles;
    if (c.tw > tw_max) tw_max = c.tw;
  }
  // Layers per block: all the band's layers, as many as BWD_MAX_LB and
  // 24 KB of staging allow (three blocks on an SM), halved while the grid
  // has fewer than 1024 blocks.
  const size_t per_layer = (1 + 4 * niso) * sizeof(double) +
                           niso * sizeof(float4) + tw_max * sizeof(float) +
                           2 * sizeof(float);
  const int fit = (int)((24 << 10) / per_layer);
  int lb = fit < BWD_MAX_LB ? fit : BWD_MAX_LB;
  if (lb > nrows) lb = nrows;
  while (lb > 1 && (long long)nblk * ((nrows + lb - 1) / lb) < 1024)
    lb = (lb + 1) / 2;
  const int nlb = (nrows + lb - 1) / lb;
  lb = (nrows + nlb - 1) / nlb;           // balance the ragged layer block
  const size_t smem = BWD_FIXED + lb * per_layer;
  cudaError_t err = cudaFuncSetAttribute(
      line_tile_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  line_tile_bwd_kernel<<<dim3(nblk, nlb), BT, smem, (cudaStream_t)stream>>>(
      cls, (const int*)rows, (const float*)temps, (const float*)alphal,
      (const float*)alphad_f, (const float*)coef0, (const float*)densm,
      (const float*)kmax, (const float*)g, (double*)acc, nrows, lb, tw_max,
      niso, n_coarse, bins_first, wn_i, dwn, ethresh, nwidth, neg_expcte);
  return (int)cudaGetLastError();
}
