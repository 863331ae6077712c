// K3 for Hopper: the fused batched AC frequency sweep.
//
// Replaces the TPU kernel circuitsimulator_tpu/ops/pallas_ac.py:_ac_kernel
// (launched by ac_sweep_pallas).  For every (lane b, frequency f) it forms
// A = G[b] + j w_f B1[b] and solves A x = br[b] + j bi[b], the contract of
// circuitsimulator_tpu_torch/ops/ac_sweep.py:
//   - complex Gaussian elimination; the pivot is the FIRST row of the
//     largest |a|^2 = re^2 + im^2 among the rows i >= k of column k;
//   - ok &= (column maximum >= pivot_floor^2); a NaN maximum fails it;
//   - factors f = a / pivot through den = |pivot|^2, a zero den replaced
//     by 1;
//   - back substitution zeroes x_j where |d_j|^2 < pivot_floor^2;
//   - a system whose ok failed is written as zeros.
//
// What bounds it on the H100: not bytes (G and B1 are read once per lane
// and x written once: 64 MB at B = 4096, F = 64, N = 31 in f32, 0.02 ms)
// and not the arithmetic's peak (about 8N^3/3 flops a system, 0.35 ms at
// that shape), but the elimination's chain: N dependent columns, each an
// arg-max across the rows, the pivot row's broadcast, a complex division
// and the row update.  Its cost is instruction issue and the broadcast's
// traffic: about N^2 pivot-row values a system reach every row of it.
//
// Design (N <= 32): a team of threads per (lane, frequency) system at
// capacity CAP = 8, 16 or 32, the smallest that holds N.  Each thread owns
// ROWS rows: two at CAP = 8 and 16 (a team of 4 or 8 threads, so a warp
// serves 8 or 4 systems of the small decks, N = 5-10, and PR 3's
// warp-per-system kernel left most lanes idle there), one at CAP = 32
// (two rows would take 160 registers); ops/cuda_ac.plan picks the
// capacity, and with it the rows.
//   - A block serves consecutive frequencies of one lane.  It stages the
//     lane's G and B1 once in shared memory by coalesced asynchronous
//     copies, all in flight at once (rows of odd stride, so a team reading
//     one column per thread hits distinct banks); each thread forms its
//     rows of A(w) = G + j (w B1) (w B1 rounded once, as the plain version)
//     in registers, ar[ROWS][CAP] and ai[ROWS][CAP], beside their entries
//     of b.
//   - The loop over columns runs at run time; every row shifts its
//     registers down one place per column, so ar[r][0] is always the
//     current column and every register index is a compile-time constant
//     (no local memory, one column of code).
//   - Pivoting moves no data.  Each row keeps pos, the position it holds
//     after the swaps so far.  The pivot is the arg-max of |a|^2 over the
//     rows with pos >= k in a total order (a NaN first, then the larger
//     value, then the smaller position), which is the first-index rule of
//     a sequential strict scan: a thread takes the better of its rows, then
//     a warp reduces integer keys with redux.sync, a team of 4 or 8 with a
//     shuffle butterfly.  The swap exchanges two pos values.  |a|^2 is
//     rounded as the plain version rounds it (two products, one sum, no
//     contraction), and the same expression gives the diagonal's floor
//     test.
//   - The pivot row reaches the team by __shfl_sync of width CAP / ROWS
//     (one shuffle serves every system of the warp; the source thread
//     selects which of its rows it sends).  A write of the row to shared
//     memory with 16-byte broadcast reads measured slower at every
//     main-path shape on the H100 (PERF.md).
//   - Gauss-Jordan, not LU and back substitution: every row but the pivot
//     (those above it too) takes its factor f = a conj(pivot) / |pivot|^2,
//     by one IEEE reciprocal of |pivot|^2 a column (the plain version
//     divides twice: a rounding-level difference), and updates its
//     entries and its b with explicit fmas.
//     The warp issues the same instructions either way (the update is as
//     long as the pivot row), so the rows above cost no issue slot, and
//     there is no back substitution: the row at position j ends as
//     d_j x_j = b_j and writes x_j itself.  The fail masks are those of
//     the contract: a diagonal is the pivot of its column, |d_j|^2 is the
//     column maximum bit for bit, so a zeroed x_j only occurs in a system
//     whose ok already failed.  Values agree with the plain version to
//     rounding.
//   - Blocks are whole warps; every team of a warp runs the same loop (a
//     team past the last frequency idles along), so the warp-wide
//     intrinsics take the full mask.
//
// Design (33 <= N <= 64, and any N under ops/cuda_ac.plan(team=64)): PR
// 3's kernel, the wide route: one warp per system, its complex matrix in
// shared memory as a real and an imaginary plane, lane j working on
// column j, back substitution by shuffle reductions.
//
// No tensor cores: each column's pivot depends on the previous column's
// update, N <= 64 leaves no panel worth a wgmma tile, and TF32 is banned on
// every solve.  Compiled without fast math; multiply-adds are explicit
// fmas in the team kernel (nvcc contracts a*b + c in the wide one), so the
// results agree with the plain PyTorch version to rounding, not bitwise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned ALL = 0xffffffffu;
constexpr int MAXN = 64;

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

// |a|^2 = re^2 + im^2 rounded as the plain version rounds it: two
// products and a sum, never contracted into an fma
__device__ __forceinline__ float mag2(float r, float i) {
  return __fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i));
}
__device__ __forceinline__ double mag2(double r, double i) {
  return __dadd_rn(__dmul_rn(r, r), __dmul_rn(i, i));
}

// true when candidate (v, p) beats (w, q): a NaN beats a number, then the
// larger value wins, then the smaller position
template <typename T>
__device__ __forceinline__ bool beats(T v, int p, T w, int q) {
  const bool vn = v != v, wn = w != w;
  if (vn != wn) return vn;
  if (!vn && v != w) return v > w;
  return p < q;
}

// keys whose unsigned order is beats()'s order on m >= 0: every NaN the
// largest key; a double in two words, high first
__device__ __forceinline__ unsigned mag_key(float m) {
  return m != m ? 0xffffffffu : __float_as_uint(m) & 0x7fffffffu;
}
__device__ __forceinline__ unsigned mag_key_hi(double m) {
  return m != m ? 0xffffffffu
                : (unsigned)((unsigned long long)__double_as_longlong(m) >> 32)
                      & 0x7fffffffu;
}
__device__ __forceinline__ unsigned mag_key_lo(double m) {
  return m != m ? 0xffffffffu : (unsigned)__double_as_longlong(m);
}

// column k's pivot over a team of TS threads: among the candidates (cand,
// m = |a|^2, pos) the NaN first, then the largest m, then the smallest
// pos; every thread of the team gets (v, p) = (m, pos) of the winner.  A
// full warp reduces with redux.sync: the largest key, then the smallest
// pos among the threads that hold it (a non-candidate holds key 0 and pos
// MAXN, so it loses every tie); a team of 4 or 8 with a shuffle butterfly.
template <int TS>
__device__ __forceinline__ void team_argmax(bool cand, float m, int pos,
                                            float& v, int& p) {
  if constexpr (TS == 32) {
    const unsigned key = cand ? mag_key(m) : 0u;
    const unsigned kmax = __reduce_max_sync(ALL, key);
    p = (int)__reduce_min_sync(
        ALL, cand && key == kmax ? (unsigned)pos : (unsigned)MAXN);
    v = kmax == 0xffffffffu ? __uint_as_float(0x7fffffffu)
                            : __uint_as_float(kmax);
  } else {
    v = cand ? m : -1.0f;
    p = cand ? pos : MAXN;
#pragma unroll
    for (int off = TS / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(ALL, v, off, TS);
      const int op = __shfl_xor_sync(ALL, p, off, TS);
      if (beats(ov, op, v, p)) {
        v = ov;
        p = op;
      }
    }
  }
}
template <int TS>
__device__ __forceinline__ void team_argmax(bool cand, double m, int pos,
                                            double& v, int& p) {
  if constexpr (TS == 32) {
    const unsigned hi = cand ? mag_key_hi(m) : 0u;
    const unsigned lo = cand ? mag_key_lo(m) : 0u;
    const unsigned hmax = __reduce_max_sync(ALL, hi);
    const unsigned lmax = __reduce_max_sync(ALL, hi == hmax ? lo : 0u);
    p = (int)__reduce_min_sync(
        ALL, cand && hi == hmax && lo == lmax ? (unsigned)pos
                                               : (unsigned)MAXN);
    v = hmax == 0xffffffffu
            ? __longlong_as_double(0x7fffffffffffffffLL)
            : __longlong_as_double(
                  (long long)(((unsigned long long)hmax << 32) | lmax));
  } else {
    v = cand ? m : -1.0;
    p = cand ? pos : MAXN;
#pragma unroll
    for (int off = TS / 2; off > 0; off >>= 1) {
      const double ov = __shfl_xor_sync(ALL, v, off, TS);
      const int op = __shfl_xor_sync(ALL, p, off, TS);
      if (beats(ov, op, v, p)) {
        v = ov;
        p = op;
      }
    }
  }
}

// cp.async of one element, global -> shared (4 or 8 bytes)
__device__ __forceinline__ void cp_async_el(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async_el(double* s, const double* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sa),
               "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// (ar, ai) -= (fr + j fi) (qr + j qi), two explicit fmas a component
template <typename T>
__device__ __forceinline__ void cmsub(T& ar, T& ai, T sr, T si, T fr, T fi,
                                      T qr, T qi) {
  ar = fmadd(-fr, qr, fmadd(fi, qi, sr));
  ai = fmadd(-fr, qi, fmadd(-fi, qr, si));
}

// the lane's staged G and B1: N rows of odd stride each, in bytes rounded
// up to 16
__host__ __device__ inline int row_stride(int n) { return n | 1; }
template <typename T>
__host__ __device__ inline long long stage_bytes_needed(int n) {
  return (2LL * n * row_stride(n) * (long long)sizeof(T) + 15) / 16 * 16;
}

// a lane's G and B1 into shared memory at row stride ld by the block's
// asynchronous copies, all in flight at once (waited for by the caller)
template <typename T>
__device__ __forceinline__ void stage_lane(T* sG, T* sB1, const T* G,
                                           const T* B1, long long lane,
                                           int n, int ld) {
  const long long nn = (long long)n * n;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    cp_async_el(sG + i * ld + j, G + lane * nn + e);
    cp_async_el(sB1 + i * ld + j, B1 + lane * nn + e);
  }
}

// row i of A(w) = G + j (w B1) from the staged lane into registers (w B1
// rounded once, as the plain version), zeros past N or for an idle row
template <typename T, int CAP>
__device__ __forceinline__ void form_row(T (&ar)[CAP], T (&ai)[CAP],
                                         const T* sG, const T* sB1, int i,
                                         int ld, int n, T w, bool valid) {
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    ar[j] = T(0);
    ai[j] = T(0);
    if (valid && j < n) {
      ar[j] = sG[i * ld + j];
      ai[j] = w * sB1[i * ld + j];
    }
  }
}

// x = b / d for the row whose diagonal is d, zero where |d|^2 (the same
// mag2 as the pivot test) is below the floor or the system failed
template <typename T>
__device__ __forceinline__ void store_x(T* xr, T* xi, long long o, T vr,
                                        T vi, T dr, T di, bool ok,
                                        T floor2) {
  const T den = mag2(dr, di);
  const T safe = den != T(0) ? den : T(1);
  const bool good = ok && den >= floor2;
  xr[o] = good ? fmadd(vr, dr, vi * di) / safe : T(0);
  xi[o] = good ? fmadd(vi, dr, -(vr * di)) / safe : T(0);
}

// entry j of the pivot row on the thread that holds it: the row r with
// piv[r] (row 0 on every other thread, whose value no one reads)
template <typename T, int ROWS, int CAP>
__device__ __forceinline__ T pick(const bool (&piv)[ROWS],
                                  const T (&a)[ROWS][CAP], int j) {
  T v = a[0][j];
#pragma unroll
  for (int r = 1; r < ROWS; ++r)
    if (piv[r]) v = a[r][j];
  return v;
}
template <typename T, int ROWS>
__device__ __forceinline__ T pick(const bool (&piv)[ROWS],
                                  const T (&a)[ROWS]) {
  T v = a[0];
#pragma unroll
  for (int r = 1; r < ROWS; ++r)
    if (piv[r]) v = a[r];
  return v;
}

// N <= 32: a team of TS = CAP / ROWS threads per system, thread t owning
// rows t + r TS (r < ROWS) in registers, Gauss-Jordan with the pivot row
// broadcast by shuffles of width TS (one shuffle serves 32 / TS systems of
// a warp; the source thread selects which of its rows it sends).  Block =
// `teams` teams over frequencies chunk * teams + team of lane
// blockIdx.x / chunks.
template <typename T, int CAP, int ROWS>
__global__ void __launch_bounds__(256)
ac_team_kernel(const T* __restrict__ G, const T* __restrict__ B1,
               const T* __restrict__ br, const T* __restrict__ bi,
               const T* __restrict__ om, T* __restrict__ xr,
               T* __restrict__ xi, int F, int n, int chunks, T floor2) {
  constexpr int TS = CAP / ROWS;
  static_assert(CAP <= 32 && TS * ROWS == CAP && TS >= 4,
                "a team is one warp at most; N > 32 is ac_wide_kernel");
  constexpr unsigned team_bits = TS == 32 ? ALL : (1u << TS) - 1u;
  extern __shared__ __align__(16) unsigned char smem[];
  const int teams = blockDim.x / TS;
  const int t = threadIdx.x % TS;
  const int team = threadIdx.x / TS;
  const long long lane = blockIdx.x / chunks;
  const int f = (blockIdx.x % chunks) * teams + team;
  const int ld = row_stride(n);
  T* sG = reinterpret_cast<T*>(smem);
  T* sB1 = sG + n * ld;

  stage_lane(sG, sB1, G, B1, lane, n, ld);
  const T w = f < F ? om[f] : T(0);
  bool valid[ROWS];
  T vr[ROWS], vi[ROWS];          // each row's entry of b
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    valid[r] = f < F && t + r * TS < n;
    vr[r] = valid[r] ? br[lane * n + t + r * TS] : T(0);
    vi[r] = valid[r] ? bi[lane * n + t + r * TS] : T(0);
  }
  cp_async_wait_all();
  __syncthreads();
  T ar[ROWS][CAP], ai[ROWS][CAP];   // the rows of A(w)
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    form_row(ar[r], ai[r], sG, sB1, t + r * TS, ld, n, w, valid[r]);

  const int team_lane0 = (threadIdx.x & 31) & ~(TS - 1);
  int pos[ROWS];
  T dr[ROWS], di[ROWS];          // each row's diagonal, kept when it pivots
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    pos[r] = t + r * TS;
    dr[r] = di[r] = T(0);
  }
  bool ok = true;
  for (int k = 0; k < n; ++k) {
    // the thread's best candidate (a first one always beats m = -1), then
    // across the team
    bool cand = false;
    T m = T(-1);
    int mp = MAXN;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const T mr = mag2(ar[r][0], ai[r][0]);
      if (valid[r] && pos[r] >= k && (r == 0 || beats(mr, pos[r], m, mp))) {
        cand = true;
        m = mr;
        mp = pos[r];
      }
    }
    T best;
    int p;
    team_argmax<TS>(cand, m, mp, best, p);
    ok = ok && best >= floor2;          // a NaN maximum fails
    bool piv[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      piv[r] = valid[r] && pos[r] == p;
      if (piv[r]) {
        pos[r] = k;
        dr[r] = ar[r][0];
        di[r] = ai[r][0];
      } else if (valid[r] && pos[r] == k) {
        pos[r] = p;
      }
    }
    bool any_piv = false;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) any_piv = any_piv || piv[r];
    const int src =
        __ffs((__ballot_sync(ALL, any_piv) >> team_lane0) & team_bits) - 1;
    const T pr = __shfl_sync(ALL, pick(piv, ar, 0), src, TS);
    const T pi = __shfl_sync(ALL, pick(piv, ai, 0), src, TS);
    const T pbr = __shfl_sync(ALL, pick(piv, vr), src, TS);
    const T pbi = __shfl_sync(ALL, pick(piv, vi), src, TS);
    // den = |pivot|^2 is the column maximum: the pivot's own mag2.  Every
    // row but the pivot, above it too, eliminates column k with
    // f = a conj(pivot) / den (one reciprocal of den a column); the pivot
    // row (f = 0) only shifts
    const T rden = T(1) / (best != T(0) ? best : T(1));
    T fr[ROWS], fi[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool elim = valid[r] && !piv[r];
      fr[r] = elim ? fmadd(ar[r][0], pr, ai[r][0] * pi) * rden : T(0);
      fi[r] = elim ? fmadd(ai[r][0], pr, -(ar[r][0] * pi)) * rden : T(0);
      cmsub(vr[r], vi[r], vr[r], vi[r], fr[r], fi[r], pbr, pbi);
    }
    // entries in pairs, one test of the row's end a pair: an entry past it
    // (j = n - k) only writes the register that has just gone dead
#pragma unroll
    for (int j = 1; j < CAP; j += 2) {
      if (j >= n - k) break;
      {
        const T qr = __shfl_sync(ALL, pick(piv, ar, j), src, TS);
        const T qi = __shfl_sync(ALL, pick(piv, ai, j), src, TS);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          cmsub(ar[r][j - 1], ai[r][j - 1], ar[r][j], ai[r][j], fr[r], fi[r],
                qr, qi);
      }
      if (j + 1 < CAP) {
        const T qr = __shfl_sync(ALL, pick(piv, ar, j + 1), src, TS);
        const T qi = __shfl_sync(ALL, pick(piv, ai, j + 1), src, TS);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          cmsub(ar[r][j], ai[r][j], ar[r][j + 1], ai[r][j + 1], fr[r], fi[r],
                qr, qi);
      }
    }
  }

  // the row at position pos holds d x_pos = b
  const long long o = (lane * F + f) * n;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (valid[r])
      store_x(xr, xi, o + pos[r], vr[r], vi[r], dr[r], di[r], ok, floor2);
}

// elements of one warp's shared-memory slice on the wide route: Ar, Ai
// (n x ld), rr, ri (n)
__host__ __device__ inline long long warp_elems(int n) {
  return 2LL * n * row_stride(n) + 2LL * n;
}

// The wide route (PR 3's kernel): one warp per (lane, frequency) system,
// its complex matrix in shared memory as a real and an imaginary plane
// with row stride ld = N rounded up to an odd number, so that 32 lanes
// reading one column hit 32 banks.  Per column k: the pivot search (lane i
// reads rows i and i + 32, a shuffle arg-max, ties to the lower row), the
// row swap (lane j swaps column j), the factors (lane i for its rows
// i > k), the update (lane j updates column j > k of every row i > k);
// then back substitution with lane m holding x_m and each row sum a
// shuffle reduction.
template <typename T>
__global__ void __launch_bounds__(128)
ac_wide_kernel(const T* __restrict__ G, const T* __restrict__ B1,
               const T* __restrict__ br, const T* __restrict__ bi,
               const T* __restrict__ om, T* __restrict__ xr,
               T* __restrict__ xi, int F, int n, T floor2,
               long long n_sys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int ld = row_stride(n);
  T* Ar = reinterpret_cast<T*>(smem_raw) + warp * warp_elems(n);
  T* Ai = Ar + n * ld;
  T* Rr = Ai + n * ld;
  T* Ri = Rr + n;

  for (long long s = (long long)blockIdx.x * wpb + warp; s < n_sys;
       s += (long long)gridDim.x * wpb) {
    const long long b = s / F;
    const T w = om[s - b * F];
    const T* Gb = G + b * n * n;
    const T* B1b = B1 + b * n * n;
    for (int e = lane; e < n * n; e += 32) {
      const int i = e / n, j = e - i * n;
      Ar[i * ld + j] = Gb[e];
      Ai[i * ld + j] = w * B1b[e];
    }
    for (int i = lane; i < n; i += 32) {
      Rr[i] = br[b * n + i];
      Ri[i] = bi[b * n + i];
    }
    __syncwarp();

    bool ok = true;
    for (int k = 0; k < n; ++k) {
      // pivot: first largest |a|^2 of rows i >= k (strict > within a lane,
      // rows ascending; lower row on ties across lanes)
      T best = T(-1);
      int p = k;
      bool nan_seen = false;
      for (int i = k + lane; i < n; i += 32) {
        const T cr = Ar[i * ld + k], ci = Ai[i * ld + k];
        const T m = cr * cr + ci * ci;
        if (m != m) {
          nan_seen = true;
        } else if (m > best) {
          best = m;
          p = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T ob = __shfl_xor_sync(ALL, best, off);
        const int op = __shfl_xor_sync(ALL, p, off);
        if (ob > best || (ob == best && op < p)) {
          best = ob;
          p = op;
        }
      }
      if (__any_sync(ALL, nan_seen)) {
        ok = false;       // a NaN column maximum fails the floor
        p = k;
      } else {
        ok = ok && best >= floor2;
      }
      if (p != k) {       // warp-uniform
        for (int j = k + lane; j < n; j += 32) {
          T t = Ar[k * ld + j];
          Ar[k * ld + j] = Ar[p * ld + j];
          Ar[p * ld + j] = t;
          t = Ai[k * ld + j];
          Ai[k * ld + j] = Ai[p * ld + j];
          Ai[p * ld + j] = t;
        }
        if (lane == 0) {
          T t = Rr[k];
          Rr[k] = Rr[p];
          Rr[p] = t;
          t = Ri[k];
          Ri[k] = Ri[p];
          Ri[p] = t;
        }
        __syncwarp();
      }
      const T pr = Ar[k * ld + k], pi = Ai[k * ld + k];
      const T den = pr * pr + pi * pi;
      const T safe = den != T(0) ? den : T(1);
      const T rkr = Rr[k], rki = Ri[k];
      for (int i = k + 1 + lane; i < n; i += 32) {
        const T ar = Ar[i * ld + k], ai = Ai[i * ld + k];
        const T fr = (ar * pr + ai * pi) / safe;
        const T fi = (ai * pr - ar * pi) / safe;
        Ar[i * ld + k] = fr;
        Ai[i * ld + k] = fi;
        Rr[i] -= fr * rkr - fi * rki;
        Ri[i] -= fr * rki + fi * rkr;
      }
      __syncwarp();
      for (int j = k + 1 + lane; j < n; j += 32) {
        const T akr = Ar[k * ld + j], aki = Ai[k * ld + j];
        for (int i = k + 1; i < n; ++i) {
          const T fr = Ar[i * ld + k], fi = Ai[i * ld + k];
          Ar[i * ld + j] -= fr * akr - fi * aki;
          Ai[i * ld + j] -= fr * aki + fi * akr;
        }
      }
      __syncwarp();
    }

    // back substitution: lane m holds x_m in (x0r, x0i) and x_{m+32} in
    // (x1r, x1i)
    T x0r = T(0), x0i = T(0), x1r = T(0), x1i = T(0);
    const int m1 = lane + 32;
    for (int j = n - 1; j >= 0; --j) {
      T sr = T(0), si = T(0);
      if (lane > j && lane < n) {
        const T ar = Ar[j * ld + lane], ai = Ai[j * ld + lane];
        sr = ar * x0r - ai * x0i;
        si = ar * x0i + ai * x0r;
      }
      if (m1 > j && m1 < n) {
        const T ar = Ar[j * ld + m1], ai = Ai[j * ld + m1];
        sr += ar * x1r - ai * x1i;
        si += ar * x1i + ai * x1r;
      }
      for (int off = 16; off > 0; off >>= 1) {
        sr += __shfl_xor_sync(ALL, sr, off);
        si += __shfl_xor_sync(ALL, si, off);
      }
      const T dr = Ar[j * ld + j], di = Ai[j * ld + j];
      const T den = dr * dr + di * di;
      const T safe = den != T(0) ? den : T(1);
      const T rr = Rr[j] - sr, ri = Ri[j] - si;
      const bool good = den >= floor2;
      const T vr = good ? (rr * dr + ri * di) / safe : T(0);
      const T vi = good ? (ri * dr - rr * di) / safe : T(0);
      if (lane == j) {
        x0r = vr;
        x0i = vi;
      }
      if (m1 == j) {
        x1r = vr;
        x1i = vi;
      }
    }
    T* xro = xr + s * n;
    T* xio = xi + s * n;
    if (lane < n) {
      xro[lane] = ok ? x0r : T(0);
      xio[lane] = ok ? x0i : T(0);
    }
    if (m1 < n) {
      xro[m1] = ok ? x1r : T(0);
      xio[m1] = ok ? x1i : T(0);
    }
    __syncwarp();     // the next system overwrites this warp's slice
  }
}

struct Args {
  const void *G, *B1, *br, *bi, *om;
  void *xr, *xi;
  int B, F, n;
  double floor2;
  cudaStream_t stream;
};

template <typename K>
cudaError_t prepare(K kernel, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// the rows a thread of the team kernel at each capacity: two where a team
// of 4 or 8 threads serves N <= 16 (a shuffle then serves 8 or 4 systems
// of a warp), one at N <= 32, where two rows take 160 registers
template <int CAP>
constexpr int rows_at() { return CAP < 32 ? 2 : 1; }

template <typename T, int CAP>
const void* team_kernel() {
  return (const void*)ac_team_kernel<T, CAP, rows_at<CAP>()>;
}

template <typename T, int CAP>
int launch_team(const Args& a, int rows, int teams, int chunks, int smem) {
  constexpr int ROWS = rows_at<CAP>();
  constexpr int TS = CAP / ROWS;
  if (a.n > CAP || rows != ROWS || teams < 1 || teams * TS > 256 ||
      teams * TS % 32 || chunks < 1 || (long long)chunks * teams < a.F ||
      smem < stage_bytes_needed<T>(a.n) || smem % 16 ||
      (long long)a.B * chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto kernel = ac_team_kernel<T, CAP, ROWS>;
  const cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)((long long)a.B * chunks), teams * TS, (size_t)smem,
           a.stream>>>((const T*)a.G, (const T*)a.B1, (const T*)a.br,
                       (const T*)a.bi, (const T*)a.om, (T*)a.xr, (T*)a.xi,
                       a.F, a.n, chunks, (T)a.floor2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(const Args& a, int rows, int warps, int smem) {
  if (rows != 1 || warps < 1 || warps > 4 ||
      smem < warps * warp_elems(a.n) * (long long)sizeof(T))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = prepare(ac_wide_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_sys = (long long)a.B * a.F;
  long long blocks = (n_sys + warps - 1) / warps;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;   // grid-stride beyond
  ac_wide_kernel<T><<<(unsigned)blocks, 32 * warps, (size_t)smem, a.stream>>>(
      (const T*)a.G, (const T*)a.B1, (const T*)a.br, (const T*)a.bi,
      (const T*)a.om, (T*)a.xr, (T*)a.xi, a.F, a.n, (T)a.floor2, n_sys);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int cap, int rows, int spb, int chunks, int smem) {
  if (a.B <= 0 || a.F <= 0) return 0;
  if (a.n <= 0 || a.n > MAXN || a.n > cap) return (int)cudaErrorInvalidValue;
  switch (cap) {
    case 8:
      return launch_team<T, 8>(a, rows, spb, chunks, smem);
    case 16:
      return launch_team<T, 16>(a, rows, spb, chunks, smem);
    case 32:
      return launch_team<T, 32>(a, rows, spb, chunks, smem);
    case 64:
      return launch_wide<T>(a, rows, spb, smem);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
const void* kernel_at(int cap) {
  switch (cap) {
    case 8:
      return team_kernel<T, 8>();
    case 16:
      return team_kernel<T, 16>();
    case 32:
      return team_kernel<T, 32>();
    case 64:
      return (const void*)ac_wide_kernel<T>;
    default:
      return nullptr;
  }
}

}  // namespace

// G, B1 (B, N, N), br, bi (B, N), om (F,), xr, xi (B, F, N), contiguous;
// the plan (team capacity, rows a thread, systems a block, frequency chunks
// per lane, the block's dynamic shared bytes) comes from ops/cuda_ac.py.
// Returns a cudaError_t.
extern "C" int csim_ac_sweep_f32(const void* G, const void* B1,
                                 const void* br, const void* bi,
                                 const void* om, void* xr, void* xi, int B,
                                 int F, int n, int cap, int rows, int spb,
                                 int chunks, int smem, double pivot_floor,
                                 void* stream) {
  const Args a{G, B1, br, bi, om, xr, xi, B, F, n, pivot_floor * pivot_floor,
               (cudaStream_t)stream};
  return launch<float>(a, cap, rows, spb, chunks, smem);
}

extern "C" int csim_ac_sweep_f64(const void* G, const void* B1,
                                 const void* br, const void* bi,
                                 const void* om, void* xr, void* xi, int B,
                                 int F, int n, int cap, int rows, int spb,
                                 int chunks, int smem, double pivot_floor,
                                 void* stream) {
  const Args a{G, B1, br, bi, om, xr, xi, B, F, n, pivot_floor * pivot_floor,
               (cudaStream_t)stream};
  return launch<double>(a, cap, rows, spb, chunks, smem);
}

// registers and local (stack) bytes per thread of the kernel a launch of
// this type and team capacity takes (64: the wide route); 0 on success
extern "C" int csim_ac_sweep_attrs(int f64, int cap, int* regs,
                                   int* local_bytes) {
  const void* k = f64 ? kernel_at<double>(cap) : kernel_at<float>(cap);
  if (!k) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes at;
  const cudaError_t e = cudaFuncGetAttributes(&at, k);
  if (e != cudaSuccess) return (int)e;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  return 0;
}
