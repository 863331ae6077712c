// K2 for Hopper: B independent dense N x N solves with partial pivoting,
// R right-hand sides each, N <= 64.
//
// Replaces the TPU kernel circuitsimulator_tpu/ops/pallas_lu.py:_lu_kernel
// (launched by lu_solve_pallas_batched).  It computes what the reference
// solver computes (circuitsimulator_tpu/ops/lu.py:_lu_solve_unrolled):
//   - pivot on the FIRST index of the largest |A[i][k]|, i >= k (strict >
//     scan; a NaN counts as largest, like argmax);
//   - swap rows, eliminate with f = A[i][k] / pivot (a zero pivot is
//     replaced by 1);
//   - back substitution; |d| < pivot_floor gives x_j = 0;
//   - if the smallest column maximum is below pivot_floor the lane returns
//     zeros (a NaN minimum is not below it, so NaN propagates).
// R right-hand sides share one factorisation; each column takes the same
// rounded operations as a single-RHS solve, so it equals one bit for bit.
//
// Design: a team of threads per system, several systems to a block.  The
// capacity CAP (8, 16, 32 or 64, the smallest that holds N) is also the
// team's size: 8 or 16 threads share a warp with other systems, 32 is one
// warp, 64 two warps.  Thread i owns row i.
//   - A (B, N, N) and b (B, N, R) are read where the caller keeps them, one
//     contiguous block per system, with coalesced loads into shared memory;
//     neither is written.  x (B, N, R) is written once.
//   - CAP <= 32 (lu_solve_kernel): each thread holds its row in registers,
//     r[CAP].  The loop over columns runs at run time; a row still to be
//     eliminated shifts its registers down one place per column, so r[0]
//     is always the current column and every register index is a
//     compile-time constant (no local memory inside any loop, and the code
//     is one column long, not N).
//   - Pivoting moves no data.  Each thread keeps pos, the position its row
//     holds after the swaps so far.  Column k's pivot is the arg-max of
//     |r[0]| over the rows with pos >= k in a total order (a NaN first,
//     then the larger value, then the smaller position), so every thread
//     gets the same winner and the first index wins ties, as in a
//     sequential strict scan: a warp reduces integer keys with redux.sync,
//     a team of 8 or 16 with a shuffle butterfly.  The swap exchanges two
//     pos values.
//   - The pivot row reaches the team by __shfl_sync; each row below it
//     stores its multiplier f (L) in shared memory and updates its
//     entries with fma(-f, pivot[j], r[j]).  The pivot row's registers
//     freeze: they are its row of U, written to shared memory at the end.
//   - R = 1: b rides in registers beside its row, eliminated with it; back
//     substitution runs across the team (the row at position j divides and
//     broadcasts x_j, the rows above add U x_j to their sums).
//   - R > 1: the factors in shared memory (L and U of each row in A's row
//     order, rowat[pos] = the row at position pos); each thread solves
//     whole columns of the right-hand side, forward with L, back with U.
//     The RHS is staged in tiles of at most RT columns, x overwrites its
//     column in the tile, and the tile is copied out in (B, N, R) layout.
//     Every column, whatever R is, takes the same rounded operations (fma
//     and division) on the same operands in the same order as the R = 1
//     path, so a column of an R-column solve equals a single-RHS solve bit
//     for bit.
//   - CAP = 64 (lu_wide_kernel, 33 <= N <= 64, on no main path): the same
//     arithmetic with the rows in shared memory and loops at run time, the
//     two warps' arg-max and the swaps through shared memory (two barriers
//     per column), the right-hand sides always by columns.
//
// What bounds it on the H100: not bytes (B=8192, N=31, f32 moves 32 MB,
// 0.01 ms at 3.35 TB/s) and not arithmetic (0.08 GFLOP).  Each column of
// the elimination is a chain of dependent steps (the arg-max, the pivot's
// broadcast, a division, the row update) of about 150 warp instructions
// at N = 31, half of them the pivot row's shuffles and their fmas: some
// 5k instructions per system, so the kernel is bound by instruction issue
// and the chain's latency, with a warp per system (8192 at B = 8192) in
// flight to overlap the chains.  The host's launch path (about 25 us of
// Python and ctypes) is a large share of a call at B <= 8192.
//
// No tensor cores: each column's pivot depends on the previous column's
// update, N <= 64 leaves no panel worth a wgmma tile, TF32 is banned on
// every solve, and f64 DMMA needs a blocked LU that N = 31 cannot feed.
// Compiled without fast math; every multiply-add is an explicit fma, and
// divisions are IEEE, so results agree with the plain PyTorch version to
// rounding, not bitwise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <typename T>
__device__ __forceinline__ T absval(T v) { return v < T(0) ? -v : v; }

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
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

// x_j of back substitution from b_j, acc = sum U[j][i] x_i (i > j) and
// d = U[j][j]: 0 when |d| < pivot_floor, else (b_j - acc) / d (a zero d
// divides by 1).  acc starts at +0 and b_j - acc is taken last, as the
// plain version takes it, so a zero x_j keeps the reference's sign.
template <typename T>
__device__ __forceinline__ T back_divide(T b, T acc, T d, T pivot_floor) {
  return absval(d) < pivot_floor ? T(0) : (b - acc) / (d != T(0) ? d : T(1));
}

// rows x cols from src (row stride sld) to dst (row stride dld) by a team
// of TEAM threads; one flat coalesced sweep when both are dense
template <int TEAM, typename T>
__device__ __forceinline__ void copy_block(const T* __restrict__ src, int sld,
                                           T* __restrict__ dst, int dld,
                                           int rows, int cols, int t) {
  if (sld == cols && dld == cols) {
    const int n = rows * cols;
    for (int e = t; e < n; e += TEAM) dst[e] = src[e];
  } else {
    for (int i = 0; i < rows; ++i)
      for (int c = t; c < cols; c += TEAM) dst[i * dld + c] = src[i * sld + c];
  }
}

// the arg-max of the candidates (v, p) over each shuffle segment of W
// threads of a whole warp; every thread of a segment gets its winner
template <int W, typename T>
__device__ __forceinline__ void argmax_shfl(T& v, int& p) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, off, W);
    const int op = __shfl_xor_sync(0xffffffffu, p, off, W);
    if (beats(ov, op, v, p)) {
      v = ov;
      p = op;
    }
  }
}

// keys whose unsigned order is beats()'s order on |x|: the sign bit
// cleared, every NaN the largest key; a double in two words, high first
__device__ __forceinline__ unsigned abs_key(float x) {
  return x != x ? 0xffffffffu : __float_as_uint(x) & 0x7fffffffu;
}
__device__ __forceinline__ unsigned abs_key_hi(double x) {
  return x != x ? 0xffffffffu
                : (unsigned)((unsigned long long)__double_as_longlong(x) >> 32)
                      & 0x7fffffffu;
}
__device__ __forceinline__ unsigned abs_key_lo(double x) {
  return x != x ? 0xffffffffu : (unsigned)__double_as_longlong(x);
}

// column k's pivot over a team: among the candidates (cand, |x|, pos) the
// NaN first, then the largest, then the smallest pos; every thread of the
// team gets (v, p) = (|x|, pos) of the winner.  A full warp reduces with
// redux.sync (__reduce_*_sync): the largest key, then the smallest pos
// among the threads that hold it (a non-candidate holds key 0 and pos
// CAP, so it loses every tie); a team of 8 or 16 with a shuffle butterfly.
template <int CAP>
__device__ __forceinline__ void team_argmax(bool cand, float x, int pos,
                                            float& v, int& p) {
  constexpr unsigned mask = 0xffffffffu;
  if constexpr (CAP == 32) {
    const unsigned key = cand ? abs_key(x) : 0u;
    const unsigned kmax = __reduce_max_sync(mask, key);
    p = (int)__reduce_min_sync(
        mask, cand && key == kmax ? (unsigned)pos : (unsigned)CAP);
    v = kmax == 0xffffffffu ? __uint_as_float(0x7fffffffu)
                            : __uint_as_float(kmax);
  } else {
    v = cand ? absval(x) : -1.0f;
    p = cand ? pos : CAP;
    argmax_shfl<CAP>(v, p);
  }
}
template <int CAP>
__device__ __forceinline__ void team_argmax(bool cand, double x, int pos,
                                            double& v, int& p) {
  constexpr unsigned mask = 0xffffffffu;
  if constexpr (CAP == 32) {
    const unsigned hi = cand ? abs_key_hi(x) : 0u;
    const unsigned lo = cand ? abs_key_lo(x) : 0u;
    const unsigned hmax = __reduce_max_sync(mask, hi);
    const unsigned lmax = __reduce_max_sync(mask, hi == hmax ? lo : 0u);
    p = (int)__reduce_min_sync(
        mask, cand && hi == hmax && lo == lmax ? (unsigned)pos
                                                : (unsigned)CAP);
    v = hmax == 0xffffffffu
            ? __longlong_as_double(0x7fffffffffffffffLL)
            : __longlong_as_double(
                  (long long)(((unsigned long long)hmax << 32) | lmax));
  } else {
    v = cand ? absval(x) : -1.0;
    p = cand ? pos : CAP;
    argmax_shfl<CAP>(v, p);
  }
}

// shared memory of one team, in this order: the factors (N rows of CAP + 1
// words, odd, so one row per thread is conflict-free), the RHS tile
// (N x RT), at CAP = 64 the two warps' arg-max values (2 x 2), then rowat
// (CAP ints) and at CAP = 64 the arg-max positions (2 x 2)
template <typename T, int CAP>
__host__ __device__ constexpr long long team_bytes_needed(int N, int RT) {
  return (long long)sizeof(T) * ((long long)N * (CAP + 1) +
                                 (long long)N * RT + (CAP == 64 ? 4 : 0)) +
         4LL * (CAP + (CAP == 64 ? 4 : 0));
}

// The factors of both kernels, in shared memory in A's row order: row r
// holds L left of its final position and U from it on; rowat[pos] is the
// row at position pos.  Solves the tile's columns (N rows in A's order, w
// columns) in place, one column per thread: forward with L (position m
// takes k = 0 .. m-1 in order), back with U (j descending, x_j's sum
// over i = N-1 .. j+1); a failed lane gives 0.
template <int TEAM, typename T>
__device__ __forceinline__ void solve_columns(const T* sLU, int lda,
                                              const int* rowat, T* sB, int w,
                                              int N, int t, T pivot_floor,
                                              bool fail) {
  for (int c = t; c < w; c += TEAM) {
    T* y = sB + c;
    for (int m = 0; m < N; ++m) {
      const int rm = rowat[m];
      const T* lrow = sLU + rm * lda;
      T ym = y[rm * w];
      for (int k = 0; k < m; ++k)
        ym = fmadd(-lrow[k], y[rowat[k] * w], ym);
      y[rm * w] = ym;
    }
    for (int j = N - 1; j >= 0; --j) {
      const T* urow = sLU + rowat[j] * lda;
      T acc = T(0);
      for (int i = N - 1; i > j; --i)
        acc = fmadd(urow[i], y[rowat[i] * w], acc);
      y[rowat[j] * w] = back_divide(y[rowat[j] * w], acc, urow[j],
                                    pivot_floor);
    }
    if (fail)
      for (int m = 0; m < N; ++m) y[m * w] = T(0);
  }
}

// R > 1: the right-hand sides in tiles of at most RT columns, staged with
// coalesced loads, solved in place and copied out in position order
template <int TEAM, typename T, typename Sync>
__device__ __forceinline__ void solve_tiles(const T* __restrict__ Bm,
                                            T* __restrict__ X, long long sys,
                                            int N, int R, int RT,
                                            const T* sLU, int lda,
                                            const int* rowat, T* sB, int t,
                                            T pivot_floor, bool fail,
                                            bool live, Sync sync) {
  const long long base = sys * N * R;
  for (int c0 = 0; c0 < R; c0 += RT) {
    const int w = min(RT, R - c0);
    if (live) copy_block<TEAM>(Bm + base + c0, R, sB, w, N, w, t);
    sync();
    if (live)
      solve_columns<TEAM>(sLU, lda, rowat, sB, w, N, t, pivot_floor, fail);
    sync();
    if (live)
      for (int i = 0; i < N; ++i)
        for (int c = t; c < w; c += TEAM)
          X[base + (long long)i * R + c0 + c] = sB[rowat[i] * w + c];
    sync();
  }
}

// CAP = 8, 16, 32: the rows in registers.  The loop over columns runs at
// run time: each row still to be eliminated shifts its registers down one
// place per column (r[0] is always the current column), so every register
// index is a compile-time constant and the code stays one column long.
// Blocks are whole warps, and every team of a warp runs the same control
// flow (a team past the last system idles along), so the warp-wide
// intrinsics take the full mask; shuffles of width CAP stay in the team.
template <typename T, int CAP>
__global__ void __launch_bounds__(256)
lu_solve_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                T* __restrict__ X, int nsys, int N, int R, int RT,
                int team_bytes, T pivot_floor) {
  static_assert(CAP <= 32, "one warp at most; CAP = 64 is lu_wide_kernel");
  constexpr int LDA = CAP + 1;
  constexpr unsigned ALL = 0xffffffffu;
  constexpr unsigned team_bits = CAP == 32 ? ALL : (1u << (CAP % 32)) - 1u;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x % CAP;
  const int team = threadIdx.x / CAP;
  const long long sys = (long long)blockIdx.x * (blockDim.x / CAP) + team;
  const bool live = sys < nsys;
  if (__all_sync(ALL, !live)) return;
  const int team_lane0 = (threadIdx.x & 31) & ~(CAP - 1);
  // the team-relative lane of the one thread of the team where pred holds
  auto lane_of = [&](bool pred) {
    return __ffs((__ballot_sync(ALL, pred) >> team_lane0) & team_bits) - 1;
  };
  T* sLU = reinterpret_cast<T*>(smem + (size_t)team * team_bytes);
  T* sB = sLU + N * LDA;
  int* rowat = reinterpret_cast<int*>(sB + N * RT);
  T* myrow = sLU + t * LDA;

  if (live) copy_block<CAP>(A + sys * N * N, N, sLU, LDA, N, N, t);
  __syncwarp();
  const bool valid = live && t < N;
  T r[CAP];
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    r[j] = T(0);
    if (valid && j < N) r[j] = myrow[j];
  }
  // one right-hand side rides in registers beside its row
  T bv = T(0);
  if (R == 1 && valid) bv = Bm[sys * N + t];

  int pos = t;
  T minpiv = T(INFINITY);
  for (int k = 0; k < N; ++k) {
    T v;
    int p;
    team_argmax<CAP>(valid && pos >= k, r[0], pos, v, p);
    // sticky NaN, like jnp.minimum
    if (v < minpiv || v != v) minpiv = v;
    const bool is_piv = valid && pos == p;
    if (is_piv) pos = k;
    else if (valid && pos == k) pos = p;
    const bool elim = valid && pos > k;
    const int src = lane_of(is_piv);
    const T piv = __shfl_sync(ALL, r[0], src, CAP);
    T f = T(0);
    if (elim) f = r[0] / (piv != T(0) ? piv : T(1));
    if (R == 1) {
      const T pb = __shfl_sync(ALL, bv, src, CAP);
      if (elim) bv = fmadd(-f, pb, bv);
    }
    if (elim) myrow[k] = f;                 // L, left of the row's position
#pragma unroll
    for (int j = 1; j < CAP; ++j) {
      if (j >= N - k) break;
      const T pj = __shfl_sync(ALL, r[j], src, CAP);
      if (elim) r[j - 1] = fmadd(-f, pj, r[j]);
    }
  }

  // U: a row's registers froze when it became the pivot (r[0] its
  // diagonal), and go to shared memory from its position on
  if (valid) {
#pragma unroll
    for (int j = 0; j < CAP; ++j)
      if (j < N - pos) myrow[pos + j] = r[j];
    rowat[pos] = t;
  }
  __syncwarp();
  const bool fail = minpiv < pivot_floor;
  if (R == 1) {
    // back substitution across the team: the row at position j divides
    // and broadcasts x_j, the rows above it add U x_j to their sums (the
    // same operations in the same order as solve_columns)
    T acc = T(0);
    for (int j = N - 1; j >= 0; --j) {
      const bool own = valid && pos == j;
      const int src = lane_of(own);
      if (own) bv = back_divide(bv, acc, r[0], pivot_floor);
      const T xj = __shfl_sync(ALL, bv, src, CAP);
      if (valid && pos < j) acc = fmadd(myrow[j], xj, acc);
    }
    if (valid) X[sys * N + pos] = fail ? T(0) : bv;
    return;
  }
  solve_tiles<CAP>(Bm, X, sys, N, R, RT, sLU, LDA, rowat, sB, t, pivot_floor,
                   fail, live, [] { __syncwarp(); });
}

// CAP = 64 (33 <= N <= 64): one system per block of two warps, the rows in
// shared memory and every loop at run time (registers would take 128 of
// f64 per row).  The same arithmetic: the arg-max of each warp by
// shuffles, then of the two through shared memory; rowat kept up to date
// by the swaps; the multipliers stored in place of the eliminated entries.
template <typename T>
__global__ void __launch_bounds__(64)
lu_wide_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
               T* __restrict__ X, int nsys, int N, int R, int RT,
               int team_bytes, T pivot_floor) {
  constexpr int CAP = 64, LDA = CAP + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long sys = blockIdx.x;
  if (sys >= nsys) return;
  const int t = threadIdx.x, lane = t & 31;
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + N * LDA;
  T* sKv = sB + N * RT;
  int* rowat = reinterpret_cast<int*>(sKv + 4);
  int* sKp = rowat + CAP;

  copy_block<CAP>(A + sys * N * N, N, sA, LDA, N, N, t);
  if (t < N) rowat[t] = t;
  __syncthreads();
  const bool valid = t < N;
  T* row = sA + t * LDA;
  int pos = t;
  T minpiv = T(INFINITY);
  for (int k = 0; k < N; ++k) {
    const bool cand = valid && pos >= k;
    T v = T(-1);
    int p = CAP;
    if (cand) {
      v = absval(row[k]);
      p = pos;
    }
    argmax_shfl<32>(v, p);
    T* kv = sKv + 2 * (k & 1);
    int* kp = sKp + 2 * (k & 1);
    if (lane == 0) {
      kv[t >> 5] = v;
      kp[t >> 5] = p;
    }
    __syncthreads();
    const bool second = beats(kv[1], kp[1], kv[0], kp[0]);
    v = second ? kv[1] : kv[0];
    p = second ? kp[1] : kp[0];
    if (v < minpiv || v != v) minpiv = v;
    const bool is_piv = valid && pos == p;
    const bool was_k = valid && pos == k && !is_piv;
    if (is_piv) {
      pos = k;
      rowat[k] = t;
    }
    if (was_k) {
      pos = p;
      rowat[p] = t;
    }
    __syncthreads();
    if (valid && pos > k) {
      const T* prow = sA + rowat[k] * LDA;
      const T piv = prow[k];
      const T f = row[k] / (piv != T(0) ? piv : T(1));
      row[k] = f;
      for (int j = k + 1; j < N; ++j) row[j] = fmadd(-f, prow[j], row[j]);
    }
  }
  __syncthreads();
  solve_tiles<CAP>(Bm, X, sys, N, R, RT, sA, LDA, rowat, sB, t, pivot_floor,
                   minpiv < pivot_floor, true, [] { __syncthreads(); });
}

template <typename T, int CAP>
constexpr auto pick_kernel() {
  if constexpr (CAP == 64) return lu_wide_kernel<T>;
  else return lu_solve_kernel<T, CAP>;
}

template <typename T, int CAP>
int launch_cap(const void* A, const void* b, void* x, int nsys, int N, int R,
               int RT, int spb, int team_bytes, double pivot_floor,
               cudaStream_t stream) {
  if (team_bytes < team_bytes_needed<T, CAP>(N, RT) || team_bytes % 16 ||
      spb * CAP > (CAP == 64 ? 64 : 256) || spb * CAP % 32)
    return (int)cudaErrorInvalidValue;
  const long long smem = (long long)spb * team_bytes;
  auto kernel = pick_kernel<T, CAP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (nsys + (long long)spb - 1) / spb;
  kernel<<<(unsigned)blocks, spb * CAP, (size_t)smem, stream>>>(
      (const T*)A, (const T*)b, (T*)x, nsys, N, R, RT, team_bytes,
      (T)pivot_floor);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* A, const void* b, void* x, int nsys, int N, int R,
           int cap, int spb, int RT, int team_bytes, double pivot_floor,
           void* stream) {
  if (nsys <= 0 || R <= 0) return 0;
  if (N <= 0 || N > cap || RT < 1 || RT > R || spb < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cap) {
    case 8:
      return launch_cap<T, 8>(A, b, x, nsys, N, R, RT, spb, team_bytes,
                              pivot_floor, s);
    case 16:
      return launch_cap<T, 16>(A, b, x, nsys, N, R, RT, spb, team_bytes,
                               pivot_floor, s);
    case 32:
      return launch_cap<T, 32>(A, b, x, nsys, N, R, RT, spb, team_bytes,
                               pivot_floor, s);
    case 64:
      return launch_cap<T, 64>(A, b, x, nsys, N, R, RT, spb, team_bytes,
                               pivot_floor, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// A (nsys, N, N), b and x (nsys, N, R), contiguous; the plan (cap, spb, RT,
// team_bytes) comes from ops/cuda_lu.plan.  Returns a cudaError_t.
extern "C" int csim_lu_solve_f32(const void* A, const void* b, void* x,
                                 int nsys, int N, int R, int cap, int spb,
                                 int RT, int team_bytes, double pivot_floor,
                                 void* stream) {
  return launch<float>(A, b, x, nsys, N, R, cap, spb, RT, team_bytes,
                       pivot_floor, stream);
}

extern "C" int csim_lu_solve_f64(const void* A, const void* b, void* x,
                                 int nsys, int N, int R, int cap, int spb,
                                 int RT, int team_bytes, double pivot_floor,
                                 void* stream) {
  return launch<double>(A, b, x, nsys, N, R, cap, spb, RT, team_bytes,
                        pivot_floor, stream);
}
