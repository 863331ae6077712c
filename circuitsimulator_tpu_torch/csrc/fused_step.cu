// K1a for Hopper: the fused Monte-Carlo transient chunk.  Every lane
// advances n_steps whole Backward-Euler timesteps in one launch.
//
// Replaces the TPU kernel circuitsimulator_tpu/ops/pallas_step.py:
// PallasStepRunner._kernel (launched by run_chunk) for its K1a scope:
// R/C/L, V/I sources with PULSE/SIN/PWL/EXP/SFFM waveforms, Level-1 MOS
// without body effect or reverse region, Woodbury rank 0 <= k <= 16.  Per
// step it computes what the TPU kernel computes (plain PyTorch version:
// circuitsimulator_tpu_torch/ops/fused_step.py run_chunk_plain):
//   - source values at t = (step0 + i + 1) * dt in the working type;
//   - b0 = [sources, -gl*il, gc*vc] scattered to their rows; z0 = G0^-1 b0;
//   - Newton from x (or 2x - x_prev): MOS linearisation, z = z0 - Y c,
//     S = I + V^T Y, vz = V^T z, the pivoted k x k solve (first index of
//     max |col|, a zero pivot and a zero diagonal replaced by 1, no pivot
//     floor), x_raw = z - Y w, then accept: clamp, alpha damping,
//     err^2 < tol^2, a non-finite x_raw freezes the lane and sets failed;
//   - vc and il from the accepted x.
// The Newton loop is the fixed unrolled count, or a per-lane loop up to
// max_nr that stops when the lane is done (the TPU kernel's block-wide
// while loop gives the same x: accept freezes lanes that are done).
//
// Design (simple first): one thread per lane, lane-minor constants
// (G0invT (N,N,B) [m][n][lane], YT (k,N,B), Yc3 (3,k,k,B), sources and
// companions (rows, B)), so every read of a warp is 32 consecutive
// addresses.  The TPU kernel's one-hot selection matmuls are index reads
// here; index N is the ground dump slot and reads 0.  Per-lane vectors
// live in fixed-capacity local arrays (N <= 64, k <= 16) indexed at run
// time, so they sit in local memory (L1/L2), not registers.
//
// What bounds it on the H100: the constants are re-read every step
// (G0invT + 2 Newton iterations x (2 YT + Yc3) = 7.7 KB per lane-step in
// f32 at N = 31, k = 6; 63 MB per step at B = 8192, most of it L2-resident
// since the unique constants are ~41 MB), against ~5 kFLOP of arithmetic
// per lane-step; at one warp-load per constant and few warps per SM it is
// bound by memory latency.  Staging G0invT in shared memory per lane block
// and wgmma for the z0 product are later work.  Compiled without fast
// math (SIN/SFFM arguments reach tens of radians); nvcc contracts a*b+c
// into FMAs, so results agree with the plain version to rounding.

#include <cuda_runtime.h>
#include <math.h>

#define MAXN 64
#define MAXK 16

template <typename T>
struct StepArgs {
  // per-lane constants, lane-minor
  const T* G0invT;   // (N, N, B)
  const T* YT;       // (k, N, B)
  const T* Yc3;      // (3, k, k, B)
  const T* mosp;     // (4, k, B): vth, k, lambda, polarity
  const T* dc;       // (nS, B)
  const T* pulse;    // (7, nS, B)  PULSE / EXP parameters
  const T* sinp;     // (5, nS, B)  SIN / SFFM parameters
  const T* pwl_t;    // (P, nS, B)
  const T* pwl_v;    // (P, nS, B)
  const int* pwl_n;  // (nS, B)
  const T* gc;       // (nCap, B)   C / dt
  const T* gl;       // (nL, B)     L / dt
  // index plans shared by all lanes (N = ground dump slot)
  const int* kinds;     // (nS) 0 none, 1 PULSE, 2 SIN, 3 PWL, 4 EXP, 5 SFFM
  const int* src_pos;   // (nS) row that gets +value
  const int* src_neg;   // (nS) row that gets -value
  const int* ind_k;     // (nL) inductor branch rows
  const int* cap_a;     // (nCap) cap terminal pairs
  const int* cap_b;
  const int* mos_cols;  // (3, k) drain, gate, source columns
  // carry, lane-minor, updated in place
  T* x;              // (N, B)
  T* xprev;          // (N, B)
  T* vc;             // (nCap, B)
  T* il;             // (nL, B)
  int* failed;       // (B)
  int* iters;        // (B) Newton iterations over the chunk (output)
  int B, N, k, nS, P, nL, nCap, unrolled, max_nr, predictor, n_steps;
  long long step0;
  T dt, tol2, alpha, clamp, off_gds;
};

__device__ __forceinline__ float sin_(float v) { return sinf(v); }
__device__ __forceinline__ double sin_(double v) { return sin(v); }
__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
__device__ __forceinline__ float fmod_(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_(double a, double b) { return fmod(a, b); }

template <typename T>
__device__ __forceinline__ T absval(T v) { return v < T(0) ? -v : v; }

template <typename T>
__device__ __forceinline__ bool isnan_(T v) { return v != v; }

template <typename T>
__device__ __forceinline__ bool finite_(T v) { return absval(v) < T(INFINITY); }

template <typename T>
__device__ __forceinline__ T clamp01(T v) {
  return v < T(0) ? T(0) : (v > T(1) ? T(1) : v);
}

// x/0 -> +-inf by the sign of x, 0/0 -> +inf (models/sources.py _safe_div)
template <typename T>
__device__ __forceinline__ T safe_div(T num, T den) {
  if (den != T(0)) return num / den;
  return num < T(0) ? T(-INFINITY) : T(INFINITY);
}

// floor modulo with the sign of the divisor (jnp.mod, torch.remainder)
template <typename T>
__device__ __forceinline__ T floor_mod(T a, T p) {
  T r = fmod_(a, p);
  if (r != T(0) && ((r < T(0)) != (p < T(0)))) r += p;
  return r;
}

template <typename T>
__device__ __forceinline__ T exp_seg(T tt, T td, T tau, T amp) {
  if (tau > T(0)) {
    const T d = tt - td;
    return tt > td ? amp * (T(1) - exp_(-(d > T(0) ? d : T(0)) / tau)) : T(0);
  }
  return tt > td ? amp : T(0);
}

// dc + waveform of source s at time tt (models/sources.py formula for
// formula; the TPU kernel's src_val)
template <typename T>
__device__ T source_value(const StepArgs<T>& a, int s, T tt, long long lane) {
  const long long B = a.B;
  const int nS = a.nS;
#define PU(q) a.pulse[((long long)(q) * nS + s) * B + lane]
#define SN(q) a.sinp[((long long)(q) * nS + s) * B + lane]
#define PT(q) a.pwl_t[((long long)(q) * nS + s) * B + lane]
#define PV(q) a.pwl_v[((long long)(q) * nS + s) * B + lane]
  const T two_pi = T(6.283185307179586);
  T val = a.dc[s * B + lane];
  const int kind = a.kinds[s];
  if (kind == 1) {  // PULSE(v1 v2 td tr tf ton per)
    const T v1 = PU(0), v2 = PU(1), ptd = PU(2), tr = PU(3), tf = PU(4);
    const T ton = PU(5), per = PU(6);
    T out;
    if (per <= T(0)) {
      const T tau1 = tt - ptd;
      if (tau1 <= T(0)) out = v1;
      else if (tau1 < tr) out = v1 + clamp01(safe_div(tau1, tr)) * (v2 - v1);
      else if (tau1 < tr + ton) out = v2;
      else out = v2 + clamp01(safe_div(tau1 - (tr + ton), tf)) * (v1 - v2);
    } else {
      const T tau2 = floor_mod(tt - ptd, per);
      if (tt < ptd) out = v1;
      else if (tau2 < tr) out = v1 + (v2 - v1) * clamp01(safe_div(tau2, tr));
      else if (tau2 < tr + ton) out = v2;
      else if (tau2 < tr + ton + tf)
        out = v2 + (v1 - v2) * clamp01(safe_div(tau2 - (tr + ton), tf));
      else out = v1;
    }
    val += out;
  } else if (kind == 2) {  // SIN(v0 va freq td phi)
    const T v0 = SN(0), va = SN(1), w = two_pi * SN(2), sdel = SN(3);
    const T phi = SN(4);
    val += tt < sdel ? v0 : v0 + va * sin_(w * (tt - sdel) + phi);
  } else if (kind == 3) {  // PWL: (t_i, v_i) pairs, n valid
    const int P = a.P;
    const int n = a.pwl_n[s * B + lane];
    if (n > 0) {
      int cnt = 0;
      for (int j = 0; j < P; ++j)
        if (j < n && PT(j) < tt) ++cnt;
      const int i0 = min(max(cnt - 1, 0), P - 1);
      const int i1 = min(max(cnt, 0), P - 1);
      const int last = min(max(n - 1, 0), P - 1);
      const T t_i = PT(i0), t_i1 = PT(i1), v_i = PV(i0), v_i1 = PV(i1);
      const T mid = v_i + (v_i1 - v_i) * safe_div(tt - t_i, t_i1 - t_i);
      val += tt <= PT(0) ? PV(0) : (tt >= PT(last) ? PV(last) : mid);
    }
  } else if (kind == 4) {  // EXP(v1 v2 td1 tau1 td2 tau2) in the PULSE pack
    const T v1 = PU(0), v2 = PU(1), dv = v2 - v1;
    val += (v1 + exp_seg(tt, PU(2), PU(3), dv)) + exp_seg(tt, PU(4), PU(5), -dv);
  } else if (kind == 5) {  // SFFM(vo va fc mdi fs) in the SIN pack
    const T vo = SN(0), va = SN(1), fc = SN(2), mdi = SN(3), fs = SN(4);
    val += vo + va * sin_(two_pi * fc * tt + mdi * sin_(two_pi * fs * tt));
  }
#undef PU
#undef SN
#undef PT
#undef PV
  return val;
}

// One Newton iteration of one lane: xx is the iterate, z0 = G0^-1 b0,
// zb scratch (z, then x_raw, then x_new).
template <typename T>
__device__ __forceinline__ void newton_iter(
    const StepArgs<T>& a, long long lane, T* xx, const T* z0, T* zb, T* cst,
    T (*vco)[MAXK], T (*A)[MAXK], T* bb, T* w, bool& done, bool& fl) {
  const int N = a.N, k = a.k;
  const long long B = a.B;
  if (k > 0) {
    for (int j = 0; j < k; ++j) {  // Level-1 MOS linearisation
      const int cd = a.mos_cols[j], cg = a.mos_cols[k + j];
      const int cs = a.mos_cols[2 * k + j];
      const T vd = cd < N ? xx[cd] : T(0);
      const T vg = cg < N ? xx[cg] : T(0);
      const T vs = cs < N ? xx[cs] : T(0);
      const T vth = a.mosp[(0LL * k + j) * B + lane];
      const T kk = a.mosp[(1LL * k + j) * B + lane];
      const T lam = a.mosp[(2LL * k + j) * B + lane];
      const T pp = a.mosp[(3LL * k + j) * B + lane];
      const T vgs = pp * (vg - vs), vds = pp * (vd - vs);
      const bool on = (vgs > vth) && (vds >= T(0));
      const T vov = vgs - vth;
      const bool tri = vds < vov;
      const T ids0 = on ? (tri ? kk * (vov * vds - T(0.5) * vds * vds)
                               : T(0.5) * kk * vov * vov)
                        : T(0);
      const T gds0 = on ? (tri ? kk * (vov - vds) : T(0)) : a.off_gds;
      const T gm0 = on ? (tri ? kk * vds : kk * vov) : T(0);
      T fac = T(1) + lam * vds;
      fac = fac < T(0) ? T(0) : fac;
      const T gd = gds0 * fac + ids0 * lam;
      const T gg = gm0 * fac;
      const T gs = -(gd + gg);
      cst[j] = pp * ids0 * fac - gd * vd - gg * vg - gs * vs;
      vco[0][j] = gd;
      vco[1][j] = gg;
      vco[2][j] = gs;
    }
    for (int n = 0; n < N; ++n) {  // z = z0 - Y c
      T acc = z0[n];
      for (int j = 0; j < k; ++j)
        acc -= a.YT[((long long)j * N + n) * B + lane] * cst[j];
      zb[n] = acc;
    }
    for (int j = 0; j < k; ++j) {  // S = I + V^T Y, vz = V^T z
      for (int l = 0; l < k; ++l) {
        T s = (j == l) ? T(1) : T(0);
        for (int q = 0; q < 3; ++q)
          s += vco[q][j] * a.Yc3[(((long long)q * k + j) * k + l) * B + lane];
        A[j][l] = s;
      }
      T s = T(0);
      for (int q = 0; q < 3; ++q) {
        const int c = a.mos_cols[q * k + j];
        s += vco[q][j] * (c < N ? zb[c] : T(0));
      }
      bb[j] = s;
    }
    for (int c = 0; c < k; ++c) {  // pivoted elimination
      int p = c;
      T best = absval(A[c][c]);
      for (int i = c + 1; i < k; ++i) {
        const T v = absval(A[i][c]);
        if (v > best || (isnan_(v) && !isnan_(best))) {
          best = v;
          p = i;
        }
      }
      if (p != c) {
        for (int l = c; l < k; ++l) {
          const T t = A[c][l];
          A[c][l] = A[p][l];
          A[p][l] = t;
        }
        const T t = bb[c];
        bb[c] = bb[p];
        bb[p] = t;
      }
      const T piv = A[c][c];
      const T safe = piv != T(0) ? piv : T(1);
      for (int i = c + 1; i < k; ++i) {
        const T f = A[i][c] / safe;
        for (int l = c + 1; l < k; ++l) A[i][l] -= f * A[c][l];
        bb[i] -= f * bb[c];
      }
    }
    for (int j = k - 1; j >= 0; --j) {  // back substitution
      T acc = T(0);
      for (int l = j + 1; l < k; ++l) acc += A[j][l] * w[l];
      const T d = A[j][j];
      w[j] = (bb[j] - acc) / (d != T(0) ? d : T(1));
    }
    for (int n = 0; n < N; ++n) {  // x_raw = z - Y w
      T acc = zb[n];
      for (int j = 0; j < k; ++j)
        acc -= a.YT[((long long)j * N + n) * B + lane] * w[j];
      zb[n] = acc;
    }
  } else {
    for (int n = 0; n < N; ++n) zb[n] = z0[n];  // linear deck: x_raw = z0
  }
  // accept: clamp, damping, tolerance on the damped step, freeze
  bool finite = true;
  T err2 = T(0);
  for (int n = 0; n < N; ++n) {
    const T xr = zb[n];
    finite = finite && finite_(xr);
    T u = xr - xx[n];
    if (a.clamp > T(0)) u = u < -a.clamp ? -a.clamp : (u > a.clamp ? a.clamp : u);
    const T xn = xx[n] + a.alpha * u;
    const T d = xn - xx[n];
    err2 += d * d;
    zb[n] = xn;
  }
  const bool upd = finite && !done;
  if (upd)
    for (int n = 0; n < N; ++n) xx[n] = zb[n];
  done = done || (upd && err2 < a.tol2) || !finite;
  fl = fl || !finite;
}

template <typename T>
__global__ void __launch_bounds__(128) fused_step_kernel(const StepArgs<T> a) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  const long long B = a.B;
  const int N = a.N;
  T x[MAXN], xp[MAXN], xx[MAXN], z0[MAXN], zb[MAXN + 1];
  T cst[MAXK], vco[3][MAXK], A[MAXK][MAXK], bb[MAXK], w[MAXK];
  for (int n = 0; n < N; ++n) {
    x[n] = a.x[n * B + lane];
    xp[n] = a.xprev[n * B + lane];
  }
  bool failed = a.failed[lane] != 0;
  int it_total = 0;
  for (int i = 0; i < a.n_steps; ++i) {
    const T tt = T(a.step0 + i + 1) * a.dt;
    // RHS: sources, inductor and capacitor history
    for (int n = 0; n <= N; ++n) zb[n] = T(0);
    for (int s = 0; s < a.nS; ++s) {
      const T v = source_value(a, s, tt, lane);
      zb[a.src_pos[s]] += v;
      zb[a.src_neg[s]] -= v;
    }
    for (int j = 0; j < a.nL; ++j)
      zb[a.ind_k[j]] += -(a.gl[j * B + lane] * a.il[j * B + lane]);
    for (int j = 0; j < a.nCap; ++j) {
      const T h = a.gc[j * B + lane] * a.vc[j * B + lane];
      zb[a.cap_a[j]] += h;
      zb[a.cap_b[j]] -= h;
    }
    for (int n = 0; n < N; ++n) {  // z0 = G0^-1 b0, contraction-major reads
      T acc = T(0);
      for (int m = 0; m < N; ++m)
        acc += a.G0invT[((long long)m * N + n) * B + lane] * zb[m];
      z0[n] = acc;
    }
    for (int n = 0; n < N; ++n)
      xx[n] = a.predictor ? T(2) * x[n] - xp[n] : x[n];
    bool done = failed, fl = failed;
    int its = 0;
    if (a.unrolled > 0) {
      for (; its < a.unrolled; ++its)
        newton_iter(a, lane, xx, z0, zb, cst, vco, A, bb, w, done, fl);
    } else {
      for (; !done && its < a.max_nr; ++its)
        newton_iter(a, lane, xx, z0, zb, cst, vco, A, bb, w, done, fl);
    }
    it_total += its;
    // history from the accepted x
    for (int j = 0; j < a.nCap; ++j) {
      const int ca = a.cap_a[j], cb = a.cap_b[j];
      a.vc[j * B + lane] = (ca < N ? xx[ca] : T(0)) - (cb < N ? xx[cb] : T(0));
    }
    for (int j = 0; j < a.nL; ++j) a.il[j * B + lane] = xx[a.ind_k[j]];
    for (int n = 0; n < N; ++n) {
      xp[n] = x[n];
      x[n] = xx[n];
    }
    failed = fl;
  }
  for (int n = 0; n < N; ++n) {
    a.x[n * B + lane] = x[n];
    a.xprev[n * B + lane] = xp[n];
  }
  a.failed[lane] = failed ? 1 : 0;
  a.iters[lane] = it_total;
}

// ptrs: the 25 arrays in StepArgs order; ints: B N k nS P nL nCap unrolled
// max_nr predictor n_steps step0 threads; reals: dt tol2 alpha clamp off_gds
template <typename T>
static int launch(void* const* ptrs, const long long* ints,
                  const double* reals, void* stream) {
  StepArgs<T> a;
  a.G0invT = (const T*)ptrs[0];
  a.YT = (const T*)ptrs[1];
  a.Yc3 = (const T*)ptrs[2];
  a.mosp = (const T*)ptrs[3];
  a.dc = (const T*)ptrs[4];
  a.pulse = (const T*)ptrs[5];
  a.sinp = (const T*)ptrs[6];
  a.pwl_t = (const T*)ptrs[7];
  a.pwl_v = (const T*)ptrs[8];
  a.pwl_n = (const int*)ptrs[9];
  a.gc = (const T*)ptrs[10];
  a.gl = (const T*)ptrs[11];
  a.kinds = (const int*)ptrs[12];
  a.src_pos = (const int*)ptrs[13];
  a.src_neg = (const int*)ptrs[14];
  a.ind_k = (const int*)ptrs[15];
  a.cap_a = (const int*)ptrs[16];
  a.cap_b = (const int*)ptrs[17];
  a.mos_cols = (const int*)ptrs[18];
  a.x = (T*)ptrs[19];
  a.xprev = (T*)ptrs[20];
  a.vc = (T*)ptrs[21];
  a.il = (T*)ptrs[22];
  a.failed = (int*)ptrs[23];
  a.iters = (int*)ptrs[24];
  a.B = (int)ints[0];
  a.N = (int)ints[1];
  a.k = (int)ints[2];
  a.nS = (int)ints[3];
  a.P = (int)ints[4];
  a.nL = (int)ints[5];
  a.nCap = (int)ints[6];
  a.unrolled = (int)ints[7];
  a.max_nr = (int)ints[8];
  a.predictor = (int)ints[9];
  a.n_steps = (int)ints[10];
  a.step0 = ints[11];
  const int threads = (int)ints[12];
  a.dt = (T)reals[0];
  a.tol2 = (T)reals[1];
  a.alpha = (T)reals[2];
  a.clamp = (T)reals[3];
  a.off_gds = (T)reals[4];
  if (a.N > MAXN || a.k > MAXK || a.N <= 0 || a.k < 0 || threads <= 0 ||
      threads > 128)
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  const int blocks = (a.B + threads - 1) / threads;
  fused_step_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int csim_fused_step_f32(void* const* ptrs, const long long* ints,
                                   const double* reals, void* stream) {
  return launch<float>(ptrs, ints, reals, stream);
}

extern "C" int csim_fused_step_f64(void* const* ptrs, const long long* ints,
                                   const double* reals, void* stream) {
  return launch<double>(ptrs, ints, reals, stream);
}
