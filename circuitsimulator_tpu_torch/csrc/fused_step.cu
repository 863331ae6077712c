// K1 for Hopper (scopes K1a, K1b, K1c-i, K1c-ii, K1c-iii, K1d-i and K1d-ii):
// the fused Monte-Carlo transient chunk.  Every lane advances n_steps whole Backward-Euler
// timesteps in one launch.
//
// Replaces the TPU kernel circuitsimulator_tpu/ops/pallas_step.py:
// PallasStepRunner._kernel (launched by run_chunk) for R/C/L, V/I sources
// with PULSE/SIN/PWL/EXP/SFFM waveforms, Level-1 MOS without body effect or
// reverse region (K1a), JFET, diode (with reverse breakdown), Ebers-Moll BJT
// (with Early voltage) and S/W switch rows (K1b), the charge rows of
// MOSCAP=CHARGE with Woodbury ranks up to 32 (K1d-i), and the behavioral B
// source rows (K1d-ii, rank <= 16, no charge rows) and the delay ring of the
// lossless transmission lines (K1c-ii, nT <= 8, Dmax x 2 nT <= 1024) and the
// TRNOISE input block (K1c-iii); rank
// 0 <= k = nMJ + nD + 2 nQ + nSw + nB + 5 nMq <= 32 (nMq = the MOS count
// under the charge model, else 0).  Per step it computes what the TPU kernel computes
// (plain PyTorch version: circuitsimulator_tpu_torch/ops/fused_step.py
// run_chunk_plain):
//   - source values at t = (step0 + i + 1) * dt in the working type, plus on
//     a noisy run each noisy source's value of the step from the noise
//     block (K1c-iii);
//   - b0 = [sources, -gl*il, gc*vc, E1, E2] scattered to their rows (the
//     T-line EMFs: E1_j = the wave w2_j of ticks_j steps ago on row k1_j,
//     E2_j = w1_j on row k2_j); z0 = G0^-1 b0;
//   - under the charge model q_prev = q(x) of the incoming x;
//   - Newton from x (or 2x - x_prev): the device linearisations in Woodbury
//     row order (MOS then JFET rows from one pack, diode rows, an Ic and an
//     Ib row per BJT, switch rows, B rows, five charge rows per MOS),
//     z = z0 - Y c,
//     S = I + V^T Y, vz = V^T z, the k x k solve, x_raw = z - Y w, then
//     accept: clamp, alpha damping, err^2 < tol^2, a non-finite x_raw
//     freezes the lane and sets failed;
//   - with a probe matrix (K1c-i, the TPU kernel's probe_mat output,
//     pallas_step.py:1242-1244), the P values probe_mat @ x of the accepted
//     x into ys (n_steps, P, B);
//   - vc and il from the accepted x (the cap plan holds the explicit, MOS,
//     diode and BJT junction capacitors; the MOS slots carry C = 0 under the
//     charge model), and with T-lines the waves w = V(p) - V(n) + Z0 i of
//     both ports of every line pushed into the delay ring.
// The k x k solve is the TPU kernel's: for k <= 16 pivoted elimination and
// back substitution (first index of max |col|, a zero pivot and a zero
// diagonal replaced by 1, no pivot floor); for 16 < k <= 32 column-pivoted
// Gauss-Jordan (for column c the pivot is the first maximum of |col| over
// the rows not used yet; every row but the pivot row subtracts
// A[i][c] / A[p][c] times it, a zero pivot divides by 1; at the end
// w[c(p)] = bb[p] / A[p][c(p)], a zero divides by 1).  In both a NaN |col|
// counts as the largest (the first NaN wins), as torch.max and jnp.argmax
// rank it.  The Newton loop is the fixed unrolled count, or a per-lane loop
// up to max_nr that stops when the lane is done (the TPU kernel's
// block-wide while loop gives the same x: accept freezes lanes that are
// done).  The TPU kernel evaluates both BJT currents on row-duplicated lanes
// and selects by parity; here each device is evaluated once and writes its
// two rows.
//
// Charge rows (models/moscap.py, JAX kernel pallas_step.py:997-1019): the
// Ward-Dutton gate and depletion junction charges of each MOS are evaluated
// once on Dual<T> numbers (a value and d/d(vd, vg, vs)), the three jvp
// passes of the TPU kernel side by side; g = (dq/dv)/dt and
// cst = (q(v) - q_prev)/dt - g.v for its five rows (i_d, i_g, i_s, i_sb,
// i_db), which read the MOS's (d, g, s) columns from the row plan.  The
// rules are JAX's: select for where, half of each tangent at an exact tie
// of maximum/minimum, d(a/b) = da/b - db a/b^2; arg^(1 - MJ) with MJ = 0.5
// is sqrt(arg) as PyTorch computes it, its tangent 0.5/sqrt(arg).
//
// B rows (utils/expr.py compile_tape / eval_tape, JAX kernel
// pallas_step.py:973-996): an interpreter, not per-deck source, so one build
// serves every deck.  Each source's tape (postfix opcodes, its literals)
// sits in arrays that every lane reads at the same address; the probe
// values vals_i = x[a_i] - x[b_i] come from the row's column plan
// (a_0, b_0, a_1, b_1, ...).  A tape runs on a per-thread stack of
// DualN<T, 4> (a value and its partials in the up to four probes) plus the
// set of probes each entry depends on: a partial outside it is a symbolic
// zero that no rule multiplies, as in JAX's jvp (so sqrt(v1) + v2 at v1 = 0
// has the v2-partial 1, not inf * 0).  The derivative rules are JAX's
// (jax/_src/lax/lax.py): abs' = 1 at 0, a 0.5/0.5 split at a min/max tie,
// floor' = ceil' = 0, the x-partial 1 of fmod, POWC (an exponent that reads
// no probe) never forms the log(x) x^y term, POW's exponent partial is
// log(x or 1) x^y.  The row is sig (g_0, -g_0, g_1, -g_1, ...) zero-padded
// to W and c = sig (e0 - g.vals) with sig = -1 for V=expr, +1 for I=expr;
// time is t = (step0 + i + 1) dt.  The B instantiation has a row width
// capacity of 8 (POLY(3) sources need 6); the others keep 4.
//
// Probe stream (K1c-i): every instantiation writes it when ys is not null
// (a run-time branch after the Newton loop, outside the frames of the
// Newton iteration).  Each lane stores its P values at ys[(i P + p) B +
// lane], so neighbouring threads store to neighbouring addresses, and every
// lane reads the (P, N) matrix at the same address, as it reads the B tapes.
// The matrices of StreamingMeasures are +1/-1 pairs, so for a finite x the
// sum is exactly x[a] - x[b] in any order (FMA contraction included): the
// kernel and the plain version agree bit for bit on the same x.
//
// Delay ring (K1c-ii, the TPU kernel's tlw carry, pallas_step.py:1181-1190
// and :1236-1241): the ring (Dmax, 2 nT, B) holds the last Dmax waves of
// each port, lane-minor, in global memory.  The TPU kernel shifts the whole
// ring every step (Dmax x 2 nT words per lane-step, up to 1024); here it
// stays in place and a head index moves: at step i of the launch the wave
// d + 1 steps old sits in slot (d - i) mod Dmax, and the push writes slot
// (-(i + 1)) mod Dmax.  A step reads its EMFs before its push, so at
// ticks = Dmax the oldest wave is read before the push overwrites it.
// Each lane-step reads 2 nT words and writes 2 nT words of the ring; the
// wrapper rolls it back to slot 0 = newest at launch exit.  The wave is
// (V(p) - V(n)) + Z0 i rounded twice (no FMA contraction, __fmul_rn and
// __fadd_rn), as PyTorch computes it, so kernel and plain rings agree bit
// for bit on the same x.  It runs behind a run-time nT test in every
// instantiation, as the probe stream does.
//
// TRNOISE block (K1c-iii, the TPU kernel's noise input, pallas_step.py:
// 1174-1179 with the row scatter of :567-575): the wrapper passes the
// (n_steps, nN, B) block of the chunk's per-step source noise, drawn on the
// host side by Engine.trnoise_stream, and per source the row c of the block
// it takes (noise_col, -1 for a source without noise).  Step i adds
// noise[(i nN + c) B + lane] to the source's value before the value is
// scattered, so the sum is the plain version's sv + noise, one add per
// value.  Lane-minor, the read is one coalesced word per lane and step.
// It sits in an out-of-line function behind a run-time nN test, as the
// ring does, and adds no registers to the Newton loop.
//
// Design (simple first): one thread per lane, lane-minor constants
// (G0invT (N,N,B) [m][n][lane], YT (k,N,B), Yc3 (W,k,k,B), the device packs,
// sources and companions (rows, B)), so every read of a warp is 32
// consecutive addresses.  The TPU kernel's one-hot selection matmuls are
// index reads here: row_cols (W, k) gives each V^T row's columns, which are
// also the terminals its device reads (W = 4 with a switch: p, m, cp, cm;
// else 3); index N is the ground dump slot and reads 0.  Per-lane vectors
// live in fixed-capacity local arrays (N <= 64, k <= KCAP) indexed at run
// time, so they sit in local memory (L1/L2), not registers.  The kernel is
// instantiated for KCAP = 16 (elimination) and KCAP = 32 (Gauss-Jordan),
// each with and without the charge rows, and for KCAP = 16 with the B rows,
// so the K1a/K1b instantiation keeps its 16 x 16 frame and code.
//
// What bounds it on the H100: the constants are re-read every step
// (G0invT once, then per Newton iteration 2 YT + Yc3 + the device packs:
// 7.7 KB per lane-step in f32 at N = 31, k = 6 and two iterations; 63 MB
// per step at B = 8192, most of it L2-resident since the unique constants
// are ~41 MB), against ~5 kFLOP of arithmetic per lane-step; at one
// warp-load per constant and few warps per SM it is bound by memory
// latency.  On small junction decks (N = 7, k = 2) the per-lane chain of
// dependent expf/divisions of the damped Newton loop (tens of iterations
// per step) takes over; at k = 22-32 the Gauss-Jordan solve (about 2 k^3
// operations on a local-memory A per iteration) and Yc3 (W k^2 per lane) do.
// Staging G0invT in shared memory per lane block and wgmma for the z0
// product are later work.  Compiled without fast math (SIN/SFFM arguments
// reach tens of radians, the switch conductance spans nine decades through
// exp/log); nvcc contracts a*b+c into FMAs, so results agree with the plain
// version to rounding.

#include <cuda_runtime.h>
#include <math.h>

#define MAXN 64
#define UNROLL_K 16  // the elimination instantiation's capacity
#define MAXK 32      // the Gauss-Jordan instantiation's capacity
#define MAXPROBES 64 // rows of the probe matrix (K1c-i)
#define MAXTL 8        // transmission lines (K1c-ii)
#define MAXRING 1024   // Dmax x 2 nT waves of the delay ring (K1c-ii)

template <typename T>
struct StepArgs {
  // per-lane constants, lane-minor
  const T* G0invT;   // (N, N, B)
  const T* YT;       // (k, N, B)
  const T* Yc3;      // (W, k, k, B)
  const T* mosp;     // (4, nMJ, B): vth | VTO, k | 2 BETA, lambda, polarity
  const T* diop;     // (5, nD, B): is, n*vt, bv, ibv, vt
  const T* bjtp;     // (6, nQ, B): is, bf, br, polarity, vaf, vt
  const T* swp;      // (4, nSw, B): ron, roff, vt, vh
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
  const int* row_cols;  // (W, k) columns of each V^T row
  // carry, lane-minor, updated in place
  T* x;              // (N, B)
  T* xprev;          // (N, B)
  T* vc;             // (nCap, B)
  T* il;             // (nL, B)
  int* failed;       // (B)
  int* iters;        // (B) Newton iterations over the chunk (output)
  int B, N, k, nS, P, nL, nCap, unrolled, max_nr, predictor, n_steps;
  int nMJ, nD, nQ, nSw, W;
  long long step0;
  T dt, tol2, alpha, clamp, off_gds;
  // charge model (MOSCAP=CHARGE): nMq MOS with five rows each, last
  const T* mqp;      // (4, nMq, B): vth, coxwl, cj0, polarity
  int nMq;
  T inv_dt;          // 1/dt, computed on the host in double
  // behavioral B sources: the concatenated tapes and per-source metadata
  // (instruction offset, count, literal offset, probe pairs, V form,
  // constant offset), shared by all lanes; their .PARAM values lane-minor
  const int* b_ops;  // (sum of tape lengths)
  const T* b_lits;   // (sum of literal counts)
  const int* b_meta; // (nB, 6)
  const T* bconsts;  // (nc | 1, B)
  int nB;
  // the probe stream (K1c-i): both null, nP = 0, when the run keeps none
  const T* probe_mat;  // (nP, N), shared by all lanes
  T* ys;               // (n_steps, nP, B) output
  int nP;
  // transmission lines (K1c-ii): nT = 0 and ring null without them
  const int* tl_read;  // (nT) read slot ticks - 1 of each line
  const int* tl_plan;  // (6, nT): ep1, em1, k1, ep2, em2, k2 (N = ground)
  const T* tl_z0;      // (nT, B)
  T* ring;             // (Dmax, 2 nT, B), updated in place
  int nT, Dmax;
  // TRNOISE (K1c-iii): nN = 0 and both null without noise
  const int* noise_col;  // (nS) row of the noise block of each source, -1
  const T* noise;        // (n_steps, nN, B)
  int nN;
};

__device__ __forceinline__ float sin_(float v) { return sinf(v); }
__device__ __forceinline__ double sin_(double v) { return sin(v); }
__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
__device__ __forceinline__ float log_(float v) { return logf(v); }
__device__ __forceinline__ double log_(double v) { return log(v); }
__device__ __forceinline__ float fmod_(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_(double a, double b) { return fmod(a, b); }
#define MATH1(name, fn32, fn64)                                        \
  __device__ __forceinline__ float name(float v) { return fn32(v); }   \
  __device__ __forceinline__ double name(double v) { return fn64(v); }
MATH1(cos_, cosf, cos)
MATH1(tan_, tanf, tan)
MATH1(asin_, asinf, asin)
MATH1(acos_, acosf, acos)
MATH1(atan_, atanf, atan)
MATH1(sinh_, sinhf, sinh)
MATH1(cosh_, coshf, cosh)
MATH1(tanh_, tanhf, tanh)
MATH1(sqrt_, sqrtf, sqrt)
MATH1(fabs_, fabsf, fabs)
MATH1(floor_, floorf, floor)
MATH1(ceil_, ceilf, ceil)
#undef MATH1
__device__ __forceinline__ float pow_(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double pow_(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float atan2_(float a, float b) { return atan2f(a, b); }
__device__ __forceinline__ double atan2_(double a, double b) { return atan2(a, b); }

template <typename T>
__device__ __forceinline__ T absval(T v) { return v < T(0) ? -v : v; }

// a + b * c with two roundings (never contracted into an FMA)
__device__ __forceinline__ float add_mul_rn(float a, float b, float c) {
  return __fadd_rn(a, __fmul_rn(b, c));
}
__device__ __forceinline__ double add_mul_rn(double a, double b, double c) {
  return __dadd_rn(a, __dmul_rn(b, c));
}

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

// e(u) = exp(u) up to u = 40, its tangent above; de = e'(u)
// (models/diode.py exp_lim; the constant is exp(40))
template <typename T>
__device__ __forceinline__ void exp_lim(T u, T& e, T& de) {
  const T u_max = T(40), top = T(2.3538526683701998e17);
  if (u <= u_max) {
    e = de = exp_(u);
  } else {
    e = top * (T(1) + (u - u_max));
    de = top;
  }
}


// ---- forward-mode dual numbers: a value and M partials.  The charge rows
// (models/moscap.py) use Dual<T> = DualN<T, 3>, d/d(vd, vg, vs); the B-source
// interpreter keeps DualN<T, 4> on its stack ----
template <typename T, int M>
struct DualN {
  T v, d[M];
};
template <typename T>
using Dual = DualN<T, 3>;

template <typename T>
__device__ __forceinline__ Dual<T> dconst(T c) {
  return {c, {T(0), T(0), T(0)}};
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a) {
  return {-a.v, {-a.d[0], -a.d[1], -a.d[2]}};
}

template <typename T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a, const Dual<T>& b) {
  return {a.v + b.v, {a.d[0] + b.d[0], a.d[1] + b.d[1], a.d[2] + b.d[2]}};
}

template <typename T>
__device__ __forceinline__ Dual<T> operator+(T a, const Dual<T>& b) {
  return {b.v + a, {b.d[0], b.d[1], b.d[2]}};
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a, const Dual<T>& b) {
  return {a.v - b.v, {a.d[0] - b.d[0], a.d[1] - b.d[1], a.d[2] - b.d[2]}};
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a, T b) {
  return {a.v - b, {a.d[0], a.d[1], a.d[2]}};
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(T a, const Dual<T>& b) {
  return {a - b.v, {-b.d[0], -b.d[1], -b.d[2]}};
}

template <typename T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v * b.v;
  for (int i = 0; i < 3; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, const Dual<T>& b) {
  return {b.v * a, {b.d[0] * a, b.d[1] * a, b.d[2] * a}};
}

template <typename T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v / b.v;
  const T inv2 = T(1) / (b.v * b.v);
  for (int i = 0; i < 3; ++i) r.d[i] = a.d[i] / b.v + (-b.d[i] * a.v) * inv2;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a, T b) {
  return {a.v / b, {a.d[0] / b, a.d[1] / b, a.d[2] / b}};
}

// x^n and its tangent n x^(n-1) dx, with the powers PyTorch takes: x*x and
// x*x*x for 2 and 3, pow otherwise, sqrt for 1/2 (its tangent 0.5/sqrt)
template <typename T>
__device__ __forceinline__ Dual<T> dscale(const Dual<T>& a, T v, T f) {
  return {v, {a.d[0] * f, a.d[1] * f, a.d[2] * f}};
}
template <typename T>
__device__ __forceinline__ Dual<T> pow2(const Dual<T>& a) {
  return dscale(a, a.v * a.v, T(2) * a.v);
}
template <typename T>
__device__ __forceinline__ Dual<T> pow3(const Dual<T>& a) {
  return dscale(a, a.v * a.v * a.v, T(3) * (a.v * a.v));
}
template <typename T>
__device__ __forceinline__ Dual<T> pow4(const Dual<T>& a) {
  return dscale(a, pow(a.v, T(4)), T(4) * (a.v * a.v * a.v));
}
template <typename T>
__device__ __forceinline__ Dual<T> pow5(const Dual<T>& a) {
  return dscale(a, pow(a.v, T(5)), T(5) * pow(a.v, T(4)));
}
template <typename T>
__device__ __forceinline__ Dual<T> dsqrt(const Dual<T>& a) {
  return dscale(a, sqrt(a.v), T(0.5) * (T(1) / sqrt(a.v)));
}

// maximum/minimum with JAX's tie rule (half of each tangent at an exact
// tie); a NaN in a wins (NaN propagates)
template <typename T>
__device__ __forceinline__ Dual<T> pick(const Dual<T>& a, const Dual<T>& b,
                                        bool a_wins) {
  a_wins = a_wins || isnan_(a.v);
  Dual<T> r = a_wins ? a : b;
  if (a.v == b.v)
    for (int i = 0; i < 3; ++i) r.d[i] = T(0.5) * a.d[i] + T(0.5) * b.d[i];
  return r;
}
template <typename T>
__device__ __forceinline__ Dual<T> dmax(const Dual<T>& a, T b) {
  return pick(a, dconst(b), a.v > b);
}
template <typename T>
__device__ __forceinline__ Dual<T> dmin(const Dual<T>& a, const Dual<T>& b) {
  return pick(a, b, a.v < b.v);
}

// SPICE depletion charge against the forward bias v (PB = 0.8, MJ = 0.5,
// FC = 0.5; the constants are the Python values of models/moscap.py)
template <typename T>
__device__ __forceinline__ Dual<T> depletion_charge(const Dual<T>& v, T cj0) {
  const T vb = T(0.4), f1 = T(0.4686291501015239), f2 = T(0.3535533905932738);
  const Dual<T> v_lo = dmin(v, dconst(vb));
  const Dual<T> arg = dmax(T(1) - v_lo / T(0.8), T(1e-6));
  const Dual<T> q_lo = (cj0 * T(0.8) / T(0.5)) * (T(1) - dsqrt(arg));
  const Dual<T> dv = dmax(v - vb, T(0));
  const Dual<T> q_hi = (cj0 / f2) * (T(0.25) * dv + T(0.3125) *
                                     (pow2(vb + dv) - T(0.16000000000000003)));
  return v.v <= vb ? q_lo : (cj0 * f1) + q_hi;
}

// (q_d, q_g, q_s, q_sb, q_db) of one MOS and their derivatives with respect
// to (vd, vg, vs): models/moscap.py mos_all_charges, formula for formula
template <typename T>
__device__ __forceinline__ void mos_charges(T vd_, T vg_, T vs_, T vth, T cox,
                                            T cj0, T p, Dual<T>* q) {
  using D = Dual<T>;
  const D vd = {vd_, {T(1), T(0), T(0)}};
  const D vg = {vg_, {T(0), T(1), T(0)}};
  const D vs = {vs_, {T(0), T(0), T(1)}};
  const D vgs = p * (vg - vs);
  const D vds = p * (vd - vs);
  const bool swap = vds.v < T(0);
  const D d_ = swap ? -vds : vds;
  D vgt = (swap ? vgs - vds : vgs) - vth;  // vgd when swapped
  const bool on = vgt.v > T(0);
  vgt = dmax(vgt, T(0));
  const bool sat = d_.v >= vgt.v;
  const D d_t = dmin(d_, vgt);             // triode-clamped vds
  const D Dq = vgt * d_t - T(0.5) * d_t * d_t;
  const bool D_ok = Dq.v > T(0);
  const D Ds = D_ok ? Dq : dconst(T(1));
  const D qg_tri = cox * (pow3(vgt) - pow3(vgt - d_t)) / (T(3) * Ds);
  const D qd_tri = (-cox) * (T(0.5) * pow3(vgt) * pow2(d_t)
                             - T(5.0 / 6.0) * pow2(vgt) * pow3(d_t)
                             + T(0.5) * vgt * pow4(d_t)
                             - T(0.1) * pow5(d_t)) / (Ds * Ds);
  const D qg_sat = (T(2.0 / 3.0) * cox) * vgt;
  const D qd_sat = (T(-(4.0 / 15.0)) * cox) * vgt;
  D qg = D_ok ? qg_tri : cox * vgt;
  D qd = D_ok ? qd_tri : (T(-0.5) * cox) * vgt;
  qg = sat ? qg_sat : qg;
  qd = sat ? qd_sat : qd;
  qg = on ? qg : dconst(T(0));
  qd = on ? qd : dconst(T(0));
  const D qs = -(qg + qd);
  q[0] = p * (swap ? qs : qd);
  q[1] = p * qg;
  q[2] = p * (swap ? qd : qs);
  q[3] = (-p) * depletion_charge((-p) * vs, cj0);
  q[4] = (-p) * depletion_charge((-p) * vd, cj0);
}

// the charges of the charge model's MOS m at terminal voltages (vd, vg, vs)
template <typename T>
__device__ __forceinline__ void mos_charges_at(const StepArgs<T>& a,
                                               long long lane, int m, T vd,
                                               T vg, T vs, Dual<T>* q) {
  const long long B = a.B;
  const int nMq = a.nMq;
  mos_charges(vd, vg, vs, a.mqp[(0LL * nMq + m) * B + lane],
              a.mqp[(1LL * nMq + m) * B + lane],
              a.mqp[(2LL * nMq + m) * B + lane],
              a.mqp[(3LL * nMq + m) * B + lane], q);
}

// ---- B sources: the tape interpreter (utils/expr.py compile_tape) ----
#define BSTACK 16   // expression stack (ops/cuda_step.py MAX_STACK)
#define BPROBES 4   // probe pairs per source (ops/fused_step.py MAX_B_PAIRS)
// opcodes in the order of utils/expr.py OPS; an instruction is
// opcode | operand << 8
enum BOp {
  B_PUSH_NUM, B_PUSH_PROBE, B_PUSH_TIME, B_PUSH_CONST, B_NEG,
  B_ADD, B_SUB, B_MUL, B_DIV, B_MOD, B_POW, B_POWC,
  B_SIN, B_COS, B_TAN, B_ASIN, B_ACOS, B_ATAN, B_SINH, B_COSH, B_TANH,
  B_EXP, B_LOG, B_LOG10, B_SQRT, B_ABS, B_FLOOR, B_CEIL,
  B_ATAN2, B_MIN, B_MAX
};

template <typename T>
__device__ __forceinline__ T nan_of() { return T(NAN); }

template <typename T>
__device__ __forceinline__ T sign_(T v) {  // jnp.sign: NaN and +-0 pass
  return v > T(0) ? T(1) : (v < T(0) ? T(-1) : v);
}

// value and partial rule of a unary opcode (r = its value at a)
template <typename T>
__device__ __forceinline__ T b_unary(int op, T a) {
  switch (op) {
    case B_SIN: return sin_(a);
    case B_COS: return cos_(a);
    case B_TAN: return tan_(a);
    case B_ASIN: return asin_(a);
    case B_ACOS: return acos_(a);
    case B_ATAN: return atan_(a);
    case B_SINH: return sinh_(a);
    case B_COSH: return cosh_(a);
    case B_TANH: return tanh_(a);
    case B_EXP: return exp_(a);
    case B_LOG: return log_(a);
    case B_LOG10: return log_(a) * T(0.4342944819032518);
    case B_SQRT: return sqrt_(a);
    case B_ABS: return fabs_(a);
    case B_FLOOR: return floor_(a);
    default: return ceil_(a);  // B_CEIL
  }
}
template <typename T>
__device__ __forceinline__ T b_unary_d(int op, T g, T a, T r) {
  switch (op) {
    case B_SIN: return g * cos_(a);
    case B_COS: return -(g * sin_(a));
    case B_TAN: return g * (T(1) + r * r);
    case B_ASIN: return g * (T(1) / sqrt_(T(1) - a * a));
    case B_ACOS: return g * -(T(1) / sqrt_(T(1) - a * a));
    case B_ATAN: return g / (T(1) + a * a);
    case B_SINH: return g * cosh_(a);
    case B_COSH: return g * sinh_(a);
    case B_TANH: return (g + g * r) * (T(1) - r);
    case B_EXP: return g * r;
    case B_LOG: return g / a;
    case B_LOG10: return (g / a) * T(0.4342944819032518);
    case B_SQRT: return g * (T(0.5) / r);
    default: return a >= T(0) ? g : -g;  // B_ABS
  }
}
// value and the partial rules through a and through b of a binary opcode
template <typename T>
__device__ __forceinline__ T b_binary(int op, T a, T b) {
  switch (op) {
    case B_ADD: return a + b;
    case B_SUB: return a - b;
    case B_MUL: return a * b;
    case B_DIV: return a / b;
    case B_MOD: return fmod_(a, b);
    case B_ATAN2: return atan2_(a, b);
    case B_MIN:
      return (isnan_(a) || isnan_(b)) ? nan_of<T>() : (a < b ? a : b);
    case B_MAX:
      return (isnan_(a) || isnan_(b)) ? nan_of<T>() : (a > b ? a : b);
    default: return pow_(a, b);  // B_POW, B_POWC
  }
}
template <typename T>
__device__ __forceinline__ T b_tie(T x, T y, T r) {  // JAX _balanced_eq
  return (x == r ? T(1) : T(0)) / (y == r ? T(2) : T(1));
}
template <typename T>
__device__ __forceinline__ T b_binary_da(int op, T g, T a, T b, T r) {
  switch (op) {
    case B_MUL: return g * b;
    case B_DIV: return g / b;
    case B_POW: case B_POWC: return g * (b * pow_(a, b - T(1)));
    case B_ATAN2: return g * (b / (a * a + b * b));
    case B_MIN: case B_MAX: return g * b_tie(a, b, r);
    default: return g;  // B_ADD, B_SUB, B_MOD
  }
}
template <typename T>
__device__ __forceinline__ T b_binary_db(int op, T g, T a, T b, T r) {
  switch (op) {
    case B_SUB: return -g;
    case B_MUL: return a * g;
    case B_DIV: return (-g * a) * (T(1) / (b * b));
    case B_MOD: return -g * (sign_(a / b) * floor_(fabs_(a / b)));
    case B_POW: return g * (log_(a == T(0) ? T(1) : a) * r);
    case B_ATAN2: return g * (-a / (a * a + b * b));
    case B_MIN: case B_MAX: return g * b_tie(b, a, r);
    default: return g;  // B_ADD (B_POWC has no exponent partial)
  }
}

// e0 and the gradient g[0..m) of B source `src` at the probe values vals
// and time tt (utils/expr.py eval_tape, rule for rule)
template <typename T>
__device__ void b_eval(const StepArgs<T>& a, long long lane, int src,
                       const T* vals, T tt, T& e0, T* g) {
  const int* meta = a.b_meta + 6 * src;
  const int* ops = a.b_ops + meta[0];
  const int n_ops = meta[1];
  const T* lits = a.b_lits + meta[2];
  const long long coff = meta[5];
  const long long B = a.B;
  DualN<T, BPROBES> st[BSTACK];
  int dep[BSTACK];  // probes each entry depends on (bit j: probe j)
  int sp = 0;
  for (int pc = 0; pc < n_ops; ++pc) {
    const int op = ops[pc] & 0xFF, arg = ops[pc] >> 8;
    if (op <= B_PUSH_CONST) {
      DualN<T, BPROBES>& r = st[sp];
      for (int j = 0; j < BPROBES; ++j) r.d[j] = T(0);
      dep[sp] = 0;
      if (op == B_PUSH_NUM) {
        r.v = lits[arg];
      } else if (op == B_PUSH_PROBE) {
        r.v = vals[arg];
        r.d[arg] = T(1);
        dep[sp] = 1 << arg;
      } else if (op == B_PUSH_TIME) {
        r.v = tt;
      } else {
        r.v = a.bconsts[(coff + arg) * B + lane];
      }
      ++sp;
    } else if (op == B_NEG) {
      DualN<T, BPROBES>& r = st[sp - 1];
      r.v = -r.v;
      for (int j = 0; j < BPROBES; ++j) r.d[j] = -r.d[j];
    } else if (op >= B_SIN && op <= B_CEIL) {
      DualN<T, BPROBES>& r = st[sp - 1];
      const T x = r.v, y = b_unary(op, x);
      if (op == B_FLOOR || op == B_CEIL) {
        dep[sp - 1] = 0;  // symbolic zero tangent
        for (int j = 0; j < BPROBES; ++j) r.d[j] = T(0);
      } else {
        for (int j = 0; j < BPROBES; ++j)
          if (dep[sp - 1] >> j & 1) r.d[j] = b_unary_d(op, r.d[j], x, y);
      }
      r.v = y;
    } else {  // binary: pop b, combine into a
      --sp;
      const DualN<T, BPROBES>& rb = st[sp];
      DualN<T, BPROBES>& ra = st[sp - 1];
      const int ma = dep[sp - 1], mb = op == B_POWC ? 0 : dep[sp];
      const T x = ra.v, y = rb.v, r = b_binary(op, x, y);
      for (int j = 0; j < BPROBES; ++j) {
        const bool ia = ma >> j & 1, ib = mb >> j & 1;
        if (ia && ib)
          ra.d[j] = b_binary_da(op, ra.d[j], x, y, r) +
                    b_binary_db(op, rb.d[j], x, y, r);
        else if (ia)
          ra.d[j] = b_binary_da(op, ra.d[j], x, y, r);
        else if (ib)
          ra.d[j] = b_binary_db(op, rb.d[j], x, y, r);
      }
      ra.v = r;
      dep[sp - 1] = ma | mb;
    }
  }
  e0 = st[0].v;
  for (int j = 0; j < BPROBES; ++j) g[j] = (dep[0] >> j & 1) ? st[0].d[j] : T(0);
}

// One Newton iteration of one lane: xx is the iterate, z0 = G0^-1 b0,
// zb scratch (z, then x_raw, then x_new), qprev the charges of the step's
// incoming x (CHARGE only), tt the step's time (BSRC only).  KCAP is the rank
// capacity: 16 runs the pivoted elimination, 32 the Gauss-Jordan solve; vco
// holds 8 rows with the B rows (BSRC), else 4.
template <typename T, int KCAP, bool CHARGE, bool BSRC>
__device__ __forceinline__ void newton_iter(
    const StepArgs<T>& a, long long lane, T* xx, const T* z0, T* zb, T* cst,
    T (*vco)[KCAP], T (*A)[KCAP], T* bb, T* w, const T* qprev, T tt,
    bool& done, bool& fl) {
  const int N = a.N, k = a.k, W = a.W;
  const long long B = a.B;
  // terminal q of row j (the ground slot reads 0)
  auto rd = [&](int q, int j) -> T {
    const int c = a.row_cols[q * k + j];
    return c < N ? xx[c] : T(0);
  };
  if (k > 0) {
    if constexpr (BSRC) {
      for (int q = 3; q < W; ++q)
        for (int j = 0; j < k; ++j) vco[q][j] = T(0);
    } else if (W > 3) {
      for (int j = 0; j < k; ++j) vco[3][j] = T(0);
    }
    const int nMJ = a.nMJ, nD = a.nD, nQ = a.nQ, nSw = a.nSw;
    for (int j = 0; j < nMJ; ++j) {  // Level-1 MOS and JFET rows
      const T vd = rd(0, j), vg = rd(1, j), vs = rd(2, j);
      const T vth = a.mosp[(0LL * nMJ + j) * B + lane];
      const T kk = a.mosp[(1LL * nMJ + j) * B + lane];
      const T lam = a.mosp[(2LL * nMJ + j) * B + lane];
      const T pp = a.mosp[(3LL * nMJ + j) * B + lane];
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
    for (int d = 0; d < nD; ++d) {  // diode rows: Shockley + breakdown
      const int j = nMJ + d;
      const T isat = a.diop[(0LL * nD + d) * B + lane];
      const T nvt = a.diop[(1LL * nD + d) * B + lane];
      const T bv = a.diop[(2LL * nD + d) * B + lane];
      const T v = rd(0, j) - rd(1, j);
      T e, de;
      exp_lim(v / nvt, e, de);
      T i = isat * (e - T(1));
      T g = isat * de / nvt;
      if (bv > T(0)) {
        const T ibv = a.diop[(3LL * nD + d) * B + lane];
        const T vt = a.diop[(4LL * nD + d) * B + lane];
        exp_lim(-(v + bv) / vt, e, de);
        i -= ibv * e;
        g += ibv * de / vt;
      }
      cst[j] = i - g * v;
      vco[0][j] = g;
      vco[1][j] = -g;
      vco[2][j] = T(0);
    }
    for (int d = 0; d < nQ; ++d) {  // BJT: Ebers-Moll, Ic row then Ib row
      const int j = nMJ + nD + 2 * d;
      const T vc = rd(0, j), vb = rd(1, j), ve = rd(2, j);
      const T isat = a.bjtp[(0LL * nQ + d) * B + lane];
      const T bf = a.bjtp[(1LL * nQ + d) * B + lane];
      const T br = a.bjtp[(2LL * nQ + d) * B + lane];
      const T pq = a.bjtp[(3LL * nQ + d) * B + lane];
      const T vaf = a.bjtp[(4LL * nQ + d) * B + lane];
      const T vt = a.bjtp[(5LL * nQ + d) * B + lane];
      const T vbe = pq * (vb - ve), vbc = pq * (vb - vc);
      T ef, def, er, der;
      exp_lim(vbe / vt, ef, def);
      exp_lim(vbc / vt, er, der);
      const T i_f = isat * (ef - T(1)), i_r = isat * (er - T(1));
      const T gf = isat * def / vt, gr = isat * der / vt;
      T kq = T(1), dkq = T(0);
      if (vaf > T(0)) {  // Early voltage, clamped for a large forward Vbc
        const T raw = T(1) - vbc / vaf;
        kq = raw > T(0.05) ? raw : T(0.05);
        dkq = raw > T(0.05) ? T(-1) / vaf : T(0);
      }
      const T ic_eff = (i_f - i_r) * kq - i_r / br;
      const T ib_eff = i_f / bf + i_r / br;
      const T dic_dvbe = gf * kq;
      const T dic_dvbc = -gr * kq + (i_f - i_r) * dkq - gr / br;
      const T dib_dvbe = gf / bf, dib_dvbc = gr / br;
      const T gc_c = -dic_dvbc, gc_b = dic_dvbe + dic_dvbc, gc_e = -dic_dvbe;
      const T gb_c = -dib_dvbc, gb_b = dib_dvbe + dib_dvbc, gb_e = -dib_dvbe;
      cst[j] = pq * ic_eff - gc_c * vc - gc_b * vb - gc_e * ve;
      cst[j + 1] = pq * ib_eff - gb_c * vc - gb_b * vb - gb_e * ve;
      vco[0][j] = gc_c;
      vco[1][j] = gc_b;
      vco[2][j] = gc_e;
      vco[0][j + 1] = gb_c;
      vco[1][j + 1] = gb_b;
      vco[2][j + 1] = gb_e;
    }
    for (int d = 0; d < nSw; ++d) {  // switch: log-smoothstep conductance
      const int j = nMJ + nD + 2 * nQ + d;
      const T vd = rd(0, j) - rd(1, j), vc = rd(2, j) - rd(3, j);
      const T ron = a.swp[(0LL * nSw + d) * B + lane];
      const T roff = a.swp[(1LL * nSw + d) * B + lane];
      const T svt = a.swp[(2LL * nSw + d) * B + lane];
      const T svh = a.swp[(3LL * nSw + d) * B + lane];
      const T l_on = log_(T(1) / ron), l_off = log_(T(1) / roff);
      const bool has_win = svh > T(0);
      const T width = has_win ? T(2) * svh : T(1);
      const T u = has_win ? clamp01((vc - (svt - svh)) / width)
                          : (vc > svt ? T(1) : T(0));
      const T sm = u * u * (T(3) - T(2) * u);
      const T G = exp_(l_off + (l_on - l_off) * sm);
      const T dsdu = T(6) * u * (T(1) - u);
      const T dG = has_win ? G * (l_on - l_off) * dsdu / width : T(0);
      const T gc = dG * vd;
      const T i0 = G * vd;  // the current is exactly G vd: i0 - gd vd == 0
      cst[j] = (i0 - i0) - gc * vc;
      vco[0][j] = G;
      vco[1][j] = -G;
      vco[2][j] = gc;
      vco[3][j] = -gc;
    }
    if constexpr (BSRC) {  // B rows: the expression's value and gradient
      for (int b = 0; b < a.nB; ++b) {
        const int j = nMJ + nD + 2 * nQ + nSw + b;
        const int m = a.b_meta[6 * b + 3];
        const T sig = a.b_meta[6 * b + 4] ? T(-1) : T(1);
        T vals[BPROBES], g[BPROBES], e0;
        for (int i = 0; i < m; ++i) vals[i] = rd(2 * i, j) - rd(2 * i + 1, j);
        b_eval(a, lane, b, vals, tt, e0, g);
        T gv = T(0);
        for (int i = 0; i < m; ++i) gv += g[i] * vals[i];
        cst[j] = sig * (e0 - gv);
        for (int i = 0; i < m; ++i) {
          vco[2 * i][j] = sig * g[i];
          vco[2 * i + 1][j] = -sig * g[i];
        }
        for (int q = 2 * m; q < 3; ++q) vco[q][j] = T(0);
      }
    }
    if constexpr (CHARGE) {  // charge rows: five per MOS, device-major
      const int o_c = nMJ + nD + 2 * nQ + nSw;  // no B rows with CHARGE
      for (int m = 0; m < a.nMq; ++m) {
        const int j0 = o_c + 5 * m;
        const T vd = rd(0, j0), vg = rd(1, j0), vs = rd(2, j0);
        Dual<T> q[5];
        mos_charges_at(a, lane, m, vd, vg, vs, q);
        for (int r = 0; r < 5; ++r) {
          const int j = j0 + r;
          const T gd = q[r].d[0] * a.inv_dt, gg = q[r].d[1] * a.inv_dt;
          const T gs = q[r].d[2] * a.inv_dt;
          cst[j] = (q[r].v - qprev[5 * m + r]) * a.inv_dt - gd * vd - gg * vg -
                   gs * vs;
          vco[0][j] = gd;
          vco[1][j] = gg;
          vco[2][j] = gs;
        }
      }
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
        for (int q = 0; q < W; ++q)
          s += vco[q][j] * a.Yc3[(((long long)q * k + j) * k + l) * B + lane];
        A[j][l] = s;
      }
      T s = T(0);
      for (int q = 0; q < W; ++q) {
        const int c = a.row_cols[q * k + j];
        s += vco[q][j] * (c < N ? zb[c] : T(0));
      }
      bb[j] = s;
    }
    if constexpr (KCAP <= UNROLL_K) {
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
    } else {  // column-pivoted Gauss-Jordan (pallas_step.py:1126-1160)
      bool used[KCAP];
      int colof[KCAP];
      T rowp[KCAP];
      for (int i = 0; i < k; ++i) used[i] = false;
      for (int c = 0; c < k; ++c) {
        int p = 0;
        T best = used[0] ? T(-1) : absval(A[0][c]);
        for (int i = 1; i < k; ++i) {
          const T v = used[i] ? T(-1) : absval(A[i][c]);
          if (v > best || (isnan_(v) && !isnan_(best))) {
            best = v;
            p = i;
          }
        }
        for (int l = 0; l < k; ++l) rowp[l] = A[p][l];
        const T bp = bb[p];
        const T piv = rowp[c];
        const T safe = piv != T(0) ? piv : T(1);
        for (int i = 0; i < k; ++i) {  // the pivot row subtracts 0 x itself
          const T f = i == p ? T(0) : A[i][c] / safe;
          for (int l = 0; l < k; ++l) A[i][l] -= f * rowp[l];
          bb[i] -= f * bp;
        }
        used[p] = true;
        colof[p] = c;
      }
      for (int p = 0; p < k; ++p) {  // w[c(p)] = bb[p] / A[p][c(p)]
        const T d = A[p][colof[p]];
        w[colof[p]] = bb[p] / (d != T(0) ? d : T(1));
      }
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

// K1c-iii: the noise value of source s at step i (0 for a source without
// noise).  Out of line, as the ring's functions are.
template <typename T>
__device__ __noinline__ T tn_noise(const T* noise, const int* noise_col,
                                   int nN, long long B, long long lane, int i,
                                   int s) {
  const int c = noise_col[s];
  return c < 0 ? T(0) : noise[((long long)i * nN + c) * B + lane];
}

// K1c-ii: the EMFs of step i, E1_j <- w2_j and E2_j <- w1_j of ticks_j steps
// ago (slot (ticks_j - 1 - i) mod Dmax), added into the RHS zb.  Out of line,
// with the few fields it needs as arguments: the ring adds no registers to
// the allocation of the Newton loop.
template <typename T>
__device__ __noinline__ void tl_emfs(const T* ring, const int* tl_read,
                                     const int* tl_plan, int nT, int Dmax,
                                     long long B, long long lane, int i,
                                     T* zb) {
  const int head = i % Dmax;
  for (int j = 0; j < nT; ++j) {
    int slot = tl_read[j] - head;
    if (slot < 0) slot += Dmax;
    const T* r = ring + (long long)slot * 2 * nT * B + lane;
    zb[tl_plan[2 * nT + j]] += r[(long long)(nT + j) * B];
    zb[tl_plan[5 * nT + j]] += r[(long long)j * B];
  }
}

// K1c-ii: push the waves of the accepted x of step i into slot
// (-(i + 1)) mod Dmax, w1 of every line then w2.
template <typename T>
__device__ __noinline__ void tl_push(T* ring, const int* tl_plan,
                                     const T* tl_z0, int nT, int Dmax,
                                     long long B, int N, long long lane,
                                     int i, const T* xx) {
  T* r = ring + (long long)(Dmax - 1 - i % Dmax) * 2 * nT * B + lane;
  for (int q = 0; q < 2 * nT; ++q) {
    const int j = q < nT ? q : q - nT;
    const int* pl = tl_plan + (q < nT ? 0 : 3) * nT + j;
    const int ep = pl[0], em = pl[nT], kk = pl[2 * nT];
    const T d = (ep < N ? xx[ep] : T(0)) - (em < N ? xx[em] : T(0));
    r[(long long)q * B] = add_mul_rn(d, tl_z0[j * B + lane], xx[kk]);
  }
}

template <typename T, int KCAP, bool CHARGE, bool BSRC>
__global__ void __launch_bounds__(128) fused_step_kernel(const StepArgs<T> a) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  const long long B = a.B;
  const int N = a.N;
  T x[MAXN], xp[MAXN], xx[MAXN], z0[MAXN], zb[MAXN + 1];
  T cst[KCAP], vco[BSRC ? 8 : 4][KCAP], A[KCAP][KCAP], bb[KCAP], w[KCAP];
  T qprev[CHARGE ? KCAP : 1];
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
      T v = source_value(a, s, tt, lane);
      if (a.nN)  // this step's TRNOISE value of the source
        v += tn_noise(a.noise, a.noise_col, a.nN, B, lane, i, s);
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
    if (a.nT)  // the EMFs of ticks steps ago, read before this step's push
      tl_emfs(a.ring, a.tl_read, a.tl_plan, a.nT, a.Dmax, B, lane, i, zb);
    for (int n = 0; n < N; ++n) {  // z0 = G0^-1 b0, contraction-major reads
      T acc = T(0);
      for (int m = 0; m < N; ++m)
        acc += a.G0invT[((long long)m * N + n) * B + lane] * zb[m];
      z0[n] = acc;
    }
    for (int n = 0; n < N; ++n)
      xx[n] = a.predictor ? T(2) * x[n] - xp[n] : x[n];
    if constexpr (CHARGE) {  // q_prev = q(x of the previous step)
      const int o_c = a.nMJ + a.nD + 2 * a.nQ + a.nSw;
      for (int m = 0; m < a.nMq; ++m) {
        T v[3];
        for (int q = 0; q < 3; ++q) {
          const int c = a.row_cols[q * a.k + o_c + 5 * m];
          v[q] = c < N ? x[c] : T(0);
        }
        Dual<T> qm[5];
        mos_charges_at(a, lane, m, v[0], v[1], v[2], qm);
        for (int r = 0; r < 5; ++r) qprev[5 * m + r] = qm[r].v;
      }
    }
    bool done = failed, fl = failed;
    int its = 0;
    if (a.unrolled > 0) {
      for (; its < a.unrolled; ++its)
        newton_iter<T, KCAP, CHARGE, BSRC>(a, lane, xx, z0, zb, cst, vco, A,
                                           bb, w, qprev, tt, done, fl);
    } else {
      for (; !done && its < a.max_nr; ++its)
        newton_iter<T, KCAP, CHARGE, BSRC>(a, lane, xx, z0, zb, cst, vco, A,
                                           bb, w, qprev, tt, done, fl);
    }
    it_total += its;
    if (a.ys != nullptr) {  // the probe stream: probe_mat @ x, lane-minor
      T* yi = a.ys + (long long)i * a.nP * B + lane;
      for (int p = 0; p < a.nP; ++p) {
        T acc = T(0);
        for (int n = 0; n < N; ++n) acc += a.probe_mat[p * N + n] * xx[n];
        yi[(long long)p * B] = acc;
      }
    }
    // history from the accepted x
    for (int j = 0; j < a.nCap; ++j) {
      const int ca = a.cap_a[j], cb = a.cap_b[j];
      a.vc[j * B + lane] = (ca < N ? xx[ca] : T(0)) - (cb < N ? xx[cb] : T(0));
    }
    for (int j = 0; j < a.nL; ++j) a.il[j * B + lane] = xx[a.ind_k[j]];
    if (a.nT)  // push this step's waves
      tl_push(a.ring, a.tl_plan, a.tl_z0, a.nT, a.Dmax, B, N, lane, i, xx);
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

template <typename T, int KCAP, bool CHARGE, bool BSRC>
static int launch_as(const StepArgs<T>& a, int threads, void* stream) {
  const int blocks = (a.B + threads - 1) / threads;
  fused_step_kernel<T, KCAP, CHARGE, BSRC>
      <<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ptrs: the 41 arrays in StepArgs order (the charge pack, then the B tapes,
// metadata and constants, then the probe matrix and ys, null without
// probes, then the T-line read slots, plan, Z0 and ring, the ring null
// without lines, then the noise rows and block, null without noise); ints:
// B N k nS P nL nCap unrolled max_nr predictor n_steps step0 threads nMJ
// nD nQ nSw W nMq nB nP nT Dmax nN; reals: dt tol2
// alpha clamp off_gds inv_dt.  B sources launch the B instantiation (k <= 16,
// no charge rows); otherwise k <= 16 launches the elimination instantiation,
// 16 < k <= 32 the Gauss-Jordan one, each with the charge rows when
// nMq > 0.
template <typename T>
static int launch(void* const* ptrs, const long long* ints,
                  const double* reals, void* stream) {
  StepArgs<T> a;
  int p = 0;
  a.G0invT = (const T*)ptrs[p++];
  a.YT = (const T*)ptrs[p++];
  a.Yc3 = (const T*)ptrs[p++];
  a.mosp = (const T*)ptrs[p++];
  a.diop = (const T*)ptrs[p++];
  a.bjtp = (const T*)ptrs[p++];
  a.swp = (const T*)ptrs[p++];
  a.dc = (const T*)ptrs[p++];
  a.pulse = (const T*)ptrs[p++];
  a.sinp = (const T*)ptrs[p++];
  a.pwl_t = (const T*)ptrs[p++];
  a.pwl_v = (const T*)ptrs[p++];
  a.pwl_n = (const int*)ptrs[p++];
  a.gc = (const T*)ptrs[p++];
  a.gl = (const T*)ptrs[p++];
  a.kinds = (const int*)ptrs[p++];
  a.src_pos = (const int*)ptrs[p++];
  a.src_neg = (const int*)ptrs[p++];
  a.ind_k = (const int*)ptrs[p++];
  a.cap_a = (const int*)ptrs[p++];
  a.cap_b = (const int*)ptrs[p++];
  a.row_cols = (const int*)ptrs[p++];
  a.x = (T*)ptrs[p++];
  a.xprev = (T*)ptrs[p++];
  a.vc = (T*)ptrs[p++];
  a.il = (T*)ptrs[p++];
  a.failed = (int*)ptrs[p++];
  a.iters = (int*)ptrs[p++];
  a.mqp = (const T*)ptrs[p++];
  a.b_ops = (const int*)ptrs[p++];
  a.b_lits = (const T*)ptrs[p++];
  a.b_meta = (const int*)ptrs[p++];
  a.bconsts = (const T*)ptrs[p++];
  a.probe_mat = (const T*)ptrs[p++];
  a.ys = (T*)ptrs[p++];
  a.tl_read = (const int*)ptrs[p++];
  a.tl_plan = (const int*)ptrs[p++];
  a.tl_z0 = (const T*)ptrs[p++];
  a.ring = (T*)ptrs[p++];
  a.noise_col = (const int*)ptrs[p++];
  a.noise = (const T*)ptrs[p++];
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
  a.nMJ = (int)ints[13];
  a.nD = (int)ints[14];
  a.nQ = (int)ints[15];
  a.nSw = (int)ints[16];
  a.W = (int)ints[17];
  a.nMq = (int)ints[18];
  a.nB = (int)ints[19];
  a.nP = (int)ints[20];
  a.nT = (int)ints[21];
  a.Dmax = (int)ints[22];
  a.nN = (int)ints[23];
  a.dt = (T)reals[0];
  a.tol2 = (T)reals[1];
  a.alpha = (T)reals[2];
  a.clamp = (T)reals[3];
  a.off_gds = (T)reals[4];
  a.inv_dt = (T)reals[5];
  const int w0 = a.nSw ? 4 : 3;
  if (a.nMJ < 0 || a.nD < 0 || a.nQ < 0 || a.nSw < 0 || a.nMq < 0 ||
      a.nB < 0 || a.nMq > a.nMJ ||
      a.nMJ + a.nD + 2 * a.nQ + a.nSw + a.nB + 5 * a.nMq != a.k ||
      (a.nB ? (a.W < w0 || a.W > 8 || a.k > UNROLL_K || a.nMq)
            : a.W != w0))
    return (int)cudaErrorInvalidValue;
  if (a.N > MAXN || a.k > MAXK || a.N <= 0 || a.k < 0 || threads <= 0 ||
      threads > 128)
    return (int)cudaErrorInvalidValue;
  if (a.nP < 0 || a.nP > MAXPROBES ||
      (a.ys != nullptr && (a.probe_mat == nullptr || a.nP == 0)))
    return (int)cudaErrorInvalidValue;
  if (a.nT < 0 || a.nT > MAXTL ||
      (a.nT && (a.Dmax <= 0 || a.Dmax * 2 * a.nT > MAXRING ||
                a.ring == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.nN < 0 || a.nN > a.nS ||
      (a.nN && (a.noise == nullptr || a.noise_col == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  if (a.nB) return launch_as<T, UNROLL_K, false, true>(a, threads, stream);
  if (a.k <= UNROLL_K)
    return a.nMq ? launch_as<T, UNROLL_K, true, false>(a, threads, stream)
                 : launch_as<T, UNROLL_K, false, false>(a, threads, stream);
  return a.nMq ? launch_as<T, MAXK, true, false>(a, threads, stream)
               : launch_as<T, MAXK, false, false>(a, threads, stream);
}

extern "C" int csim_fused_step_f32(void* const* ptrs, const long long* ints,
                                   const double* reals, void* stream) {
  return launch<float>(ptrs, ints, reals, stream);
}

extern "C" int csim_fused_step_f64(void* const* ptrs, const long long* ints,
                                   const double* reals, void* stream) {
  return launch<double>(ptrs, ints, reals, stream);
}
