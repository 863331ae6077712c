// K1 for Hopper (scopes K1a, K1b, K1c-i, K1c-ii, K1c-iii, K1d-i, K1d-ii and
// K1e):
// the fused Monte-Carlo transient chunk.  Every lane advances n_steps whole
// Backward-Euler timesteps in one launch.
//
// Replaces the TPU kernel circuitsimulator_tpu/ops/pallas_step.py:
// PallasStepRunner._kernel (launched by run_chunk) for R/C/L, V/I sources
// with PULSE/SIN/PWL/EXP/SFFM waveforms, Level-1 MOS without body effect or
// reverse region (K1a), JFET, diode (with reverse breakdown), Ebers-Moll BJT
// (with Early voltage) and S/W switch rows (K1b), the charge rows of
// MOSCAP=CHARGE with Woodbury ranks up to 32 (K1d-i), and the behavioral B
// source rows (K1d-ii, rank <= 16, no charge rows) and the delay ring of the
// lossless transmission lines (K1c-ii, nT <= 8, Dmax x 2 nT <= 1024) and the
// TRNOISE input block (K1c-iii) and the mutual-inductance history (K1e);
// rank
// 0 <= k = nMJ + nD + 2 nQ + nSw + nB + 5 nMq <= 32 (nMq = the MOS count
// under the charge model, else 0).  Per step it computes what the TPU kernel
// computes (plain PyTorch version: circuitsimulator_tpu_torch/ops/
// fused_step.py run_chunk_plain):
//   - source values at t = (step0 + i + 1) * dt in the working type, plus on
//     a noisy run each noisy source's value of the step from the noise
//     block (K1c-iii);
//   - b0 = [sources, -gl*il, gc*vc, E1, E2, -gm*il_b, -gm*il_a] scattered
//     to their rows (the T-line EMFs: E1_j = the wave w2_j of ticks_j steps
//     ago on row k1_j, E2_j = w1_j on row k2_j; K1e: per K element m with
//     gm_m = M_m / dt, -gm_m il[b_m] on the branch row of inductor a_m and
//     -gm_m il[a_m] on b_m's, the -M/dt cross terms being in G0);
//     z0 = G0^-1 b0;
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
// A[i][c] / A[p][c] times it, the pivot row 0 times itself; a zero pivot
// divides by 1; at the end w[c(p)] = bb[p] / A[p][c(p)], a zero divides by
// 1).  In both a NaN |col| counts as the largest (the first NaN wins), as
// torch.max and jnp.argmax rank it.  The Newton loop is the fixed unrolled
// count, or a loop up to max_nr that runs while a lane of the warp is not
// done (as the TPU kernel's block-wide while loop: accept freezes the lanes
// that are done, which count no iteration and raise no failed flag, so
// each lane's x and count are those of a loop of its own).  The TPU kernel
// evaluates both BJT currents on row-duplicated lanes and selects by
// parity; here each device is evaluated once and writes its two rows.
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
// Probe stream (K1c-i): every instantiation writes it when ys is not null.
// Each lane stores its P values at ys[(i P + p) B + lane] and every lane
// reads the (P, N) matrix at the same address, as it reads the B tapes.
// The matrices of StreamingMeasures are +1/-1 pairs, so for a finite x the
// sum is exactly x[a] - x[b] in any order (FMA contraction included): the
// kernel and the plain version agree bit for bit on the same x.
//
// Delay ring (K1c-ii, the TPU kernel's tlw carry, pallas_step.py:1181-1190
// and :1236-1241): the ring (Dmax, 2 nT, B) holds the last Dmax waves of
// each port, lane-minor, in global memory.  The TPU kernel shifts the whole
// ring every step; here it stays in place and a head index moves: at step
// i of the launch the wave d + 1 steps old sits in slot (d - i) mod Dmax,
// and the push writes slot (-(i + 1)) mod Dmax.  A step reads its EMFs
// before its push, so at ticks = Dmax the oldest wave is read before the
// push overwrites it.  The wrapper rolls it back to slot 0 = newest at
// launch exit.  The wave is (V(p) - V(n)) + Z0 i rounded twice (no FMA
// contraction, __fmul_rn and __fadd_rn), as PyTorch computes it, so kernel
// and plain rings agree bit for bit on the same x.
//
// TRNOISE block (K1c-iii, the TPU kernel's noise input, pallas_step.py:
// 1174-1179 with the row scatter of :567-575): the wrapper passes the
// (n_steps, nN, B) block of the chunk's per-step source noise, drawn by
// Engine.trnoise_stream, and per source the row c of the block it takes
// (noise_col, -1 for a source without noise).  Step i adds
// noise[(i nN + c) B + lane] to the source's value before it is scattered,
// so the sum is the plain version's sv + noise, one add per value.
//
// Design: a team of TS = 4, 8, 16 or 32 threads owns one lane for the
// whole launch, several teams to a block (ops/cuda_step.plan: the smallest
// team that holds the k rows of the solve and N rows of x at most three a
// thread, MAXROWS with an explicit team).  TS divides 32, so a team never
// spans two warps, and the teams of a warp run in lockstep: every step and
// every Newton iteration of the fixed count together, and the damped while
// loop as long as one lane of the warp is not done, a done lane frozen by
// accept and counting no iteration (four lanes a warp at TS = 8, not the
// 32 of a thread per lane).  So every shuffle, reduction, ballot and
// __syncwarp names the whole warp: with a run-time team mask nvcc loops
// around each one.
//   - On chip for the whole chunk: at launch each team stages its lane's
//     Y (N, k) and Yc3 (k, W, k), and on the shared route G0^-1 (N, N),
//     from the lane-major constants (a lane's block contiguous) into its
//     shared memory with cp.async; on the registers route (float32, one
//     row of N <= 32 a thread) thread n holds row n of G0^-1 in 32
//     registers instead.  x, x_prev and the iterate stay in registers
//     (thread t, rows t, t + TS, ...), vc and il in shared memory; all of
//     them are read once at launch and written once at exit.
//   - b0: every source, inductor, capacitor and EMF term of the step is
//     computed by one thread into a term vector; row n sums its own terms
//     through a host-made row plan (rhs_ptr, rhs_idx) in the order of the
//     plain version's scatter.  z0 = G0^-1 b0, z = z0 - Y c, x_raw =
//     z - Y w and err^2: the thread of row n sums over m (over j) in index
//     order, its row a word a load at an odd stride, the vector 16 bytes
//     a load (a broadcast read).
//   - Device linearisations: thread d evaluates device d (MOS/JFET, diode,
//     BJT with its two rows, switch, B source, charge MOS with its five
//     rows) and writes its rows' c and V^T coefficients to shared memory,
//     formula for formula the models/*.py linearisations.
//   - S = I + V^T Y and vz on thread j (row j), into the team's augmented
//     k x (k + 1) matrix in shared memory.  The solve: thread j owns row j;
//     each column's pivot is the largest key whose unsigned order is
//     |value| (a NaN largest), ties to the smaller position (row index for
//     Gauss-Jordan), which is the sequential first-maximum scan: redux.sync
//     for a whole-warp team, a shuffle butterfly in its segment for a
//     smaller one.  The elimination pivots by position (no row moves),
//     rows read the pivot row where it lies, 16 bytes at a time, and back
//     substitution runs position by position, each sum over l ascending.
//   - Accept: clamp, alpha damping and the non-finite freeze per row, the
//     finite test by ballot, err^2 summed by every thread in index order
//     n = 0 .. N-1 from shared memory, so done is team-uniform and the
//     comparison with tol^2 sees the same sum on every thread.
//
// What bounds it on the H100: the latency of each lane's chain of
// dependent steps (a column of the solve is a reduction, a division and a
// row update, a Newton iteration some ten __syncwarp), with few warps to
// hide it: G0^-1 in shared memory bounds the lanes resident on an SM (37
// at N = 31 in float32, two waves at B = 8192), and on the junction,
// switch and B decks the device code's exp/log/division chains run on one
// thread of the team.  Not L2: after staging, the only device-memory
// traffic per step is the sources' parameters and the device packs (both
// L1-resident), the ring, the noise block and the probe stream.  wgmma
// does not apply: G0^-1, Y and Yc3 differ per lane (the Monte-Carlo
// perturbs the resistors), each lane multiplies its own matrices by one
// vector per step, and the next vector depends on the x this step
// accepts: matrix-vector products with no reuse, nothing to tile.
// Compiled without fast math (SIN/SFFM arguments reach tens of radians,
// the switch conductance spans nine decades through exp/log); nvcc
// contracts a*b+c into FMAs, so results agree with the plain version to
// rounding.

#include <cuda_runtime.h>
#include <math.h>

#define MAXN 64
#define UNROLL_K 16  // elimination up to this rank, Gauss-Jordan above
#define MAXK 32      // the largest rank
#define MAXPROBES 64 // rows of the probe matrix (K1c-i)
#define MAXTL 8        // transmission lines (K1c-ii)
#define MAXRING 1024   // Dmax x 2 nT waves of the delay ring (K1c-ii)
#define GREG_CAP 32    // the registers route's G0^-1 row (N <= 32)
#define NLAY 17        // the team layout: 13 region offsets, 4 row strides
#define MAXROWS 4      // rows of x a thread owns

// the regions of a team's shared memory (ops/cuda_step.py LAYOUT)
enum Lay {
  L_G, L_Y, L_YC, L_A, L_X, L_Z, L_D, L_C, L_V, L_W, L_TV, L_VC, L_IL,
  S_G, S_Y, S_YC, S_A
};

template <typename T>
struct StepArgs {
  // per-lane constants, lane-major (a lane's block contiguous)
  const T* G0inv;    // (B, N, N)
  const T* Y;        // (B, N, k)
  const T* Yc3;      // (B, k, W, k)
  // device packs and sources, lane-minor (read where they lie)
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
  const int* ind_k;     // (nL) inductor branch rows
  const int* cap_a;     // (nCap) cap terminal pairs
  const int* cap_b;
  const int* row_cols;  // (W, k) columns of each V^T row
  const int* rhs_ptr;   // (N + 1) row n's terms: rhs_idx[rhs_ptr[n]:...]
  const int* rhs_idx;   // term << 1 | negated, in scatter order
  // carry, lane-major, updated in place
  T* x;              // (B, N)
  T* xprev;          // (B, N)
  T* vc;             // (B, nCap)
  T* il;             // (B, nL)
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
  // mutual inductance (K1e): nK = 0 and both null without K elements
  const int* mut_plan;   // (2, nK): the coupled inductors a, b
  const T* gm;           // (nK, B)  M / dt
  int nK;
  // the launch plan: threads per lane, rows of x per thread, lanes per
  // block, T words of shared memory per team and the team's layout
  int team, rows, lpb, team_words;
  int lay[NLAY];
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

// ---- the team: TS threads of one warp that own one lane ----
struct Team {
  unsigned mask;  // the team's threads in its warp
  int t;          // this thread's index in the team
  int size;       // TS
};

// every team of the warp runs the same steps and Newton iterations, so each
// collective (__syncwarp among them) names the whole warp (a run-time team
// mask made nvcc loop around each shuffle); a team's own result is its
// segment of the warp
__device__ __forceinline__ bool team_all(const Team& tm, bool p) {
  return (__ballot_sync(0xffffffffu, p) & tm.mask) == tm.mask;
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

// a (rows, cols) block, contiguous in global memory, into shared memory at
// row stride ld: consecutive threads copy consecutive elements
template <typename T>
__device__ __forceinline__ void stage(T* s, int ld, const T* g, int rows,
                                      int cols, const Team& tm) {
  const int n = rows * cols;
  for (int e = tm.t; e < n; e += tm.size) {
    const int r = e / cols;
    cp_async_el(s + r * ld + (e - r * cols), g + e);
  }
}

// keys whose unsigned order is |x| with every NaN largest; a double in two
// words, high first
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

// a column's pivot over the team: among the candidates the largest |v| (a
// NaN largest), ties to the smallest tag; every thread of the team gets the
// winner's tag.  A non-candidate holds key 0 and no tag, so it loses every
// tie.  A whole-warp team reduces with redux.sync, a smaller one with a
// shuffle butterfly over its first `span` threads (a power of two that
// holds every candidate; the others get no winner and need none).
__device__ __forceinline__ unsigned team_argmax(int TS, int span, bool cand,
                                                float v, unsigned tag) {
  constexpr unsigned FULL = 0xffffffffu;
  unsigned key = cand ? abs_key(v) : 0u, tg = cand ? tag : FULL;
  if (TS == 32) {
    const unsigned kmax = __reduce_max_sync(FULL, key);
    return __reduce_min_sync(FULL, key == kmax ? tg : FULL);
  }
  for (int off = span >> 1; off > 0; off >>= 1) {
    const unsigned ok = __shfl_xor_sync(FULL, key, off, TS);
    const unsigned ot = __shfl_xor_sync(FULL, tg, off, TS);
    if (ok > key || (ok == key && ot < tg)) {
      key = ok;
      tg = ot;
    }
  }
  return tg;
}
__device__ __forceinline__ unsigned team_argmax(int TS, int span, bool cand,
                                                double v, unsigned tag) {
  constexpr unsigned FULL = 0xffffffffu;
  unsigned hi = cand ? abs_key_hi(v) : 0u, lo = cand ? abs_key_lo(v) : 0u;
  unsigned tg = cand ? tag : FULL;
  if (TS == 32) {
    const unsigned hmax = __reduce_max_sync(FULL, hi);
    const unsigned lmax = __reduce_max_sync(FULL, hi == hmax ? lo : 0u);
    return __reduce_min_sync(FULL, hi == hmax && lo == lmax ? tg : FULL);
  }
  for (int off = span >> 1; off > 0; off >>= 1) {
    const unsigned oh = __shfl_xor_sync(FULL, hi, off, TS);
    const unsigned ol = __shfl_xor_sync(FULL, lo, off, TS);
    const unsigned ot = __shfl_xor_sync(FULL, tg, off, TS);
    if (oh > hi || (oh == hi && (ol > lo || (ol == lo && ot < tg)))) {
      hi = oh;
      lo = ol;
      tg = ot;
    }
  }
  return tg;
}

// the regions of a team's shared memory
template <typename T>
struct Smem {
  T *G, *Y, *Yc, *A, *X, *Z, *D, *C, *V, *W, *TV, *VC, *IL;
  int sG, sY, sYc, sA;  // row strides (odd: one row per thread is
                        // conflict-free)
};

// ---- device rows: thread d evaluates device d of the Woodbury row order
// (MOS/JFET, diode, BJT (two rows), switch, B source, charge MOS (five
// rows)) at the iterate xs (index N reads 0) and writes its rows' constant
// c[j] and coefficients v[q k + j], q < W (models/mosfet.py, diode.py,
// bjt.py, switch.py, moscap.py and utils/expr.py eval_tape, formula for
// formula).
template <typename T, int MODE>
__device__ __forceinline__ void device_rows(const StepArgs<T>& a,
                                            long long lane, int d,
                                            const T* xs, T* cs, T* vv,
                                            const T* qprev, T tt) {
  const int k = a.k, W = a.W;
  const long long B = a.B;
  auto rd = [&](int q, int j) -> T { return xs[a.row_cols[q * k + j]]; };
  auto put = [&](int j, T c, T v0, T v1, T v2, T v3) {
    cs[j] = c;
    vv[j] = v0;
    vv[k + j] = v1;
    vv[2 * k + j] = v2;
    for (int q = 3; q < W; ++q) vv[q * k + j] = q == 3 ? v3 : T(0);
  };
  const int nMJ = a.nMJ, nD = a.nD, nQ = a.nQ, nSw = a.nSw;
  if (d < nMJ) {  // Level-1 MOS and JFET rows
    const int j = d;
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
    put(j, pp * ids0 * fac - gd * vd - gg * vg - gs * vs, gd, gg, gs, T(0));
    return;
  }
  d -= nMJ;
  if (d < nD) {  // diode rows: Shockley + breakdown
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
    put(j, i - g * v, g, -g, T(0), T(0));
    return;
  }
  d -= nD;
  if (d < nQ) {  // BJT: Ebers-Moll, Ic row then Ib row
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
    put(j, pq * ic_eff - gc_c * vc - gc_b * vb - gc_e * ve, gc_c, gc_b, gc_e,
        T(0));
    put(j + 1, pq * ib_eff - gb_c * vc - gb_b * vb - gb_e * ve, gb_c, gb_b,
        gb_e, T(0));
    return;
  }
  d -= nQ;
  if (d < nSw) {  // switch: log-smoothstep conductance
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
    put(j, (i0 - i0) - gc * vc, G, -G, gc, -gc);
    return;
  }
  d -= nSw;
  if constexpr (MODE == 2) {  // B rows: the expression's value and gradient
    if (d < a.nB) {
      const int j = nMJ + nD + 2 * nQ + nSw + d;
      const int m = a.b_meta[6 * d + 3];
      const T sig = a.b_meta[6 * d + 4] ? T(-1) : T(1);
      T vals[BPROBES], g[BPROBES], e0;
      for (int i = 0; i < m; ++i) vals[i] = rd(2 * i, j) - rd(2 * i + 1, j);
      b_eval(a, lane, d, vals, tt, e0, g);
      T gv = T(0);
      for (int i = 0; i < m; ++i) gv += g[i] * vals[i];
      cs[j] = sig * (e0 - gv);
      for (int q = 0; q < W; ++q)
        vv[q * k + j] = q < 2 * m ? (q & 1 ? -sig * g[q >> 1] : sig * g[q >> 1])
                                  : T(0);
    }
  }
  if constexpr (MODE == 1) {  // charge rows: five per MOS, device-major
    if (d < a.nMq) {
      const int j0 = nMJ + nD + 2 * nQ + nSw + 5 * d;  // no B rows
      const T vd = rd(0, j0), vg = rd(1, j0), vs = rd(2, j0);
      Dual<T> q[5];
      mos_charges_at(a, lane, d, vd, vg, vs, q);
      for (int r = 0; r < 5; ++r) {
        const T gd = q[r].d[0] * a.inv_dt, gg = q[r].d[1] * a.inv_dt;
        const T gs = q[r].d[2] * a.inv_dt;
        put(j0 + r,
            (q[r].v - qprev[r]) * a.inv_dt - gd * vd - gg * vg - gs * vs, gd,
            gg, gs, T(0));
      }
    }
  }
}

// a[l] -= f p[l] for l from l0, rounded down to a 16-byte boundary, to l1,
// 16 bytes a load and a store: the rows of the solve are 16-byte aligned,
// padded to a whole number of 16 bytes, and every column below l0 that it
// also updates is one the solve never reads again.  With self0 each a[l]
// first subtracts 0 times itself (a pivot row's own step of Gauss-Jordan,
// which turns a -0 into +0 and an infinity into NaN), in the same pass.
__device__ __forceinline__ void row_axpy(float* a, const float* p, float f,
                                         int l0, int l1, bool self0) {
  for (int l = l0 & ~3; l <= l1; l += 4) {
    float4 av = *reinterpret_cast<float4*>(a + l);
    const float4 pv = *reinterpret_cast<const float4*>(p + l);
    if (self0) {
      av.x -= 0.0f * av.x;
      av.y -= 0.0f * av.y;
      av.z -= 0.0f * av.z;
      av.w -= 0.0f * av.w;
    }
    av.x -= f * pv.x;
    av.y -= f * pv.y;
    av.z -= f * pv.z;
    av.w -= f * pv.w;
    *reinterpret_cast<float4*>(a + l) = av;
  }
}
__device__ __forceinline__ void row_axpy(double* a, const double* p,
                                         double f, int l0, int l1,
                                         bool self0) {
  for (int l = l0 & ~1; l <= l1; l += 2) {
    double2 av = *reinterpret_cast<double2*>(a + l);
    const double2 pv = *reinterpret_cast<const double2*>(p + l);
    if (self0) {
      av.x -= 0.0 * av.x;
      av.y -= 0.0 * av.y;
    }
    av.x -= f * pv.x;
    av.y -= f * pv.y;
    *reinterpret_cast<double2*>(a + l) = av;
  }
}

// acc + a[0] b[0] + ... + a[n-1] b[n-1] (SUB: acc - ...), the terms added
// in index order: a is this thread's row (odd stride, one word a load, no
// bank conflict across the team), b the team's vector, 16-byte aligned
// and read 16 bytes a load (a broadcast)
template <bool SUB>
__device__ __forceinline__ float row_dot(float acc, const float* a,
                                         const float* b, int n) {
  int m = 0;
  for (; m + 4 <= n; m += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(b + m);
    if constexpr (SUB) {
      acc -= a[m] * bv.x;
      acc -= a[m + 1] * bv.y;
      acc -= a[m + 2] * bv.z;
      acc -= a[m + 3] * bv.w;
    } else {
      acc += a[m] * bv.x;
      acc += a[m + 1] * bv.y;
      acc += a[m + 2] * bv.z;
      acc += a[m + 3] * bv.w;
    }
  }
  for (; m < n; ++m) {
    if constexpr (SUB) acc -= a[m] * b[m];
    else acc += a[m] * b[m];
  }
  return acc;
}
template <bool SUB>
__device__ __forceinline__ double row_dot(double acc, const double* a,
                                          const double* b, int n) {
  int m = 0;
  for (; m + 2 <= n; m += 2) {
    const double2 bv = *reinterpret_cast<const double2*>(b + m);
    if constexpr (SUB) {
      acc -= a[m] * bv.x;
      acc -= a[m + 1] * bv.y;
    } else {
      acc += a[m] * bv.x;
      acc += a[m + 1] * bv.y;
    }
  }
  if (m < n) {
    if constexpr (SUB) acc -= a[m] * b[m];
    else acc += a[m] * b[m];
  }
  return acc;
}

// the k x k solve of the augmented rows A (k rows of k + 1 at stride sA,
// thread j owns row j) into w; A is overwritten
template <typename T>
__device__ __forceinline__ void team_solve(const Team& tm, int k, T* A,
                                           int sA, T* w) {
  const int t = tm.t;
  T* const Ar = A + t * sA;
  int span = 1;  // the threads that hold rows of the solve, a power of two
  while (span < k) span <<= 1;
  if (k <= UNROLL_K) {  // pivoted elimination by position, no row moves
    int pos = t;
    for (int c = 0; c < k; ++c) {
      const bool cand = t < k && pos >= c;
      const unsigned win = team_argmax(tm.size, span, cand,
                                       cand ? Ar[c] : T(0),
                                       ((unsigned)pos << 5) | (unsigned)t);
      const int pr = (int)(win & 31u), pp = (int)(win >> 5);
      if (pos == c) pos = pp;       // the swap of positions c and pp
      else if (pos == pp) pos = c;
      if (t < k && pos > c) {       // the rows below read the pivot row
        const T* const Ap = A + pr * sA;
        const T piv = Ap[c];
        row_axpy(Ar, Ap, Ar[c] / (piv != T(0) ? piv : T(1)), c + 1, k,
                 false);
      }
      __syncwarp();
    }
    for (int j = k - 1; j >= 0; --j) {  // back substitution
      if (t < k && pos == j) {
        T acc = T(0);
        for (int l = j + 1; l < k; ++l) acc += Ar[l] * w[l];
        const T d = Ar[j];
        w[j] = (Ar[k] - acc) / (d != T(0) ? d : T(1));
      }
      __syncwarp();
    }
  } else {  // column-pivoted Gauss-Jordan (pallas_step.py:1126-1160)
    bool used = false, pend = false;
    int colof = 0;
    for (int c = 0; c < k; ++c) {
      const bool cand = t < k && !used;
      const int pr = (int)team_argmax(tm.size, span, cand,
                                      cand ? Ar[c] : T(0),
                                      (unsigned)t);
      if (t < k && t != pr) {  // last column's pivot row: first itself x 0
        const T* const Ap = A + pr * sA;
        const T piv = Ap[c];
        T f = Ar[c];
        if (pend) f -= T(0) * f;
        row_axpy(Ar, Ap, f / (piv != T(0) ? piv : T(1)), 0, k, pend);
        pend = false;
      }
      if (t == pr) {
        used = pend = true;
        colof = c;
      }
      __syncwarp();
    }
    if (t < k) {
      if (pend) row_axpy(Ar, Ar, T(0), 0, k, false);
      const T d = Ar[colof];  // w[c(p)] = bb[p] / A[p][c(p)]
      w[colof] = Ar[k] / (d != T(0) ? d : T(1));
    }
    __syncwarp();
  }
}

// One Newton iteration of the team's lane: xx (this thread's rows) the
// iterate, z0 = G0^-1 b0, zr scratch (z), qprev the charges of the step's
// incoming x (the charge thread's), tt the step's time (B rows).  A lane
// that is not active (done before a damped iteration that its warp runs
// for other lanes) changes nothing: accept freezes it, and it raises no
// failed flag.
template <typename T, int MODE>
__device__ __forceinline__ void team_iter(const StepArgs<T>& a,
                                          const Team& tm, long long lane,
                                          const Smem<T>& s, T (&xx)[MAXROWS],
                                          const T (&z0)[MAXROWS], T (&zr)[MAXROWS],
                                          const T* qprev, T tt, bool active,
                                          bool& done, bool& fl) {
  const int N = a.N, k = a.k, W = a.W, t = tm.t, TS = tm.size;
  T xraw[MAXROWS];
  if (k > 0) {
    const int nDev = a.nMJ + a.nD + a.nQ + a.nSw + a.nB + a.nMq;
    if (t < nDev) device_rows<T, MODE>(a, lane, t, s.X, s.C, s.V, qprev, tt);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < MAXROWS; ++r) {  // z = z0 - Y c
      const int n = t + r * TS;
      if (r < a.rows && n < N) {
        zr[r] = row_dot<true>(z0[r], s.Y + n * s.sY, s.C, k);
        s.Z[n] = zr[r];
      }
    }
    __syncwarp();
    if (t < k) {  // row j of S = I + V^T Y and vz_j = (V^T z)_j
      const int j = t;
      T vq[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) vq[q] = q < W ? s.V[q * k + j] : T(0);
      T* const Aj = s.A + j * s.sA;
      const T* const yc = s.Yc + j * s.sYc;
      for (int l = 0; l < k; ++l) {
        T acc = (j == l) ? T(1) : T(0);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (q < W) acc += vq[q] * yc[q * k + l];
        Aj[l] = acc;
      }
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q < W) acc += vq[q] * s.Z[a.row_cols[q * k + j]];
      Aj[k] = acc;
    }
    __syncwarp();
    team_solve(tm, k, s.A, s.sA, s.W);
#pragma unroll
    for (int r = 0; r < MAXROWS; ++r) {  // x_raw = z - Y w
      const int n = t + r * TS;
      xraw[r] = zr[r];
      if (r < a.rows && n < N)
        xraw[r] = row_dot<true>(zr[r], s.Y + n * s.sY, s.W, k);
    }
  } else {
#pragma unroll
    for (int r = 0; r < MAXROWS; ++r) xraw[r] = z0[r];  // linear deck: x_raw = z0
  }
  // accept: clamp, damping, tolerance on the damped step, freeze
  bool fin = true;
  T xn[MAXROWS];
#pragma unroll
  for (int r = 0; r < MAXROWS; ++r) {
    const int n = t + r * TS;
    xn[r] = xx[r];
    if (r < a.rows && n < N) {
      fin = fin && finite_(xraw[r]);
      T u = xraw[r] - xx[r];
      if (a.clamp > T(0))
        u = u < -a.clamp ? -a.clamp : (u > a.clamp ? a.clamp : u);
      xn[r] = xx[r] + a.alpha * u;
      s.D[n] = xn[r] - xx[r];
    }
  }
  const bool finite = team_all(tm, fin);
  __syncwarp();
  // err^2 by every thread, in index order: team-uniform
  const T err2 = row_dot<false>(T(0), s.D, s.D, N);
  const bool upd = finite && !done;
  if (upd) {
#pragma unroll
    for (int r = 0; r < MAXROWS; ++r) {
      const int n = t + r * TS;
      xx[r] = xn[r];
      if (r < a.rows && n < N) s.X[n] = xn[r];
    }
  }
  done = done || (upd && err2 < a.tol2) || !finite;
  fl = fl || (!finite && active);
  __syncwarp();
}

// blocks of 256 threads an SM the registers must allow: three (85
// registers) for the float32 K1a/K1b rows with G0^-1 in shared memory,
// whose residency its shared memory bounds first; two (128) for the
// others, whose G0^-1 row, float64 words or device code would spill
#define K1_MIN_BLOCKS(T, GREG, MODE) \
  ((sizeof(T) == 4 && !(GREG) && (MODE) == 0) ? 3 : 2)

// the kernel: one team per lane, lpb teams per block.  GREG: thread n holds
// row n of G0^-1 in registers (float32, N <= 32); MODE 0: the K1a/K1b rows,
// 1: with the charge rows, 2: with the B rows.
template <typename T, bool GREG, int MODE>
__global__ void __launch_bounds__(256, K1_MIN_BLOCKS(T, GREG, MODE))
    fused_step_team(const StepArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TS = a.team;
  const int team = threadIdx.x / TS;
  // a team past the last lane runs lane B - 1's arithmetic beside the
  // others of its warp (their collectives name the whole warp), done from
  // the start, and stores nothing
  const long long lane0 = (long long)blockIdx.x * a.lpb + team;
  const bool live = lane0 < a.B;
  const long long lane = live ? lane0 : a.B - 1;
  Team tm;
  tm.t = threadIdx.x - team * TS;
  tm.size = TS;
  const int base = (threadIdx.x & 31) - tm.t;
  tm.mask = TS == 32 ? 0xffffffffu : ((1u << TS) - 1u) << base;
  const int t = tm.t;
  const int N = a.N, k = a.k, W = a.W;
  const long long B = a.B;
  T* const sm = reinterpret_cast<T*>(smem_raw) + (long long)team * a.team_words;
  Smem<T> s;
  s.G = sm + a.lay[L_G];
  s.Y = sm + a.lay[L_Y];
  s.Yc = sm + a.lay[L_YC];
  s.A = sm + a.lay[L_A];
  s.X = sm + a.lay[L_X];
  s.Z = sm + a.lay[L_Z];
  s.D = sm + a.lay[L_D];
  s.C = sm + a.lay[L_C];
  s.V = sm + a.lay[L_V];
  s.W = sm + a.lay[L_W];
  s.TV = sm + a.lay[L_TV];
  s.VC = sm + a.lay[L_VC];
  s.IL = sm + a.lay[L_IL];
  s.sG = a.lay[S_G];
  s.sY = a.lay[S_Y];
  s.sYc = a.lay[S_YC];
  s.sA = a.lay[S_A];
  // the lane's constants on chip for the whole launch
  if constexpr (!GREG) stage(s.G, s.sG, a.G0inv + lane * N * N, N, N, tm);
  if (k > 0) {
    stage(s.Y, s.sY, a.Y + lane * N * k, N, k, tm);
    stage(s.Yc, s.sYc, a.Yc3 + lane * k * W * k, k, W * k, tm);
  }
  T g[GREG ? GREG_CAP : 1];
  if constexpr (GREG) {
    const T* gr = a.G0inv + (lane * N + (t < N ? t : 0)) * N;
#pragma unroll
    for (int m = 0; m < GREG_CAP; ++m) g[m] = (m < N && t < N) ? gr[m] : T(0);
  }
  // the carry: x and x_prev in registers, vc and il in shared memory
  T xr[MAXROWS], xpr[MAXROWS], xx[MAXROWS], z0[MAXROWS], zr[MAXROWS];
#pragma unroll
  for (int r = 0; r < MAXROWS; ++r) {
    const int n = t + r * TS;
    const bool own = r < a.rows && n < N;
    xr[r] = own ? a.x[lane * N + n] : T(0);
    xpr[r] = own ? a.xprev[lane * N + n] : T(0);
    xx[r] = z0[r] = zr[r] = T(0);
  }
  const int nS = a.nS, nL = a.nL, nCap = a.nCap, nT = a.nT;
  for (int j = t; j < nCap; j += TS) s.VC[j] = a.vc[lane * nCap + j];
  for (int j = t; j < nL; j += TS) s.IL[j] = a.il[lane * nL + j];
  if (t == 0) {
    s.X[N] = T(0);  // the ground slot
    s.Z[N] = T(0);
  }
  // the charge thread: device index t is its MOS's
  const int o_q = a.nMJ + a.nD + a.nQ + a.nSw;
  const int mq = t - o_q;
  T qp[MODE == 1 ? 5 : 1];
  qp[0] = T(0);
  const int o_l = nS, o_c = nS + nL, o_e = nS + nL + nCap;
  const int nK = a.nK, o_m = o_e + 2 * nT;
  bool failed = !live || a.failed[lane] != 0;
  int it_total = 0;
  cp_async_wait_all();
  __syncwarp();
  for (int i = 0; i < a.n_steps; ++i) {
    const T tt = T(a.step0 + i + 1) * a.dt;
    // the step's terms: sources, inductor and capacitor history, EMFs
    for (int sI = t; sI < nS; sI += TS) {
      T v = source_value(a, sI, tt, lane);
      if (a.nN) {  // this step's TRNOISE value of the source
        const int c = a.noise_col[sI];
        if (c >= 0) v += a.noise[((long long)i * a.nN + c) * B + lane];
      }
      s.TV[sI] = v;
    }
    for (int j = t; j < nL; j += TS)
      s.TV[o_l + j] = -(a.gl[j * B + lane] * s.IL[j]);
    // K1e: term 2m, -gm_m il[b_m] (row k_a), term 2m + 1, -gm_m il[a_m]
    for (int q = t; q < 2 * nK; q += TS) {
      const int m = q >> 1;
      const int other = a.mut_plan[(q & 1) ? m : nK + m];
      s.TV[o_m + q] = -(a.gm[m * B + lane] * s.IL[other]);
    }
    for (int j = t; j < nCap; j += TS)
      s.TV[o_c + j] = a.gc[j * B + lane] * s.VC[j];
    if (nT) {  // E1_j <- w2_j, E2_j <- w1_j of ticks_j steps ago
      const int head = i % a.Dmax;
      for (int q = t; q < 2 * nT; q += TS) {
        const int j = q >> 1;
        int slot = a.tl_read[j] - head;
        if (slot < 0) slot += a.Dmax;
        s.TV[o_e + q] = a.ring[((long long)slot * 2 * nT +
                                ((q & 1) ? j : nT + j)) * B + lane];
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < MAXROWS; ++r) {  // b0: row n's terms in scatter order
      const int n = t + r * TS;
      if (r < a.rows && n < N) {
        T acc = T(0);
        for (int e = a.rhs_ptr[n]; e < a.rhs_ptr[n + 1]; ++e) {
          const int c = a.rhs_idx[e];
          const T v = s.TV[c >> 1];
          acc = (c & 1) ? acc - v : acc + v;
        }
        s.Z[n] = acc;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < MAXROWS; ++r) {  // z0 = G0^-1 b0, m in order
      const int n = t + r * TS;
      T acc = T(0);
      if (r < a.rows && n < N) {
        if constexpr (GREG) {  // float32: b0 16 bytes a load
#pragma unroll
          for (int m = 0; m < GREG_CAP; m += 4) {
            if (m < N) {
              const float4 zv = *reinterpret_cast<const float4*>(s.Z + m);
              acc += g[m] * zv.x;
              if (m + 1 < N) acc += g[m + 1] * zv.y;
              if (m + 2 < N) acc += g[m + 2] * zv.z;
              if (m + 3 < N) acc += g[m + 3] * zv.w;
            }
          }
        } else {
          acc = row_dot<false>(acc, s.G + n * s.sG, s.Z, N);
        }
      }
      z0[r] = acc;
      xx[r] = a.predictor ? T(2) * xr[r] - xpr[r] : xr[r];
    }
    if constexpr (MODE == 1) {  // q_prev = q(x of the previous step)
#pragma unroll
      for (int r = 0; r < MAXROWS; ++r) {
        const int n = t + r * TS;
        if (r < a.rows && n < N) s.X[n] = xr[r];
      }
      __syncwarp();
      if (mq >= 0 && mq < a.nMq) {
        const int j0 = a.nMJ + a.nD + 2 * a.nQ + a.nSw + 5 * mq;  // its rows
        Dual<T> qm[5];
        mos_charges_at(a, lane, mq, s.X[a.row_cols[j0]],
                       s.X[a.row_cols[k + j0]], s.X[a.row_cols[2 * k + j0]],
                       qm);
        for (int r = 0; r < 5; ++r) qp[r] = qm[r].v;
      }
      __syncwarp();
    }
#pragma unroll
    for (int r = 0; r < MAXROWS; ++r) {
      const int n = t + r * TS;
      if (r < a.rows && n < N) s.X[n] = xx[r];
    }
    __syncwarp();  // also orders the z0 reads of Z before z is written
    bool done = failed, fl = failed;
    int its = 0;
    if (a.unrolled > 0) {
      for (; its < a.unrolled; ++its)
        team_iter<T, MODE>(a, tm, lane, s, xx, z0, zr, qp, tt, true, done,
                           fl);
    } else {  // the warp iterates while one of its lanes is not done
      for (int w = 0; w < a.max_nr; ++w) {
        const bool active = !done;
        if (!__any_sync(0xffffffffu, active)) break;
        team_iter<T, MODE>(a, tm, lane, s, xx, z0, zr, qp, tt, active, done,
                           fl);
        its += active;
      }
    }
    it_total += its;
    if (live && a.ys != nullptr) {  // the probe stream: probe_mat @ x
      T* yi = a.ys + (long long)i * a.nP * B + lane;
      for (int p = t; p < a.nP; p += TS) {
        T acc = T(0);
        for (int n = 0; n < N; ++n) acc += a.probe_mat[p * N + n] * s.X[n];
        yi[(long long)p * B] = acc;
      }
    }
    // history from the accepted x
    for (int j = t; j < nCap; j += TS)
      s.VC[j] = s.X[a.cap_a[j]] - s.X[a.cap_b[j]];
    for (int j = t; j < nL; j += TS) s.IL[j] = s.X[a.ind_k[j]];
    if (live && nT) {  // push this step's waves into slot -(i + 1) mod Dmax
      T* rg = a.ring + (long long)(a.Dmax - 1 - i % a.Dmax) * 2 * nT * B +
              lane;
      for (int q = t; q < 2 * nT; q += TS) {
        const int j = q < nT ? q : q - nT;
        const int* pl = a.tl_plan + (q < nT ? 0 : 3) * nT + j;
        const T d = s.X[pl[0]] - s.X[pl[nT]];
        rg[(long long)q * B] = add_mul_rn(d, a.tl_z0[j * B + lane],
                                          s.X[pl[2 * nT]]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < MAXROWS; ++r) {
      xpr[r] = xr[r];
      xr[r] = xx[r];
    }
    failed = fl;
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < MAXROWS; ++r) {
    const int n = t + r * TS;
    if (r < a.rows && n < N) {
      a.x[lane * N + n] = xr[r];
      a.xprev[lane * N + n] = xpr[r];
    }
  }
  for (int j = t; j < nCap; j += TS) a.vc[lane * nCap + j] = s.VC[j];
  for (int j = t; j < nL; j += TS) a.il[lane * nL + j] = s.IL[j];
  if (t == 0) {
    a.failed[lane] = failed ? 1 : 0;
    a.iters[lane] = it_total;
  }
}

template <typename T, bool GREG, int MODE>
static int launch_as(const StepArgs<T>& a, void* stream) {
  const size_t smem = (size_t)a.lpb * a.team_words * sizeof(T);
  auto kern = fused_step_team<T, GREG, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (a.B + a.lpb - 1) / a.lpb;
  kern<<<blocks, a.lpb * a.team, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int pick(const StepArgs<T>& a, bool greg, void* stream) {
  const int mode = a.nB ? 2 : (a.nMq ? 1 : 0);
  if constexpr (sizeof(T) == 4) {
    if (greg)
      return mode == 2   ? launch_as<T, true, 2>(a, stream)
             : mode == 1 ? launch_as<T, true, 1>(a, stream)
                         : launch_as<T, true, 0>(a, stream);
  }
  return mode == 2   ? launch_as<T, false, 2>(a, stream)
         : mode == 1 ? launch_as<T, false, 1>(a, stream)
                     : launch_as<T, false, 0>(a, stream);
}

// ptrs: the 43 arrays in StepArgs order (the charge pack, then the B tapes,
// metadata and constants, then the probe matrix and ys, null without
// probes, then the T-line read slots, plan, Z0 and ring, the ring null
// without lines, then the noise rows and block, null without noise, then
// the K plan and gm, null without K); ints: B N k nS P nL nCap unrolled
// max_nr predictor n_steps step0 route nMJ nD nQ nSw W nMq nB nP nT Dmax
// nN, then the plan: team rows lpb team_words and the 17 layout entries
// (ops/cuda_step.py LAYOUT), then nK; route 1 holds G0^-1 in registers
// (float32 only); reals: dt tol2 alpha clamp off_gds inv_dt.
template <typename T>
static int launch(void* const* ptrs, const long long* ints,
                  const double* reals, void* stream) {
  StepArgs<T> a;
  int p = 0;
  a.G0inv = (const T*)ptrs[p++];
  a.Y = (const T*)ptrs[p++];
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
  a.ind_k = (const int*)ptrs[p++];
  a.cap_a = (const int*)ptrs[p++];
  a.cap_b = (const int*)ptrs[p++];
  a.row_cols = (const int*)ptrs[p++];
  a.rhs_ptr = (const int*)ptrs[p++];
  a.rhs_idx = (const int*)ptrs[p++];
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
  a.mut_plan = (const int*)ptrs[p++];
  a.gm = (const T*)ptrs[p++];
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
  const bool greg = ints[12] != 0;
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
  a.team = (int)ints[24];
  a.rows = (int)ints[25];
  a.lpb = (int)ints[26];
  a.team_words = (int)ints[27];
  for (int i = 0; i < NLAY; ++i) a.lay[i] = (int)ints[28 + i];
  a.nK = (int)ints[28 + NLAY];
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
  if (a.N > MAXN || a.k > MAXK || a.N <= 0 || a.k < 0)
    return (int)cudaErrorInvalidValue;
  if (a.team < 2 || a.team > 32 || (a.team & (a.team - 1)) || a.rows < 1 ||
      a.rows > MAXROWS || a.team * a.rows < a.N || a.team < a.k || a.lpb <= 0 ||
      a.lpb * a.team > 256 || (a.lpb * a.team) % 32 || a.team_words <= 0 ||
      (size_t)a.lpb * a.team_words * sizeof(T) > 232448 ||
      (greg && (sizeof(T) != 4 || a.rows != 1 || a.N > GREG_CAP)))
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
  if (a.nK < 0 ||
      (a.nK && (a.nL < 2 || a.mut_plan == nullptr || a.gm == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  return pick(a, greg, stream);
}

extern "C" int csim_fused_step_f32(void* const* ptrs, const long long* ints,
                                   const double* reals, void* stream) {
  return launch<float>(ptrs, ints, reals, stream);
}

extern "C" int csim_fused_step_f64(void* const* ptrs, const long long* ints,
                                   const double* reals, void* stream) {
  return launch<double>(ptrs, ints, reals, stream);
}

// registers and local (stack) bytes per thread of the instantiation that a
// launch of this type, route and mode takes (0 on success)
extern "C" int csim_fused_step_attrs(int f64, int greg, int mode,
                                     int* regs, int* local_bytes) {
  cudaFuncAttributes at;
  cudaError_t e;
  if (f64)
    e = mode == 2   ? cudaFuncGetAttributes(&at, fused_step_team<double, false, 2>)
        : mode == 1 ? cudaFuncGetAttributes(&at, fused_step_team<double, false, 1>)
                    : cudaFuncGetAttributes(&at, fused_step_team<double, false, 0>);
  else if (greg)
    e = mode == 2   ? cudaFuncGetAttributes(&at, fused_step_team<float, true, 2>)
        : mode == 1 ? cudaFuncGetAttributes(&at, fused_step_team<float, true, 1>)
                    : cudaFuncGetAttributes(&at, fused_step_team<float, true, 0>);
  else
    e = mode == 2   ? cudaFuncGetAttributes(&at, fused_step_team<float, false, 2>)
        : mode == 1 ? cudaFuncGetAttributes(&at, fused_step_team<float, false, 1>)
                    : cudaFuncGetAttributes(&at, fused_step_team<float, false, 0>);
  if (e != cudaSuccess) return (int)e;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  return 0;
}
