// K2 for Hopper: B independent dense N x N solves with partial pivoting.
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
// R right-hand sides share one factorisation; each column is computed by the
// same instruction sequence as a single-RHS solve.
//
// Design: one thread per lane, lane-minor layout (the wrapper passes
// A as (N, N, B) and b as (N, R, B)), so the 32 threads of a warp touch 32
// consecutive addresses on every access.  A and b are scratch copies the
// kernel overwrites in place; x is (N, R, B).
//
// What bounds it on the H100: at B=8192, N=31 a f32 batch is 31 MB, which
// fits in the 50 MB L2; the O(N^3) elimination re-reads the trailing block
// from L2 every column, so the solve is bound by L2 bandwidth and latency,
// not arithmetic.  The Woodbury k x k solves (k = 4..6) are tiny and bound
// by launch overhead.  Keeping each lane's matrix in registers or shared
// memory is later work.  Compiled without fast math; nvcc contracts
// a - f*b into an FMA, so results agree with the plain PyTorch version to
// rounding, not bitwise.

#include <cuda_runtime.h>
#include <math.h>

template <typename T>
__device__ __forceinline__ T absval(T v) { return v < T(0) ? -v : v; }

template <typename T>
__device__ __forceinline__ bool isnan_(T v) { return v != v; }

template <typename T>
__global__ void lu_solve_kernel(T* __restrict__ A, T* __restrict__ b,
                                T* __restrict__ x, int B, int N, int R,
                                T pivot_floor) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const long long sB = B;
  // element (i, j) of this lane's matrix / right-hand sides / solution
#define A_(i, j) A[((long long)(i) * N + (j)) * sB + lane]
#define B_(i, r) b[((long long)(i) * R + (r)) * sB + lane]
#define X_(i, r) x[((long long)(i) * R + (r)) * sB + lane]

  T minpiv = T(INFINITY);
  for (int k = 0; k < N; ++k) {
    int p = k;
    T best = absval(A_(k, k));
    for (int i = k + 1; i < N; ++i) {
      const T v = absval(A_(i, k));
      if (v > best || (isnan_(v) && !isnan_(best))) {
        best = v;
        p = i;
      }
    }
    // sticky NaN, like jnp.minimum
    if (best < minpiv || isnan_(best)) minpiv = best;
    if (p != k) {
      for (int j = k; j < N; ++j) {
        const T t = A_(k, j);
        A_(k, j) = A_(p, j);
        A_(p, j) = t;
      }
      for (int r = 0; r < R; ++r) {
        const T t = B_(k, r);
        B_(k, r) = B_(p, r);
        B_(p, r) = t;
      }
    }
    const T piv = A_(k, k);
    const T safe = (piv != T(0)) ? piv : T(1);
    for (int i = k + 1; i < N; ++i) {
      const T f = A_(i, k) / safe;
      for (int j = k + 1; j < N; ++j) A_(i, j) = A_(i, j) - f * A_(k, j);
      for (int r = 0; r < R; ++r) B_(i, r) = B_(i, r) - f * B_(k, r);
    }
  }

  const bool fail = minpiv < pivot_floor;
  for (int j = N - 1; j >= 0; --j) {
    const T d = A_(j, j);
    const bool tiny = absval(d) < pivot_floor;
    const T dd = (d != T(0)) ? d : T(1);
    for (int r = 0; r < R; ++r) {
      T acc = T(0);
      for (int i = j + 1; i < N; ++i) acc += A_(j, i) * X_(i, r);
      const T s = B_(j, r) - acc;
      X_(j, r) = tiny ? T(0) : s / dd;
    }
  }
  if (fail) {
    for (int i = 0; i < N; ++i)
      for (int r = 0; r < R; ++r) X_(i, r) = T(0);
  }
#undef A_
#undef B_
#undef X_
}

template <typename T>
static int launch(void* A, void* b, void* x, int B, int N, int R,
                  double pivot_floor, void* stream) {
  if (B <= 0 || N <= 0 || R <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  lu_solve_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (T*)A, (T*)b, (T*)x, B, N, R, (T)pivot_floor);
  return (int)cudaGetLastError();
}

extern "C" int csim_lu_solve_f32(void* A, void* b, void* x, int B, int N,
                                 int R, double pivot_floor, void* stream) {
  return launch<float>(A, b, x, B, N, R, pivot_floor, stream);
}

extern "C" int csim_lu_solve_f64(void* A, void* b, void* x, int B, int N,
                                 int R, double pivot_floor, void* stream) {
  return launch<double>(A, b, x, B, N, R, pivot_floor, stream);
}
