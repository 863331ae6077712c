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
// Design: one warp per (lane, frequency) system, its complex matrix in
// shared memory as a real and an imaginary plane with row stride
// ld = N rounded up to an odd number, so that 32 lanes reading one column
// hit 32 banks.  Nothing per system reaches device memory except its
// solution.  Per column k:
//   pivot search  lane i reads rows i and i + 32 of column k; a shuffle
//                 argmax picks the largest |a|^2, ties to the lower row;
//   row swap      lane j swaps column j of rows k and p;
//   factors       lane i computes f_i for its rows i > k, keeps it in
//                 column k and updates its right-hand-side entries;
//   update        lane j updates column j > k of every row i > k (f_i is a
//                 broadcast read, A[i][j] a conflict-free one);
// then back substitution: lane m holds x_m, each row sum is a shuffle
// reduction.  The thread-per-system layout of K2 and K1a was not taken:
// the 2 N^2 working set (7.7 KB at N = 31 in f32) does not fit in
// registers, and in local memory at 2,048 resident threads per SM it would
// stream through L2 on every column.
//
// What bounds it on the H100: operations, about 8N^3/3 + 5N^2 per system
// (84 k at N = 31).  The inputs are read once per lane from device memory,
// then from L2 for the lane's other frequencies.  Where the trailing block
// is narrower than 32 columns, lanes of the warp idle: the update keeps on
// average about half of them busy.  Compiled without fast math (IEEE
// division); nvcc's default contraction turns a*b + c into FMAs, so the
// results agree with the plain version to rounding, not bitwise.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAXN = 64;
constexpr int MAX_WARPS = 4;                 // systems (warps) per block
constexpr size_t SMEM_TARGET = 96 * 1024;    // dynamic shared memory per block

__host__ __device__ inline int row_stride(int n) { return n | 1; }

// elements of one warp's shared-memory slice: Ar, Ai (n x ld), rr, ri (n)
__host__ __device__ inline long long warp_elems(int n) {
  return 2LL * n * row_stride(n) + 2LL * n;
}

template <typename T>
__global__ void __launch_bounds__(32 * MAX_WARPS)
ac_sweep_kernel(const T* __restrict__ G, const T* __restrict__ B1,
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
        const T ob = __shfl_xor_sync(FULL, best, off);
        const int op = __shfl_xor_sync(FULL, p, off);
        if (ob > best || (ob == best && op < p)) {
          best = ob;
          p = op;
        }
      }
      if (__any_sync(FULL, nan_seen)) {
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
        sr += __shfl_xor_sync(FULL, sr, off);
        si += __shfl_xor_sync(FULL, si, off);
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

template <typename T>
int launch(const void* G, const void* B1, const void* br, const void* bi,
           const void* om, void* xr, void* xi, int B, int F, int n,
           double pivot_floor, void* stream) {
  if (B <= 0 || F <= 0) return 0;
  if (n <= 0 || n > MAXN) return (int)cudaErrorInvalidValue;
  const size_t per_warp = (size_t)warp_elems(n) * sizeof(T);
  size_t warps = SMEM_TARGET / per_warp;
  warps = warps < 1 ? 1 : (warps > MAX_WARPS ? MAX_WARPS : warps);
  const size_t smem = per_warp * warps;
  cudaError_t err = cudaFuncSetAttribute(
      ac_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_sys = (long long)B * F;
  long long blocks = (n_sys + (long long)warps - 1) / (long long)warps;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;   // grid-stride beyond
  ac_sweep_kernel<T><<<(unsigned)blocks, (unsigned)(32 * warps), smem,
                       (cudaStream_t)stream>>>(
      (const T*)G, (const T*)B1, (const T*)br, (const T*)bi, (const T*)om,
      (T*)xr, (T*)xi, F, n, (T)(pivot_floor * pivot_floor), n_sys);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int csim_ac_sweep_f32(const void* G, const void* B1,
                                 const void* br, const void* bi,
                                 const void* om, void* xr, void* xi, int B,
                                 int F, int n, double pivot_floor,
                                 void* stream) {
  return launch<float>(G, B1, br, bi, om, xr, xi, B, F, n, pivot_floor,
                       stream);
}

extern "C" int csim_ac_sweep_f64(const void* G, const void* B1,
                                 const void* br, const void* bi,
                                 const void* om, void* xr, void* xi, int B,
                                 int F, int n, double pivot_floor,
                                 void* stream) {
  return launch<double>(G, B1, br, bi, om, xr, xi, B, F, n, pivot_floor,
                        stream);
}
