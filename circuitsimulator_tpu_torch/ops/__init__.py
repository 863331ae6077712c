"""Assembly, Woodbury and LU solvers; the CUDA kernel wrapper and build."""
