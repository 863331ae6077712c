"""Assembly, Woodbury, LU and AC-sweep solvers; the CUDA kernel wrappers
and their build."""
