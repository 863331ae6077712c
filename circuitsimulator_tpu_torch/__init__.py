"""circuitsimulator_tpu_torch: the PyTorch/CUDA port of circuitsimulator_tpu.

Netlist -> lowering -> MNA assembly -> DC operating point -> Backward-Euler
Woodbury transient -> DC table and CSV, single-lane or batched over
Monte-Carlo lanes, on one NVIDIA GPU.  Dense pivoted-LU solves on CUDA
tensors go through a hand-written CUDA kernel (``csrc/lu_batched.cu``);
CPU tensors take its plain PyTorch version.  Imports torch, never jax.
"""

from .api import Simulator
from .utils.options import DEFAULT_OPTIONS, SolverOptions

__version__ = "0.1.0"

__all__ = ["Simulator", "SolverOptions", "DEFAULT_OPTIONS"]
