"""circuitsimulator_tpu_torch: the PyTorch/CUDA port of circuitsimulator_tpu.

Netlist -> lowering -> MNA assembly -> DC operating point -> Backward-Euler
Woodbury transient -> DC table and CSV, and the .AC small-signal sweep,
single-lane or batched over Monte-Carlo lanes, on one NVIDIA GPU.  Dense
pivoted-LU solves, the fused transient chunk and the fused AC sweep on CUDA
tensors go through hand-written CUDA kernels (``csrc/*.cu``); CPU tensors
take their plain PyTorch versions.  Imports torch, never jax.
"""

from .api import Simulator
from .utils.options import DEFAULT_OPTIONS, SolverOptions

__version__ = "0.1.0"

__all__ = ["Simulator", "SolverOptions", "DEFAULT_OPTIONS"]
