"""circuitsimulator_tpu_torch: the PyTorch/CUDA port of circuitsimulator_tpu.

Netlist -> lowering -> MNA assembly -> DC operating point -> Backward-Euler
Woodbury transient -> DC table and CSV, and the .AC small-signal sweep,
single-lane or batched over Monte-Carlo lanes, on one NVIDIA GPU.  Dense
pivoted-LU solves, the fused transient chunk and the fused AC sweep on CUDA
tensors go through hand-written CUDA kernels (``csrc/*.cu``); CPU tensors
take their plain PyTorch versions.  Imports torch, never jax; torch is
imported with the first name taken from the package, so that the CLI's
``--help`` answers without it.
"""

__version__ = "0.1.0"

__all__ = ["Simulator", "SolverOptions", "DEFAULT_OPTIONS"]


def __getattr__(name):
    if name == "Simulator":
        from .api import Simulator
        return Simulator
    if name in ("SolverOptions", "DEFAULT_OPTIONS"):
        from .utils import options
        return getattr(options, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
