"""Solver options: the fields and reference defaults of
``circuitsimulator_tpu/utils/options.py`` with a torch ``dtype``.

Every knob the reference hard-codes keeps the reference value as its
default (DC ramp and ConvController constants, transient Newton constants,
the LU pivot floor), so the default configuration reproduces reference
numerics.  ``mos_cap_model`` is "fixed" (the reference's lumped MOS caps)
or "charge" (the charge-conserving model, ``models/moscap.py``).
``tran_method`` is "be" or "trap" (the trapezoidal companions),
``tran_solver`` "woodbury", "lu" (with ``tran_mixed_refine``, its float32
correction solve around a float64 residual), or one of the large-circuit
backends "tridiag" (bordered cyclic reduction, ``tridiag_algo`` "pcr" or
"cr"), "blockband" (RCM block-banded block CR) and "blockwb" (the
pre-factored block CR under Woodbury rows); ``dc_solver`` "lu", "gs"
(Gauss-Seidel, ``gs_*``), "tridiag" (always CR: the DC can be
near-singular) or "blockband".  ``auto_backend`` lets ``Simulator`` pick
the large-circuit backend above 128 node equations.  The adaptive ladder
reads ``tran_max_refine_levels``, ``tran_lte_rtol``, ``tran_lte_atol`` and
``tran_adaptive_alpha`` (``analysis/adaptive.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    # --- DC operating point ---
    ramp_steps: int = 10
    dc_max_newton_iters: int = 50
    dc_tol: float = 1e-9
    # ConvController constants (src/dcanalysis.cpp:264-265)
    alpha_min: float = 0.1
    alpha_max: float = 0.5
    alpha_const: float = 0.35          # the value clamped at dcanalysis.cpp:274
    gmin_high_base: float = 1e-6
    gmin_low_base: float = 3.35e-7
    gmin_abs_max: float = 1e-4
    fast_conv_ratio: float = 0.7
    slow_conv_ratio: float = 1.05
    gmin_nonfinite_factor: float = 10.0
    gmin_nonfinite_max: float = 1e-2

    # --- Transient ---
    tran_method: str = "be"
    tran_max_newton_iters: int = 50
    tran_tol: float = 1e-6
    tran_gmin: float = 1e-6
    tran_alpha: float = 0.45
    tran_solver: str = "woodbury"
    dc_solver: str = "lu"
    tran_max_refine_levels: int = 8
    tran_lte_rtol: float = 1e-3
    tran_lte_atol: float = 1e-6
    tran_adaptive_alpha: float = 1.0
    # start each step's Newton from 2x - x_prev (changes the damped
    # trajectory; off for reference parity)
    tran_predictor: bool = False
    # fixed Newton iterations per step, no convergence test (0 = loop
    # until converged or tran_max_newton_iters)
    tran_unrolled_iters: int = 0
    tridiag_algo: str = "pcr"
    tran_newton_clamp: float = 0.0
    tran_mixed_refine: bool = False
    auto_backend: bool = True

    # --- Linear solver ---
    lu_pivot_floor: float = 1e-15
    gs_max_iters: int = 2000
    gs_tol: float = 1e-10
    gs_diag_eps: float = 1e-12

    # --- Numerics / engine ---
    dtype: Any = torch.float64
    strict_reference_mode: bool = True
    mos_off_gds: float = 1e-12
    mos_reverse_region: bool = False
    mos_cap_model: str = "fixed"      # "fixed" | "charge" (MOSCAP=CHARGE)

    def replace(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)


DEFAULT_OPTIONS = SolverOptions()
