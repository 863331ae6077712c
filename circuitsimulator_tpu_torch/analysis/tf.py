"""DC transfer function (``.TF output input_source``); port of
``circuitsimulator_tpu/analysis/tf.py``.

Linearise the circuit at the polished DC operating point (the stamped
Jacobian J = dr/dx of ``.SENS``, analysis/sensitivity.py) and report

    gain = c^T J^{-1} b_in            (one forward solve)
    Rout = c^T J^{-1} c               (one forward solve, V outputs)
    Rin  = from the forward solve's branch-current / terminal rows

b_in is the RHS derivative with respect to the input source's value (the
branch row e_k of a V source; -e_p + e_m of an I source, the reference's RHS
convention) and c selects the output (e_out - e_ref for V(out, ref), the
branch row for I(Vxxx)).  Sign conventions:

  * V-source input: the branch unknown is the current flowing from the +
    terminal into the source, so Rin = -1 / (d i_br / d Vin);
  * I-source input: Rin = d (V(m) - V(p)) / d Iin;
  * Rout injects a unit test current into the output pair with the input's
    small-signal contribution zero.

Every solve goes through ``lu_solve`` (K2 on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..ops.assemble import Engine
from ..ops.lu import lu_solve
from .dc import dc_operating_point
from .sensitivity import _polish, _unit, dc_jacobian


@dataclasses.dataclass
class TFResult:
    gain: Any          # d out / d input-source-value
    r_in: Any          # input resistance seen by the input source (ohm)
    r_out: Any         # output resistance at the probe; None for I(..) out
    x_op: Any          # polished DC operating point used for linearization


@torch.inference_mode()
def dc_transfer_function(engine: Engine, params,
                         out_kind: str, out_a: int, out_b: int,
                         input_ref, x: Optional[Any] = None,
                         polish_iters: int = 3) -> TFResult:
    """Small-signal DC transfer function.

    out_kind: "v" -> output is V(eq=out_a) - V(eq=out_b if >= 0 else gnd);
              "i" -> output is the branch current x[out_a] (out_b unused).
    input_ref: ("v", branch_eq) for a V-source input or ("i", ep, em) for
               an I-source input (node eq indices; the dump slot N of
               ir/lower.py counts as ground).
    """
    if x is None:
        x = dc_operating_point(engine, params)
    x = _polish(engine, params, x, polish_iters)
    N = engine.N
    J = dc_jacobian(engine, params, x)
    floor = engine.opts.lu_pivot_floor
    zero = torch.zeros((), dtype=engine.dtype, device=engine.device)

    # RHS derivative with respect to the input source value
    if input_ref[0] == "v":
        b_in = _unit(engine, int(input_ref[1]))
    else:
        _, ep, em = input_ref
        b_in = _unit(engine, int(em), int(ep))
    dx = lu_solve(J, b_in, floor)                 # d x / d Vin|Iin

    c = _unit(engine, int(out_a),
              int(out_b) if out_kind == "v" else -1)
    gain = torch.dot(c, dx)

    if input_ref[0] == "v":
        r_in = -1.0 / dx[int(input_ref[1])]
    else:
        _, ep, em = input_ref
        dv_m = dx[int(em)] if 0 <= int(em) < N else zero
        dv_p = dx[int(ep)] if 0 <= int(ep) < N else zero
        r_in = dv_m - dv_p

    r_out = None
    if out_kind == "v":
        r_out = torch.dot(c, lu_solve(J, c, floor))
    return TFResult(gain=gain, r_in=r_in, r_out=r_out, x_op=x)


def tf_report(result: TFResult, out_label: str, input_name: str) -> str:
    r_in = float(result.r_in)
    r_in_txt = "inf" if not math.isfinite(r_in) else f"{r_in: .6e}"
    lines = [
        "==== Transfer function ====",
        f"d{out_label}/d{input_name} = {float(result.gain): .6e}",
        f"input resistance at {input_name} = {r_in_txt}",
    ]
    if result.r_out is not None:
        lines.append(
            f"output resistance at {out_label} = {float(result.r_out): .6e}")
    return "\n".join(lines)
