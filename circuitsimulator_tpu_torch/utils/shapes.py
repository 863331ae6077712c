"""Shape arithmetic on the host."""

from __future__ import annotations

import torch


def broadcast_shapes(*shapes) -> torch.Size:
    """``torch.broadcast_shapes`` of shape tuples, in plain Python: the
    torch function goes through its symbolic-shape checks, tens to hundreds
    of microseconds a call, and the engine calls it every Newton
    iteration."""
    n = max((len(s) for s in shapes), default=0)
    out = [1] * n
    for s in shapes:
        for i, d in enumerate(s, n - len(s)):
            if d != 1:
                if out[i] != 1 and out[i] != d:
                    raise RuntimeError(
                        f"shapes {[tuple(s) for s in shapes]} do not "
                        "broadcast")
                out[i] = d
    return torch.Size(out)
