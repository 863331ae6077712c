"""`.FOUR` — Fourier analysis of transient waveforms (port of
``circuitsimulator_tpu/analysis/fourier.py``; numpy on the host).

Classic SPICE post-processor: after a `.TRAN` run, decompose named outputs
over the LAST full period of the fundamental into DC + n_harm harmonics and
report magnitude/phase (normalized to the fundamental) plus THD.

The transient grid rarely divides the period exactly, so the last period is
linearly interpolated onto K = 4*(n_harm+1) uniform points before the rFFT
(the same approach as berkeley-SPICE's 201-point interpolation, sized to
the requested harmonic count).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import numpy as np


@dataclasses.dataclass
class FourierRow:
    label: str
    dc: float
    mag: np.ndarray      # (n_harm,) harmonic magnitudes, 1-based
    phase_deg: np.ndarray
    norm_mag: np.ndarray # mag / mag[0]
    thd: float           # sqrt(sum_{k>=2} mag_k^2) / mag_1


@dataclasses.dataclass
class FourierResult:
    f0: float
    n_harm: int
    rows: List[FourierRow]


def fourier_of_samples(times, values, f0: float,
                       n_harm: int = 9) -> tuple:
    """(dc, mag, phase_deg) of the last 1/f0 seconds of a sampled signal."""
    times = np.asarray(times, np.float64)
    values = np.asarray(values, np.float64)
    T = 1.0 / f0
    t_end = times[-1]
    if t_end < T:
        raise ValueError(".FOUR needs at least one full period of data "
                         f"(have {t_end:.3e}s, period {T:.3e}s)")
    K = 4 * (n_harm + 1)
    grid = t_end - T + (np.arange(K) / K) * T
    samp = np.interp(grid, times, values)
    spec = np.fft.rfft(samp) / K
    dc = float(spec[0].real)
    ck = 2.0 * spec[1:n_harm + 1]
    return dc, np.abs(ck), np.degrees(np.angle(ck))


def fourier_analysis(times, xs, f0: float, selection: Sequence,
                     n_harm: int = 9) -> FourierResult:
    """selection: [(label, spec)] from io.csvout.probe_selection — an eq
    index or an (eq_a, eq_b) differential pair per output."""
    xs = np.asarray(xs)
    rows = []
    for label, spec in selection:
        if isinstance(spec, tuple):
            a = xs[:, spec[0]] if spec[0] >= 0 else 0.0
            b = xs[:, spec[1]] if spec[1] >= 0 else 0.0
            v = a - b
        else:
            v = xs[:, spec] if spec >= 0 else np.zeros(xs.shape[0])
        dc, mag, ph = fourier_of_samples(times, v, f0, n_harm)
        fund = max(mag[0], 1e-300)
        thd = float(np.sqrt(np.sum(mag[1:] ** 2)) / fund)
        rows.append(FourierRow(label=label, dc=dc, mag=mag, phase_deg=ph,
                               norm_mag=mag / fund, thd=thd))
    return FourierResult(f0=f0, n_harm=n_harm, rows=rows)


def fourier_table(result: FourierResult) -> str:
    """SPICE-style text report."""
    out = []
    for row in result.rows:
        out.append(f"Fourier analysis of {row.label}  "
                   f"(fundamental {result.f0:.6e} Hz)")
        out.append(f"  DC component = {row.dc:.6e}")
        out.append("  harmonic  frequency      magnitude      normalized"
                   "     phase(deg)")
        for k in range(result.n_harm):
            out.append(f"  {k + 1:8d}  {result.f0 * (k + 1):.6e} "
                       f"{row.mag[k]:14.6e} {row.norm_mag[k]:14.6e} "
                       f"{row.phase_deg[k]:14.4f}")
        out.append(f"  total harmonic distortion = {row.thd * 100:.6f} %")
        out.append("")
    return "\n".join(out)
