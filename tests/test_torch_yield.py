"""The port's yield and Sobol entries (``parallel/montecarlo.
yield_analysis``, ``sobol_indices``; ``Simulator.yield_analysis``,
``Simulator.sobol_indices``) on the CPU, f64, against the JAX package on the
same draws.  JAX's draws come from keys and the port's from a
``torch.Generator``: a module fixture replaces the port's ``normal_draws``
by the Z matrices JAX drew.  JAX's numbers are
``tests/goldens/yield_jax.json`` (one JAX yield or Sobol call compiles for
10-15 s on the CPU); ``JAX_PLATFORMS=cpu python tests/test_torch_yield.py``
remakes it with the JAX package.

Decks: the divider (transient, FIND AT), the inverter of
examples/high_sigma.py with its .TRAN cut to 4 ns (the high-sigma flow:
LHS, then IS centred on JAX's FORM z*; the divider's cases cover
scaled-sigma IS) and the RC
lowpass of tests/test_yield_ac.py (.MEASURE AC bandwidth).  Bars: pass
masks and failed lanes equal; per-lane measures 1e-9 relative; yield, ci95,
p_fail, p_fail_se, n_eff, the IS weights, S1, ST and var 1e-12 relative."""

import json
import math
import os

import numpy as np
import pytest
import torch

from circuitsimulator_tpu_torch import Simulator
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "yield_jax.json")

DIVIDER = """* divider yield
V1 in 0 DC 1
R1 in out 1k
R2 out 0 1k
.TRAN 1e-6 4e-6
.MEASURE TRAN vend FIND V(out) AT=3e-6
.end
"""

# examples/high_sigma.py's deck, .TRAN cut from 8 ns to 4 ns
INVERTER = """* inverter settle-time yield
.MODEL mn VT 0.7 MU 5e-2 COX 2e-3
VDD vdd 0 3
VIN in 0 PULSE(0 3 1n 0.8n 0.8n 20n 40n)
RD vdd out 20k
M1 out in 0 0 mn W=0.8u L=1u
CL out 0 150f
.TRAN 5e-11 4e-9
.MEASURE TRAN vset FIND V(out) AT=3.5e-9
.end
"""

LOWPASS = """* rf yield
V1 in 0 DC 0 AC 1
R1 in out 1k
C1 out 0 159.15494n
.AC DEC 20 10 100k
.MEASURE AC bw WHEN VDB(out)=-3 FALL=1
.end
"""

DECKS = {"divider": DIVIDER, "inverter": INVERTER, "lowpass": LOWPASS}
SIG_INV = {"mos_vth": 0.043}
BW0 = 1000.0

# (name, deck, entry, key seed, keyword arguments); "shift": "form"
# centres the draws on JAX's FORM z* of the spec
CASES = [
    ("divider_lhs", "divider", "yield", 0,
     dict(batch=64, rel_sigma={"res_r": 0.05}, specs={"vend": (0.49, None)},
          sampler="lhs")),
    ("divider_scaled_mc", "divider", "yield", 1,
     dict(batch=64, rel_sigma={"res_r": 0.05},
          specs={"vend": (0.47, 0.53)}, sigma_scale=3.0)),
    ("divider_scaled_sobol", "divider", "yield", 2,
     dict(batch=64, rel_sigma={"res_r": 0.05}, specs={"vend": (0.48, None)},
          sigma_scale=2.0, sampler="sobol")),
    ("inverter_lhs", "inverter", "yield", 0,
     dict(batch=64, rel_sigma=SIG_INV, specs={"vset": (None, 1.27)},
          sampler="lhs")),
    ("inverter_mpp", "inverter", "yield", 2,
     dict(batch=64, rel_sigma=SIG_INV, specs={"vset": (None, 1.27)},
          shift="form")),
    ("lowpass_lhs", "lowpass", "yield", 0,
     dict(batch=64, rel_sigma={"res_r": 0.05, "cap_c": 0.05},
          specs={"bw": (BW0 * math.exp(-0.7 * 0.05 * math.sqrt(2)), None)},
          sampler="lhs")),
    ("divider_sobol", "divider", "sobol", 0,
     dict(n=64, rel_sigma={"res_r": 0.05})),
    ("lowpass_sobol", "lowpass", "sobol", 2,
     dict(n=32, rel_sigma={"res_r": 0.05, "cap_c": 0.05})),
]


class GoldenDraws:
    """The port's ``normal_draws`` replaced by JAX's Z matrices, handed out
    in order."""

    def __init__(self):
        self.queue = []

    def __call__(self, generator, batch, dims, sampler="mc"):
        z = self.queue.pop(0)
        assert z.shape == (batch, dims)
        return z


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def draws():
    d = GoldenDraws()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmc, "normal_draws", d)
        yield d


@pytest.fixture(scope="module")
def sims():
    return {k: Simulator.from_text(v, device="cpu") for k, v in DECKS.items()}


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _kwargs(kw, g):
    kw = dict(kw)
    if kw.get("shift") == "form":
        kw["shift"] = np.asarray(g["z_star"])
    return kw


@pytest.mark.parametrize("name,deck,entry,seed,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_against_jax(golden, draws, sims, name, deck, entry, seed, kw):
    g = golden[name]
    draws.queue = [torch.tensor(np.asarray(z, dtype=g["z_dtype"]))
                   for z in g["Z"]]
    sim = sims[deck]
    if entry == "sobol":
        out = sim.sobol_indices(seed, **kw)
        for m, want in g["out"].items():
            got = out[m]
            assert [tuple(d) for d in want["dims"]] == got["dims"]
            for k in ("S1", "ST", "var"):
                assert _rel(got[k], want[k]) <= 1e-12, (m, k)
        assert set(out) == set(g["out"])
        return
    out = sim.yield_analysis(seed, **_kwargs(kw, g))
    want = g["out"]
    assert np.array_equal(out["pass"], want["pass"])
    assert np.array_equal(out["failed"], want["failed"])
    assert set(out["measures"]) == set(want["measures"])
    for m, v in out["measures"].items():
        w = np.asarray(want["measures"][m], float)
        assert np.array_equal(np.isnan(v), np.isnan(w)), m
        ok = ~np.isnan(w)
        assert _rel(v[ok], w[ok]) <= 1e-9, m
    keys = ["yield", "ci95"]
    if "p_fail" in want:
        keys += ["p_fail", "p_fail_se", "n_eff", "weights"]
    assert set(keys) <= set(out)
    for k in keys:
        assert _rel(out[k], want[k]) <= 1e-12, k
    assert 0.0 < out["yield"] <= 1.0


def test_errors(sims):
    with pytest.raises(ValueError, match="rel_sigma names no"):
        sims["divider"].sobol_indices(0, 8, {"ind_l": 0.1})
    no_measure = Simulator.from_text(DIVIDER.replace(
        ".MEASURE TRAN vend FIND V(out) AT=3e-6\n", ""), device="cpu")
    with pytest.raises(ValueError, match="needs .MEASURE cards"):
        no_measure.yield_analysis(0, 8, {"res_r": 0.05}, {})
    with pytest.raises(ValueError, match=".MEASURE TRAN"):
        no_measure.sobol_indices(0, 8, {"res_r": 0.05})


def make_golden():
    """Run every case through the JAX package (float64 on the CPU) and
    write tests/goldens/yield_jax.json."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from circuitsimulator_tpu import Simulator as JaxSimulator
    from circuitsimulator_tpu.parallel import montecarlo as jmc

    def host(v):
        a = np.asarray(v)
        return a.tolist()

    sims = {k: JaxSimulator.from_text(v) for k, v in DECKS.items()}
    form = sims["inverter"].worst_case(SIG_INV, measure="vset", high=1.27)
    out = {}
    for name, deck, entry, seed, kw in CASES:
        sim = sims[deck]
        key = jax.random.key(seed)
        g = {}
        if entry == "sobol":
            dims = jmc._z_layout(sim.params, kw["rel_sigma"])[2]
            kA, kB = jax.random.split(key)
            Z = [jmc.normal_draws(k, kw["n"], dims, "lhs") for k in (kA, kB)]
            res = sim.sobol_indices(key, **kw)
            g["out"] = {m: {"S1": host(r["S1"]), "ST": host(r["ST"]),
                            "var": r["var"], "dims": r["dims"]}
                        for m, r in res.items()}
        else:
            dims = jmc._z_layout(sim.params, kw["rel_sigma"])[2]
            Z = [jmc.normal_draws(key, kw["batch"], max(dims, 1),
                                  kw.get("sampler", "mc"))]
            if kw.get("shift") == "form":
                g["z_star"] = host(form["z_star"])
                g["beta"] = form["beta"]
            res = sim.yield_analysis(key, **_kwargs(kw, g))
            g["out"] = {k: (host(res[k]) if k != "measures" else
                            {m: host(v) for m, v in res[k].items()})
                        for k in ("pass", "failed", "measures", "yield",
                                  "ci95", "p_fail", "p_fail_se", "n_eff",
                                  "weights") if k in res}
        g["Z"] = [host(z) for z in Z]
        g["z_dtype"] = str(np.asarray(Z[0]).dtype)
        out[name] = g
    with open(GOLDEN, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    make_golden()
