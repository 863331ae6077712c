"""The port's FORM stack on the CPU, f64, against the JAX package:
``analysis/form.mpp_search`` through ``Simulator.worst_case`` (transient,
DC and AC limit states, the probe shorthands and the deck's .MEASURE
cards, design gradients, SORM), ``mismatch_budget``, ``center_design``,
``calibrate`` and ``fit_measures`` (``torch.optim.Adam`` against
``optax.adam``).  JAX's numbers are ``tests/goldens/form_jax.json``: its
FORM searches compile for 1-15 s each and its optimisers loop over jitted
gradients; ``JAX_PLATFORMS=cpu python tests/test_torch_form.py`` remakes
the file with the JAX package.

Bars: beta 1e-6 relative, z* 1e-5 of |z*|, n_iter and converged equal,
p_fail_sorm 1e-5 relative, dbeta 1e-6 of its largest entry, the budget's
contribution order equal and shares 1e-8, the loss or beta history of the
optimisers 1e-6 relative per step."""

import json
import math
import os

import numpy as np
import pytest
import torch

from circuitsimulator_tpu_torch import Simulator

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "form_jax.json")
SIG = 0.05


def vc_of(c):
    """The divider's low spec whose FORM beta is c (closed form)."""
    L = -c * SIG * math.sqrt(2.0)
    return math.exp(L) / (1.0 + math.exp(L))


DIVIDER = """* divider worst case
V1 in 0 DC 1
R1 in out 1k
R2 out 0 1k
.TRAN 1e-6 4e-6
.end
"""

DIVIDER_DC = """* divider dc only
V1 in 0 DC 1
R1 in out 1k
R2 out 0 1k
.op
"""

DIODE_DC = """* diode-loaded divider
V1 in 0 DC 2
R1 in out 1k
R2 out 0 2k
D1 out 0 IS=1e-9 N=2
.op
"""

RC = """* rc worst case
V1 in 0 PULSE(0 1 0 1n 1n 1 1)
R1 in out 1k
C1 out 0 1u
.TRAN 4e-5 1.2e-3
.end
"""

LOWPASS = """* rc lowpass
V1 in 0 DC 0 AC 1
R1 in out 1k
C1 out 0 159.15494e-9
.AC DEC 10 10 100k
.MEASURE AC bw WHEN VDB(out)=-3 FALL=1
.end
"""

MEASURES = """* measure deck
V1 in 0 PULSE(0 1 1e-5 1e-5 1e-5 2e-4 5e-4)
R1 in out 1k
C1 out 0 20n
RL out 0 10k
.TRAN 5e-6 2.5e-4
.MEASURE TRAN m_find FIND V(out) AT=2e-4
.MEASURE TRAN m_delay TRIG V(in) VAL=0.5 RISE=1 TARG V(out) VAL=0.5 RISE=1
.end
"""

DECKS = {"divider": DIVIDER, "divider_dc": DIVIDER_DC, "diode_dc": DIODE_DC,
         "rc": RC, "lowpass": LOWPASS, "measures": MEASURES}
# the diode divider's SORM runs 11 ramped DCs: a 2-step source ramp (in
# both packages) keeps its case near a second
RAMP = {"diode_dc": 2}
F0 = 1.0 / (2 * math.pi * 1e3 * 159.15494e-9)
HC = 1.0 / math.sqrt(1.0 + math.exp(3.0 * SIG * math.sqrt(2.0)) ** 2)

# (name, deck, worst_case keyword arguments); "low": "golden" takes the
# spec the golden recorded (a 3-sigma spec that JAX measured on the deck)
WORST = [
    ("divider_tran", "divider",
     dict(rel_sigma={"res_r": SIG}, probe="out", at=3e-6, low=vc_of(3.5),
          design_grads=["res_r"])),
    ("divider_dc_sorm", "divider_dc",
     dict(rel_sigma={"res_r": SIG}, analysis="dc", probe="out",
          low=vc_of(3.0), sorm=True)),
    ("diode_dc_sorm", "diode_dc",
     dict(rel_sigma={"res_r": 0.10}, analysis="dc", probe="out",
          low="golden", sorm=True)),
    ("rc_tran", "rc",
     dict(rel_sigma={"res_r": 0.1, "cap_c": 0.1}, probe="out", at=1e-3,
          low=1.0 - math.exp(-1.0 / math.exp(0.35)))),
    ("lowpass_ac_probe", "lowpass",
     dict(rel_sigma={"res_r": SIG, "cap_c": SIG}, analysis="ac",
          probe="out", at=F0, low=HC, design_grads=["res_r"])),
    ("lowpass_ac_measure", "lowpass",
     dict(rel_sigma={"res_r": SIG, "cap_c": SIG}, analysis="ac",
          measure="bw", low=1000.0 * math.exp(-2.5 * SIG * math.sqrt(2.0)))),
    ("measures_timing", "measures",
     dict(rel_sigma={"res_r": SIG}, measure="m_delay", high="golden")),
]

BUDGETS = [
    ("divider_tran", "divider",
     dict(rel_sigma={"res_r": SIG}, probe="out", at=3e-6)),
    ("divider_dc", "divider_dc",
     dict(rel_sigma={"res_r": SIG}, analysis="dc", probe="out")),
    ("lowpass_ac_probe", "lowpass",
     dict(rel_sigma={"res_r": SIG, "cap_c": 2 * SIG}, analysis="ac",
          probe="out", at=F0)),
    ("lowpass_ac_measure", "lowpass",
     dict(rel_sigma={"res_r": SIG, "cap_c": 2 * SIG}, analysis="ac",
          measure="bw")),
    ("measures_delay", "measures",
     dict(rel_sigma={"res_r": SIG, "cap_c": SIG}, measure="m_delay")),
]

CENTER = [
    ("divider_single", "divider",
     dict(rel_sigma={"res_r": SIG},
          specs=[{"probe": "out", "at": 3e-6, "low": vc_of(2.0)}],
          design_names=["res_r"], target_beta=3.0, steps=8, lr=0.05)),
    ("divider_mixed", "divider",
     dict(rel_sigma={"res_r": SIG},
          specs=[{"probe": "out", "at": 3e-6, "low": vc_of(4.0)},
                 {"analysis": "dc", "probe": "out",
                  "high": 1.0 - vc_of(4.0)}],
          design_names=["res_r"], target_beta=3.5, steps=4, lr=0.05,
          params_scale={"res_r": [1.0, 1.1]})),
]


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def sims():
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    return {k: Simulator.from_text(v, device="cpu",
                                   opts=DEFAULT_OPTIONS.replace(
                                       ramp_steps=RAMP.get(k, 10)))
            for k, v in DECKS.items()}


def _with_golden(kw, g):
    return {k: (g["spec"] if v == "golden" else v) for k, v in kw.items()}


def _scaled(sim, kw):
    """kw with params_scale turned into params (the nominal scaled)."""
    kw = dict(kw)
    scale = kw.pop("params_scale", None)
    if scale:
        p = dict(sim.params)
        for k, s in scale.items():
            p[k] = p[k] * torch.as_tensor(s, dtype=p[k].dtype)
        kw["params"] = p
    return kw


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.mark.parametrize("name,deck,kw", WORST, ids=[w[0] for w in WORST])
def test_worst_case(golden, sims, name, deck, kw):
    g = golden["worst"][name]
    out = sims[deck].worst_case(**_with_golden(kw, g))
    assert (out["n_iter"], out["converged"]) == (g["n_iter"], g["converged"])
    assert out["beta"] == pytest.approx(g["beta"], rel=1e-6)
    z = out["z_star"].numpy()
    assert np.abs(z - g["z_star"]).max() <= 1e-5 * np.linalg.norm(g["z_star"])
    assert out["g_nominal"] == pytest.approx(g["g_nominal"], rel=1e-9)
    assert out["p_fail"] == pytest.approx(g["p_fail"], rel=1e-5)
    assert out["names"] == g["names"] and out["dims"] == len(z)
    if "p_fail_sorm" in g:
        assert out["p_fail_sorm"] == pytest.approx(g["p_fail_sorm"],
                                                   rel=1e-5)
        assert out["sorm_det"] == pytest.approx(g["sorm_det"], rel=1e-5)
    if "dbeta" in g:
        for k, want in g["dbeta"].items():
            got = out["dbeta"][k].numpy()
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), k
    for k, want in g["params_star"].items():
        assert _rel(out["params_star"][k].numpy(), want) <= 1e-5, k


@pytest.mark.parametrize("name,deck,kw", BUDGETS, ids=[b[0] for b in BUDGETS])
def test_mismatch_budget(golden, sims, name, deck, kw):
    g = golden["budget"][name]
    out = sims[deck].mismatch_budget(**kw)
    assert [c[:2] for c in out["contributions"]] == \
        [tuple(c[:2]) for c in g["contributions"]]
    for (_, _, s), (_, _, w) in zip(out["contributions"], g["contributions"]):
        assert abs(s - w) <= 1e-8
    assert out["sigma_m"] == pytest.approx(g["sigma_m"], rel=1e-8)
    assert out["m_nominal"] == pytest.approx(g["m_nominal"], rel=1e-9)
    assert _rel(out["grad_z"].numpy(), g["grad_z"]) <= 1e-8


@pytest.mark.parametrize("name,deck,kw", CENTER, ids=[c[0] for c in CENTER])
def test_center_design(golden, sims, name, deck, kw):
    g = golden["center"][name]
    sim = sims[deck]
    p, hist = sim.center_design(**_scaled(sim, kw))
    assert [h["worst"] for h in hist] == [h["worst"] for h in g["history"]]
    for h, w in zip(hist, g["history"]):
        assert _rel(h["betas"], w["betas"]) <= 1e-6
    assert len(hist) == len(g["history"])
    assert _rel(p["res_r"].numpy(), g["res_r"]) <= 1e-6


def test_calibrate(golden, sims):
    """Five Adam steps recovering the RC's time constant from a waveform,
    from R 35% high and C 30% low: the loss history per step."""
    g = golden["calibrate"]
    sim = sims["rc"]
    p0 = dict(sim.params)
    p0["res_r"] = sim.params["res_r"] * 1.35
    p0["cap_c"] = sim.params["cap_c"] * 0.7
    fitted, hist = sim.calibrate(np.asarray(g["target"]), "out",
                                 ["res_r", "cap_c"], steps=5, lr=0.05,
                                 params=p0)
    assert _rel(hist, g["history"]) <= 1e-6
    assert hist[-1] < hist[0]
    for k in ("res_r", "cap_c"):
        assert _rel(fitted[k].numpy(), g["fitted"][k]) <= 1e-6, k


def test_fit_measures(golden, sims):
    """Three Adam steps of C and R toward a delay and a level target on
    the deck's own .MEASURE cards: the loss history per step."""
    g = golden["fit_measures"]
    fitted, hist = sims["measures"].fit_measures(
        g["targets"], ["cap_c", "res_r"], steps=3, lr=0.08)
    assert _rel(hist, g["history"]) <= 1e-6
    for k in ("res_r", "cap_c"):
        assert _rel(fitted[k].numpy(), g["fitted"][k]) <= 1e-6, k


def test_errors(sims):
    """A failing nominal, a missing bound, a missing .TRAN card and an
    unknown measure or leaf are refused."""
    div = sims["divider"]
    with pytest.raises(ValueError, match="nominal design already fails"):
        div.worst_case({"res_r": SIG}, probe="out", at=3e-6, low=0.9)
    with pytest.raises(ValueError, match="at least one bound"):
        div.worst_case({"res_r": SIG}, probe="out", at=3e-6)
    no_tran = Simulator.from_text("""* no tran
V1 in 0 DC 1
R1 in 0 1k
.op
""", device="cpu")
    with pytest.raises(ValueError, match=".TRAN"):
        no_tran.worst_case({"res_r": SIG}, probe="in", at=1e-6, low=0.5)
    with pytest.raises(ValueError, match=".TRAN"):
        no_tran.mismatch_budget({"res_r": SIG}, probe="in", at=1e-6)
    with pytest.raises(ValueError, match=".TRAN"):
        no_tran.calibrate(np.zeros(3), "in", ["res_r"])
    with pytest.raises(KeyError, match="no .MEASURE TRAN card"):
        div.worst_case({"res_r": SIG}, measure="nothing", high=1.0)
    with pytest.raises(KeyError, match="unknown parameter leaf"):
        div.calibrate(np.zeros(5), "out", ["res_q"], steps=1)
    with pytest.raises(ValueError, match="rel_sigma names no"):
        div.mismatch_budget({"ind_l": SIG}, probe="out", at=3e-6)


def make_golden():
    """Every case through the JAX package (float64 on the CPU, optax Adam)
    into tests/goldens/form_jax.json."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
    from circuitsimulator_tpu import Simulator as JaxSimulator
    from circuitsimulator_tpu.analysis.adjoint import _make_diff_dc

    def host(a):
        return np.asarray(a).tolist()

    sims = {k: JaxSimulator.from_text(v, opts=JAX_OPTIONS.replace(
        ramp_steps=RAMP.get(k, 10))) for k, v in DECKS.items()}

    def jscaled(sim, kw):
        kw = dict(kw)
        scale = kw.pop("params_scale", None)
        if scale:
            p = dict(sim.params)
            for k, s in scale.items():
                p[k] = p[k] * jnp.asarray(s)
            kw["params"] = p
        return kw

    # the diode divider's 3-sigma spec (tests/test_form.py's recipe)
    d = sims["diode_dc"]
    eq = d.circuit.nodes[d.circuit.node_name_to_id["out"]].eq_index
    dc = _make_diff_dc(d.engine)

    def v_of(z):
        p = dict(d.params)
        p["res_r"] = d.params["res_r"] * jnp.exp(0.10 * z)
        return dc(p)[eq]

    spec = {"diode_dc_sorm": float(v_of(jnp.zeros(2))) - 3.0 * float(
        jnp.linalg.norm(jax.grad(v_of)(jnp.zeros(2))))}
    m = sims["measures"]
    nominal = m.worst_case({"res_r": SIG}, measure="m_delay",
                           high=1e9)["g_nominal"]
    spec["measures_timing"] = (1e9 - nominal) * math.exp(2.5 * SIG)
    out = {"worst": {}, "budget": {}, "center": {}}
    for name, deck, kw in WORST:
        g = {"spec": spec.get(name)}
        r = sims[deck].worst_case(**_with_golden(kw, g))
        g.update({k: (host(r[k]) if k in ("z_star",) else r[k])
                  for k in ("beta", "n_iter", "converged", "g_nominal",
                            "p_fail", "names", "z_star", "p_fail_sorm",
                            "sorm_det") if k in r})
        if "dbeta" in r:
            g["dbeta"] = {k: host(v) for k, v in r["dbeta"].items()}
        g["params_star"] = {k: host(r["params_star"][k])
                            for k in kw["rel_sigma"]}
        out["worst"][name] = g
    for name, deck, kw in BUDGETS:
        r = sims[deck].mismatch_budget(**kw)
        out["budget"][name] = {"contributions": r["contributions"],
                               "sigma_m": r["sigma_m"],
                               "m_nominal": r["m_nominal"],
                               "grad_z": host(r["grad_z"])}
    for name, deck, kw in CENTER:
        p, hist = sims[deck].center_design(**jscaled(sims[deck], kw))
        out["center"][name] = {"history": hist, "res_r": host(p["res_r"])}
    rc = sims["rc"]
    eq = rc.circuit.nodes[rc.circuit.node_name_to_id["out"]].eq_index
    target = np.asarray(rc.transient().xs)[:, eq]
    p0 = dict(rc.params)
    p0["res_r"] = rc.params["res_r"] * 1.35
    p0["cap_c"] = rc.params["cap_c"] * 0.7
    fitted, hist = rc.calibrate(target, "out", ["res_r", "cap_c"], steps=5,
                                lr=0.05, params=p0)
    out["calibrate"] = {"target": host(target), "history": hist,
                        "fitted": {k: host(fitted[k])
                                   for k in ("res_r", "cap_c")}}
    vals = dict(m.measure(m.transient()))
    targets = {"m_delay": vals["m_delay"] * 1.6, "m_find": vals["m_find"]}
    fitted, hist = m.fit_measures(targets, ["cap_c", "res_r"], steps=3,
                                  lr=0.08)
    out["fit_measures"] = {"targets": targets, "history": hist,
                           "fitted": {k: host(fitted[k])
                                      for k in ("res_r", "cap_c")}}
    with open(GOLDEN, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    make_golden()
