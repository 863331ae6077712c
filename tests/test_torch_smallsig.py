"""The port's small-signal stack on the CPU against the JAX package, f64,
on the decks of the JAX package's own tests (tests/test_noise.py,
test_tf.py, test_pz.py, test_sensitivity.py, test_loopgain.py,
test_sparams.py, test_noise_figure.py), a T-line deck for noise, loop gain
and group delay, and a MOSCAP=CHARGE deck and a mutual-inductance deck for
.PZ.  Bars: noise PSDs, input noise and per-class sums 1e-9 relative per
frequency; loop gain 1e-9 relative; S and Z 1e-9 of the peak; group delay
1e-8 relative; .TF 1e-10 relative; .SENS 1e-8 relative for every row the
report prints; poles and zeros 1e-9 relative after sorting.  On the CPU
the port's K3 and K2 calls take their plain versions; each analysis is
also held to the number of sweep calls it makes (one K3 call for noise,
loop gain and S-parameters, two for group delay, none on T-line decks).
The JAX results (about 30 s of compiles on the CPU) are
``tests/goldens/smallsig_jax.json``; ``PYTHONPATH=. JAX_PLATFORMS=cpu
python tests/test_torch_smallsig.py`` reruns the cases against the JAX
package itself (``RECORD``) and remakes it."""

import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.utils.options import DEFAULT_OPTIONS as JAX_OPTS
from circuitsimulator_tpu_torch import Simulator
from circuitsimulator_tpu_torch.analysis import ac as tac
from circuitsimulator_tpu_torch.analysis import sensitivity as tsens

# one intra-op thread: the tensors are small, and under pytest-xdist
# several workers and JAX's own threads share the cores, where torch's
# spinning OpenMP workers slow everything on the machine many-fold
torch.set_num_threads(1)

JAX_F64 = JAX_OPTS.replace(dtype=jnp.float64)
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "goldens", "smallsig_jax.json")
RECORD = {}     # "on": the cases call JAX and record its results here


def _enc(v):
    """A JAX result as JSON: arrays as lists, complex ones as [re, im]."""
    if isinstance(v, dict):
        return {k: _enc(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_enc(x) for x in v]
    if isinstance(v, str) or v is None:
        return v
    a = np.asarray(v)
    if np.iscomplexobj(a):
        return {"re": a.real.tolist(), "im": a.imag.tolist()}
    return a.tolist()


def _dec(v):
    if isinstance(v, dict):
        if set(v) == {"re", "im"}:
            return np.asarray(v["re"]) + 1j * np.asarray(v["im"])
        return {k: _dec(x) for k, x in v.items()}
    if isinstance(v, list):
        try:
            a = np.asarray(v)
        except ValueError:          # ragged
            a = None
        if a is not None and a.dtype.kind in "fiub":
            return a
        return [_dec(x) for x in v]
    return v


@functools.lru_cache(maxsize=None)
def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def jax_value(key, make):
    """A JAX result: ``make()`` when recording (``__main__``), else the
    golden's; numpy arrays either way."""
    if RECORD.get("on"):
        RECORD[key] = _enc(make())
        return _dec(RECORD[key])
    return _dec(_golden()[key])

# every noise generator class (R thermal, MOS channel + flicker, JFET
# channel, diode shot, BJT collector and base shot) and every controlled
# source, input referred to a V source, at .TEMP 60 with a TC resistor
# (the thermal voltage and the TC rows reach .SENS); .TF and .SENS cards
# too
MIXED = """* mixed small-signal deck
.MODEL 1 VT 0.7 MU 5e-2 COX 2e-3 LAMBDA 0.02 CJ0 1e-12 KF 1e-22 AF 1.2
.MODEL qn NPN IS=1e-15 BF=120 VAF=60 CJE=2p CJC=1p
.MODEL jn NJF VTO=-1.5 BETA=1e-3 LAMBDA=0.01
VDD vdd 0 5
VIN in 0 DC 2 AC 1
M1 out in 0 n 2u 1u 1
RL vdd out 10k TC1=0.002 TC2=1e-5
C1 out 0 2p
Ib 0 b DC 1u
D1 out dd IS=1e-14 N=1 CJO=1p
RD dd 0 50k
RB vdd b 400k
Q1 c b e qn
RC vdd c 2k
RE e 0 200
J1 vdd c s jn
RS s 0 5k
E1 x 0 out 0 0.5
RX x y 1k
G1 0 y c 0 1m
Vs y z DC 0
RZ z 0 2k
F1 0 w Vs 3
RW w 0 1k
H1 h 0 Vs 200
RH h 0 1k
.TEMP 60
.TF V(out) VIN
.SENS V(h)
.NOISE V(out) VIN dec 4 10 1e8
"""

# a 50-ohm line between a source and a load: noise referred to an I
# source, and the K2 route of every sweep
TLINE_NOISE = """* T-line noise deck
V1 in 0 DC 1 AC 1
Iin 0 a DC 0 AC 0
R1 in a 50
T1 a 0 b 0 Z0=50 TD=1n
R2 b 0 75
C1 b 0 1p
.NOISE V(b) Iin lin 7 1e6 1e9
"""

# the three-pole loop of tests/test_loopgain.py
THREE_POLE = """* three-pole loop
Vref in 0 DC 0 AC 1
E1 a 0 in out 2
R1 a b 1k
C1 b 0 1u
EB1 c 0 b 0 1
R2 c d 1k
C2 d 0 1u
EB2 e 0 d 0 1
R3 e out 1k
C3 out 0 1u
.AC DEC 20 0.1 1e5
.end
"""

# a loop closed through a transmission line
TLINE_LOOP = """* loop through a line
Vref in 0 DC 0 AC 1
E1 a 0 in out 20
R1 a b 50
T1 b 0 c 0 Z0=50 TD=100n
R2 c out 10
C1 out 0 1n
Rl out 0 1k
.AC DEC 5 1e4 1e7
.end
"""

# .PZ: the lead network's zero and pole, an LC pair of coupled inductors
# (-L and -M in C) and a common-source stage under MOSCAP=CHARGE (its
# trans-capacitances at the operating point), in one deck
PZ_DECK = """* pole-zero deck
.MODEL mn VT 0.7 MU 350u COX 2.3m CJ0 20f
V1 in 0 DC 0 AC 1
R1 in out 10e3
C1 in out 1e-9
R2 out 0 2e3
L3 in 0 1u
L4 k 0 2u
K1 L3 L4 0.5
R4 k 0 50
C4 k 0 1n
VDD vdd 0 DC 3
Vg g 0 DC 1.2 AC 1
M1 d g 0 n 20e-6 1e-6 mn
Rd vdd d 5k
Cl d 0 50f
.OPTIONS MOSCAP=CHARGE
.PZ V(out) V1
"""

# the 10 dB pi pad and the matched line of tests/test_sparams.py (the
# one-port runs in the CLI cases, tests/test_torch_cli.py)
SPARAM_DECKS = {
    "pad": ("R1 p1 0 96.2478\nR2 p1 p2 71.1512\nR3 p2 0 96.2478\n.op\n",
            [("p1", None, 50.0), ("p2", None, 50.0)], [1e6, 1e9]),
    "tline": ("T1 p1 0 p2 0 Z0=50 TD=1n\n.op\n",
              [("p1", None, 50.0), ("p2", None, 75.0)], [5e7, 4e8]),
}

# the resistive attenuator of tests/test_noise_figure.py
NF_PAD = """* pad
V1 in 0 DC 0 AC 1
RS in out 50
RL out 0 450
.AC DEC 5 1e3 1e6
.NOISE V(out) V1
.end
"""


def _jit_keep_static(fn, n_arrays):
    """``fn(engine, params, x)`` -> (static, arrays..., static...) under
    one ``jax.jit`` per engine: the arrays come from the compiled call, the
    static outputs (index arrays, labels) from its trace."""
    traced, compiled = {}, {}

    def wrapped(engine, params, x):
        if engine not in compiled:
            def f(p, xx):
                traced[engine] = fn(engine, p, xx)
                return traced[engine][1:1 + n_arrays]
            compiled[engine] = jax.jit(f)
        arrays = compiled[engine](params, x)
        out = traced[engine]
        return (out[0],) + tuple(arrays) + tuple(out[1 + n_arrays:])
    return wrapped


@pytest.fixture(scope="module", autouse=True)
def jax_compiled():
    """The JAX package's small-signal functions run here as they are, but
    with their eager building blocks (the assembly, the AC system, the
    polish, the LU, the reactive structure, the noise generators) under
    ``jax.jit``: compiled
    whole they cost a fraction of the op-by-op compiles of an eager run.
    Nothing in the JAX package changes; the patches end with this module."""
    from circuitsimulator_tpu.analysis import ac as jac
    from circuitsimulator_tpu.analysis import hb as jhb
    from circuitsimulator_tpu.analysis import noise as jnoise
    from circuitsimulator_tpu.analysis import pz as jpz
    from circuitsimulator_tpu.analysis import sensitivity as jsens
    from circuitsimulator_tpu.analysis import tf as jtf
    from circuitsimulator_tpu.ops import lu as jlu
    from circuitsimulator_tpu.analysis import loopgain as jloop
    polish = jax.jit(jsens._polish, static_argnums=(0, 3))
    ac_system = jax.jit(jac.ac_system_real, static_argnums=0)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jac, jnoise, jloop):
            mp.setattr(mod, "ac_system_real", ac_system)
        mp.setattr(jnoise, "_device_noise_currents",
                   _jit_keep_static(jnoise._device_noise_currents, 2))
        mp.setattr(jpz, "_polish", polish)
        mp.setattr(jpz, "_reactive_structure",
                   jax.jit(jhb._reactive_structure, static_argnums=(0, 3)))
        mp.setattr(jtf, "_polish", polish)
        mp.setattr(jtf, "lu_solve", jax.jit(jlu.lu_solve, static_argnums=2))
        yield


@functools.lru_cache(maxsize=None)
def sims(text):
    """(JAX simulator, port simulator, port DC point) of one deck; the JAX
    engine's DC assembly methods compiled (see ``jax_compiled``)."""
    js = JaxSimulator.from_text(text, opts=JAX_F64)
    for name in ("dc_static", "assemble_dc_iter"):
        setattr(js.engine, name, jax.jit(getattr(js.engine, name)))
    ts = Simulator.from_text(text, device="cpu")
    return js, ts, ts.dc()


def jax_x(text):
    """The port's DC point handed to JAX (both sides linearise there)."""
    return jnp.asarray(sims(text)[2].numpy())


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-300)))


def peak_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture
def k3_calls(monkeypatch):
    """Counts the port's K3 sweep calls (``ac.ac_sweep``; on the CPU each
    runs the plain version, on the card each is one kernel launch)."""
    calls = []
    real = tac.ac_sweep

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(tac, "ac_sweep", counted)
    return calls


# ------------------------------------------------------------- noise
NOISE_DECKS = {"mixed": MIXED, "tline": TLINE_NOISE}


@functools.lru_cache(maxsize=None)
def jax_noise(deck):
    """JAX's noise_analysis over the deck's .NOISE card with its
    per-generator PSDs (the noise figure's input), and the T-line deck's
    noise CSV as JAX's writer writes it: one JAX computation per deck."""
    def run():
        import tempfile
        from circuitsimulator_tpu.analysis.noise import (noise_analysis,
                                                         write_noise_csv)
        text = NOISE_DECKS[deck]
        js, ts, _ = sims(text)
        cfg = ts.config.noise
        r = noise_analysis(js.engine, js.params, ts._noise_freqs(""),
                           ts._node_eq(cfg.out_node), -1,
                           ts._input_ref(cfg.input_source),
                           x_op=jax_x(text), per_device=True)
        with tempfile.TemporaryDirectory() as d:
            write_noise_csv(os.path.join(d, "j.csv"), r)
            with open(os.path.join(d, "j.csv")) as f:
                csv = f.read()
        return {"freqs": r.freqs, "onoise": r.onoise, "inoise": r.inoise,
                "gain": r.gain, "by_class": dict(r.by_class),
                "s_dev": r.s_dev, "csv": csv}
    return jax_value(f"noise_{deck}", run)


@pytest.mark.parametrize("deck", list(NOISE_DECKS))
def test_noise_matches_jax(deck, k3_calls):
    """Output and input noise, the gain and the per-class sums; the mixed
    deck's adjoint sweep is one K3 call on (1, N, N), the T-line deck's
    none."""
    text = NOISE_DECKS[deck]
    _, ts, x = sims(text)
    want = jax_noise(deck)
    got = ts.noise(x_op=x)
    assert k3_calls == ([] if deck == "tline"
                        else [(1, ts.engine.N, ts.engine.N)])
    np.testing.assert_array_equal(got.freqs, want["freqs"])
    assert rel(got.onoise, want["onoise"]) <= 1e-9
    assert rel(got.inoise, want["inoise"]) <= 1e-9
    assert rel(got.gain, want["gain"]) <= 1e-9
    assert set(got.by_class) == set(want["by_class"])
    for k in want["by_class"]:
        assert rel(got.by_class[k], want["by_class"][k]) <= 1e-9, k
    if deck == "mixed":
        assert set(got.by_class) == {"R", "M", "D", "Q"}


def test_noise_figure_matches_jax():
    """noise_figure("RL") against JAX's formula on JAX's per-generator
    PSDs of the same deck; the attenuator's closed form F = 1 + Rs/RL."""
    _, ts, x = sims(MIXED)
    want = jax_noise("mixed")
    f_t, nf_t = ts.noise_figure("RL", x_op=x)
    np.testing.assert_array_equal(f_t, want["freqs"])
    ridx = [e.name for e in ts.circuit.elements if e.kind == "R"].index("RL")
    s = want["s_dev"]
    assert rel(nf_t, 10 * np.log10(want["onoise"] / s[:, ridx])) <= 1e-9
    pad = Simulator.from_text(NF_PAD, device="cpu")
    _, nf = pad.noise_figure("RS")
    np.testing.assert_allclose(nf, 10 * np.log10(1 + 50 / 450), rtol=1e-9)
    with pytest.raises(KeyError):
        pad.noise_figure("RQ")


def test_noise_csv_and_errors(tmp_path):
    from circuitsimulator_tpu_torch.analysis.noise import write_noise_csv
    _, ts, x = sims(TLINE_NOISE)
    write_noise_csv(str(tmp_path / "t.csv"), ts.noise(x_op=x))
    t = (tmp_path / "t.csv").read_text().splitlines()
    j = jax_noise("tline")["csv"].splitlines()
    assert t[0] == j[0] and len(t) == len(j)
    assert peak_rel(np.loadtxt(t[1:], delimiter=","),
                    np.loadtxt(j[1:], delimiter=",")) <= 1e-9
    sim = Simulator.from_text("V1 a 0 1\nR1 a 0 1k\n", device="cpu")
    with pytest.raises(ValueError, match=".NOISE card missing"):
        sim.noise()
    with pytest.raises(ValueError, match="no frequency sweep"):
        sim.noise(out_node="a")
    with pytest.raises(KeyError):
        sim.noise(out_node="nope", freqs=np.array([1.0]))
    with pytest.raises(ValueError, match="ground"):
        sim.noise(out_node="0", freqs=np.array([1.0]))


# ------------------------------------------------ loop gain, group delay
LOOP_DECKS = {"three_pole": THREE_POLE, "tline": TLINE_LOOP}


@pytest.mark.parametrize("deck", list(LOOP_DECKS))
def test_loop_gain_matches_jax(deck, k3_calls):
    text = LOOP_DECKS[deck]
    js, ts, x = sims(text)
    want = jax_value(f"loop_gain_{deck}",
                     lambda: js.loop_gain("E1", x_op=jax_x(text)))
    got = ts.loop_gain("E1", x_op=x)
    assert len(k3_calls) == (0 if deck == "tline" else 1)
    assert rel(got["T"], want["T"]) <= 1e-9
    for k in ("f_unity", "phase_margin_deg", "f_180", "gain_margin_db"):
        assert (got[k] is None) == (want[k] is None), k
        if want[k] is not None:
            assert rel(got[k], want[k]) <= 1e-9, k
    with pytest.raises(KeyError):
        ts.loop_gain("E9")


def test_group_delay_tline_matches_jax(k3_calls):
    """A T-line deck's group delay (dY/dw by forward-mode AD of the
    per-frequency assembly, both solves on K2) against JAX's jax.grad
    through the solve.  The K3 route is held to JAX by the CLI cases
    (feedback_loop.sp, bjt_amp.sp) and by the next test."""
    js, ts, x = sims(TLINE_LOOP)
    f_j, tau_j = jax_value("group_delay_tline", lambda: list(
        js.group_delay("out", x_op=jax_x(TLINE_LOOP))))
    f_t, tau_t = ts.group_delay("out", x_op=x)
    assert k3_calls == []
    np.testing.assert_array_equal(f_t, np.asarray(f_j))
    assert rel(tau_t, tau_j) <= 1e-8
    with pytest.raises(KeyError):
        ts.group_delay("nope")


def test_group_delay_two_k3_sweeps_match_phase_slope(k3_calls):
    """Without T-lines: the forward and the adjoint sweep are two K3
    calls, and tau agrees with the central difference of the AC phase."""
    _, ts, x = sims(THREE_POLE)
    f = np.array([10.0, 100.0, 300.0])
    _, tau = ts.group_delay("out", freqs=f, x_op=x)
    assert k3_calls == [(1, ts.engine.N, ts.engine.N)] * 2
    eq = ts._node_eq("out")
    h = f * 1e-5
    ph = [np.unwrap(np.angle(ts.ac(freqs=ff, x_op=x).xs[:, eq]))
          for ff in (f - h, f + h)]
    np.testing.assert_allclose(tau, -(ph[1] - ph[0]) / (4 * np.pi * h),
                               rtol=1e-6)


# --------------------------------------------------------- S-parameters
@functools.lru_cache(maxsize=None)
def sparams_pair(deck):
    """(JAX's S, Z, z0, two-port metrics and its Touchstone and S-CSV
    files' text, the port's sparams result) of one deck."""
    text, ports, freqs = SPARAM_DECKS[deck]
    js, ts, x = sims(text)

    def run():
        import tempfile
        from circuitsimulator_tpu.analysis import sparams as jsp
        r = js.sparams(ports, freqs=freqs, x_op=jax_x(text))
        m = jsp.two_port_metrics(r)
        out = {"s": r.s, "z": r.z, "z0": r.z0,
               "metrics": {k: getattr(m, k) for k in
                           ("k", "delta", "mu_load", "mu_src", "msg",
                            "stable")}}
        with tempfile.TemporaryDirectory() as d:
            for writer in ("write_touchstone", "write_sparams_csv"):
                getattr(jsp, writer)(os.path.join(d, "j"), r)
                with open(os.path.join(d, "j")) as f:
                    out[writer] = f.read()
        return out
    return (jax_value(f"sparams_{deck}", run),
            ts.sparams(ports, freqs=freqs, x_op=x))


@pytest.mark.parametrize("deck", list(SPARAM_DECKS))
def test_sparams_and_stability_match_jax(deck, k3_calls):
    """The two ports are two lanes of one K3 call on the pad; the matched
    line takes K2."""
    want, got = sparams_pair(deck)
    _, ports, freqs = SPARAM_DECKS[deck]
    n = sims(SPARAM_DECKS[deck][0])[1].engine.N
    assert k3_calls == ([] if deck == "tline" else [(2, n, n)])
    assert peak_rel(got.s, want["s"]) <= 1e-9
    assert peak_rel(got.z, want["z"]) <= 1e-9
    np.testing.assert_array_equal(got.z0, want["z0"])
    mj = want["metrics"]
    mt = sims(SPARAM_DECKS[deck][0])[1].stability(sres=got)
    for k in ("k", "delta", "mu_load", "mu_src", "msg"):
        assert peak_rel(getattr(mt, k), mj[k]) <= 1e-9, k
    if deck == "pad":
        np.testing.assert_array_equal(mt.stable, mj["stable"])
        assert abs(got.s[0, 1, 0]) == pytest.approx(10 ** -0.5, rel=1e-4)
        with pytest.raises(ValueError, match="two ports"):
            sims(SPARAM_DECKS[deck][0])[1].stability(ports=ports[:1])


def _ma_complex(line):
    """The complex numbers of a Touchstone or S-CSV data line (after the
    frequency: magnitude/angle pairs)."""
    v = np.array(line.replace(",", " ").split(), float)
    return np.r_[v[0], v[1::2] * np.exp(1j * np.radians(v[2::2]))]


def test_touchstone_and_sparams_csv_match_jax(tmp_path):
    from circuitsimulator_tpu_torch.analysis import sparams as tsp
    want, got = sparams_pair("tline")
    for writer in ("write_touchstone", "write_sparams_csv"):
        getattr(tsp, writer)(str(tmp_path / "t"), got)
        t = (tmp_path / "t").read_text().splitlines()
        j = want[writer].splitlines()
        assert len(t) == len(j) > 2
        for a, b in zip(t, j):
            if a[:1] in "!#f":
                assert a == b
            else:
                assert peak_rel(_ma_complex(a), _ma_complex(b)) <= 1e-9


# ------------------------------------------------------ .TF, .SENS, .PZ
# (output kind, output node or element, reference node, input source):
# a V output with a reference against a V input, a V output against an
# I input, a branch-current output, and the deck's own .TF card
TF_CASES = {"v_ref": ("v", "out", "in", "VIN"),
            "i_input": ("v", "c", None, "Ib"),
            "i_output": ("i", "Vs", None, "VIN")}


def test_tf_matches_jax():
    from circuitsimulator_tpu.analysis.tf import dc_transfer_function as jtf
    from circuitsimulator_tpu_torch.analysis.tf import \
        dc_transfer_function as ttf
    js, ts, x = sims(MIXED)
    got = [ts.tf(x_op=x)]
    cases = []
    for kind, out, ref, src in TF_CASES.values():
        if kind == "v":
            a, b = ts._node_eq(out), ts._node_eq(ref) if ref else -1
        else:
            a, b = next(e.branch_eq for e in ts.circuit.elements
                        if e.name == out), -1
        cases.append((kind, a, b, ts._input_ref(src)))
        got.append(ttf(ts.engine, ts.params, *cases[-1], x=x))

    def run():
        xj = jax_x(MIXED)
        rs = [js.tf(x_op=xj)] + [jtf(js.engine, js.params, *c, x=xj)
                                 for c in cases]
        return [[float(r.gain), float(r.r_in),
                 None if r.r_out is None else float(r.r_out)] for r in rs]
    for g, (gain, r_in, r_out) in zip(got, jax_value("tf", run)):
        assert rel(float(g.gain), gain) <= 1e-10
        if np.isfinite(r_in):
            assert rel(float(g.r_in), r_in) <= 1e-10
        else:
            assert float(g.r_in) == r_in
        assert (g.r_out is None) == (r_out is None)
        if r_out is not None:
            assert rel(float(g.r_out), r_out) <= 1e-10


def test_sensitivity_matches_jax():
    """Every row the report prints (the thermal voltage's and the TC rows
    included: the assembly stays on the autograd graph from the cloned
    leaves) within 1e-8 of JAX's jax.vjp; rows that are zero in exact
    arithmetic within 1e-13 of the largest p dV/dp."""
    from circuitsimulator_tpu.analysis.sensitivity import (
        dc_sensitivity, sensitivity_report)
    js, ts, x = sims(MIXED)
    out = ts._node_eq(ts.config.sens.out_node)

    def run():
        gj = jax.jit(lambda p, xx: dc_sensitivity(js.engine, p, out, -1,
                                                  x=xx)[0])(js.params,
                                                            jax_x(MIXED))
        return [[r[0], float(r[1]), float(r[2])] for r in
                sensitivity_report(js.circuit, gj,
                                   normalize_params=js.params)]
    rows_j = jax_value("sensitivity", run)
    gt, rows_t = ts.sensitivity(x_op=x)
    want = {r[0]: r[1:] for r in rows_j}
    got = {r[0]: r[1:] for r in rows_t}
    assert set(got) == set(want)
    # p dV/dp is in volts: a row that is 0 in exact arithmetic (a dead-end
    # branch) may come out at roundoff on either side
    floor = 1e-13 * max(abs(v[1]) for v in want.values())
    for label, (g, n) in want.items():
        assert abs(got[label][1] - n) <= 1e-8 * abs(n) + floor, label
        if abs(n) > floor:
            assert abs(got[label][0] - g) <= 1e-8 * abs(g), label
    for label in ("d/dVt(thermal)", "d/dTC1(RL)", "d/dTC2(RL)",
                  "d/dBF(Q1)", "d/dGAIN(E1)", "d/dGM(G1)",
                  "d/dR(H1)", "d/dIS(D1)", "d/dK(M1)"):
        assert want[label][0] != 0.0, label
    assert sum(v[0] != 0.0 for v in want.values()) >= 25
    assert not gt["vs_kind"].any()       # integer leaves: zeros
    _, _, rnorm = tsens.dc_sensitivity(ts.engine, ts.params, out, x=x)
    assert float(rnorm) < 1e-9


def test_sens_tf_pz_errors():
    sim = Simulator.from_text("V1 a 0 1\nR1 a 0 1k\n.op\n", device="cpu")
    with pytest.raises(ValueError, match=".SENS card missing"):
        sim.sensitivity()
    with pytest.raises(ValueError, match=".TF card missing"):
        sim.tf()
    with pytest.raises(ValueError, match=".PZ card missing"):
        sim.pole_zero()
    assert len(sim.pole_zero(out_node="a").poles) == 0


def test_pole_zero_matches_jax():
    js, ts, x = sims(PZ_DECK)

    def run():
        r = js.pole_zero(x_op=jax_x(PZ_DECK))
        return {"poles": np.asarray(r.poles, complex),
                "zeros": np.asarray(r.zeros, complex), "sigma": r.sigma}
    want = jax_value("pole_zero", run)
    got = ts.pole_zero(x_op=x)
    assert len(got.poles) == len(want["poles"]) > 0
    assert len(got.zeros) == len(want["zeros"]) > 0
    assert got.sigma == want["sigma"]
    for a, b in ((got.poles, want["poles"]), (got.zeros, want["zeros"])):
        a, b = np.sort_complex(a), np.sort_complex(b)
        assert np.max(np.abs(a - b) / np.abs(b)) <= 1e-9


class _Record:
    """pytest plugin of ``__main__``: the cases run with ``RECORD`` on in
    the module pytest imports, and the session's end writes the golden."""

    def pytest_collection_finish(self, session):
        self.mod = session.items[0].module
        self.mod.RECORD["on"] = True

    def pytest_sessionfinish(self, session, exitstatus):
        rec = {k: v for k, v in self.mod.RECORD.items() if k != "on"}
        if exitstatus == 0:
            with open(GOLDEN, "w") as fh:
                json.dump(rec, fh)


if __name__ == "__main__":
    import sys
    sys.exit(pytest.main([__file__, "-q", "-p", "no:cacheprovider"],
                         plugins=[_Record()]))
