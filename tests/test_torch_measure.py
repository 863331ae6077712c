""".MEASURE, .FOUR and the netlist Monte-Carlo of the PyTorch port on the
CPU: the host evaluators against the JAX package's on the same numpy
waveforms, the streaming accumulators against JAX's under one jitted scan,
the DEV=/LOT= lowering and lanes, and the CLI's stdout against the JAX
CLI's goldens.  The Monte-Carlo transient entries and K1's probe stream
(K1c-i) are in tests/test_torch_measure_mc.py."""

import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from circuitsimulator_tpu.analysis import fourier as jfour
from circuitsimulator_tpu.analysis import measure as jmeas
from circuitsimulator_tpu.analysis import measure_stream as jstream
from circuitsimulator_tpu.io import csvout as jcsv
from circuitsimulator_tpu.ir.lower import lower as jax_lower
from circuitsimulator_tpu.netlist.funcs import expand_funcs
from circuitsimulator_tpu.netlist.include import expand_includes
from circuitsimulator_tpu.netlist.laplace import expand_laplace
from circuitsimulator_tpu.netlist.parser import PrintCommand as JPrint
from circuitsimulator_tpu.netlist.parser import parse_netlist_text as jparse
from circuitsimulator_tpu.netlist.urc import expand_urc
from circuitsimulator_tpu_torch import Simulator
from circuitsimulator_tpu_torch.analysis import fourier as tfour
from circuitsimulator_tpu_torch.analysis import measure as tmeas
from circuitsimulator_tpu_torch.analysis import measure_stream as tstream
from circuitsimulator_tpu_torch.cli import main
from circuitsimulator_tpu_torch.io import csvout as tcsv
from circuitsimulator_tpu_torch.netlist.parser import PrintCommand as TPrint
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc

# one intra-op thread, as in every port test file (pytest-xdist shares
# the cores between workers)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
EXAMPLES = os.path.join(REPO, "examples")
RTOL = 1e-12     # the host evaluators: the same numpy arithmetic

# every measure kind of tests/test_measure.py and tests/test_measure_stream
# .py on one deck: stat (MIN/MAX/PP/AVG/RMS/INTEG/MIN_AT/MAX_AT with
# FROM/TO), WHEN with RISE/FALL/CROSS/LAST, TRIG/TARG, FIND AT, FIND WHEN,
# a VDB and a VP probe, a branch current, an unresolvable probe and
# derived PARAM= measures
TRAN_DECK = """* every transient measure kind
.PARAM scalefac=2
V1 in 0 PULSE(0 1 0 1n 1n 1 2)
V2 s 0 SIN 0 2 1e6
R1 in out 1k
C1 out 0 1n
Rs s 0 1k
.TRAN 10n 10u
.MEASURE TRAN t63 WHEN V(out)=0.632 RISE=1
.MEASURE TRAN t90 WHEN V(out)=0.9 RISE=1
.MEASURE TRAN vmax MAX V(out)
.MEASURE TRAN vmin MIN V(s) FROM=0 TO=1u
.MEASURE TRAN vavg AVG V(out) FROM=5u TO=10u
.MEASURE TRAN srms RMS V(s) FROM=0 TO=10u
.MEASURE TRAN integ INTEG V(out) FROM=0 TO=10u
.MEASURE TRAN q INTEG I(V1) FROM=0 TO=10u
.MEASURE TRAN tpd TRIG V(in) VAL=0.5 RISE=1 TARG V(out) VAL=0.5 RISE=1
.MEASURE TRAN vat FIND V(out) AT=1u
.MEASURE TRAN fw FIND V(s) WHEN V(out)=0.632 RISE=1
.MEASURE TRAN across WHEN V(s)=0 CROSS=2
.MEASURE TRAN afall WHEN V(s)=0 FALL=1
.MEASURE TRAN slast WHEN V(s)=0 FALL=LAST
.MEASURE TRAN smaxat MAX_AT V(s) FROM=0 TO=1u
.MEASURE TRAN tmin MIN_AT V(s)
.MEASURE TRAN spp PP V(s)
.MEASURE TRAN peakdb MAX VDB(s) FROM=0 TO=2u
.MEASURE TRAN vdiff MAX V(s,out)
.MEASURE TRAN badnode MAX V(zzz)
.MEASURE TRAN nope WHEN V(out)=5 RISE=1
.MEASURE TRAN spread PARAM='t90 - t63'
.MEASURE TRAN scaled PARAM='scalefac * t63'
.FOUR 1e6 V(s) V(out) I(V1) V(s,out)
"""

AC_DECK = """* rc lowpass, f3db = 1/(2 pi RC)
V1 in 0 DC 0 AC 1
R1 in out 1k
C1 out 0 1n
.AC dec 50 1e3 1e7
.MEASURE AC f3db WHEN VDB(out)=-3.0103 FALL=1
.MEASURE AC dc_gain MAX V(out)
.MEASURE AC gain_at FIND VDB(out) AT=159.155e3
.MEASURE AC ph90 WHEN VP(out)=-45 FALL=1
.MEASURE AC re_min MIN VR(out)
.MEASURE AC im_min MIN VI(out)
.MEASURE AC bw_k PARAM='f3db/1000'
"""

DC_DECK = """* diode turn-on vs source
V1 in 0 DC 0
R1 in a 1k
D1 a 0 IS=1e-14
.DC V1 0 2 0.05
.MEASURE DC von WHEN V(a)=0.6 RISE=1
.MEASURE DC vmax MAX V(a)
"""

# tests/test_mc_netlist.py's device-tolerance deck
DEVICE_DECK = """* device mismatch MC
.MODEL mn VT 0.6 MU 2e-2 COX 1e-3
.MODEL qn NPN IS=1e-15 BF=120
.MODEL jn NJF VTO=-2 BETA=1m
VDD vdd 0 3
VIN g 0 1.2
RD vdd d 10k
M1 d g 0 b mn W=10u L=1u DEV=5%
D1 d 0 IS=1e-14 DEV=0.1 LOT=0.2
Q1 vdd g e qn DEV=0.08
RE e 0 1k
J1 vdd g s jn LOT=3%
RS s 0 1k
.op
"""


def jax_parse(text):
    """The JAX frontend on a deck's text, with the expansions of its
    Simulator.from_text (.INCLUDE, .FUNC, URC, LAPLACE)."""
    ckt, cfg = jparse(expand_laplace(expand_urc(expand_funcs(
        expand_includes(text)))))
    ckt.assign_equation_indices()
    return ckt, cfg


def both(text):
    """(port Simulator on the CPU, JAX sim config, JAX lowered circuit)."""
    tsim = Simulator.from_text(text, device="cpu")
    ckt, jcfg = jax_parse(text)
    jl = jax_lower(ckt)
    assert list(jl.topo.volt_col_names) == list(tsim.topo.volt_col_names)
    assert list(jl.topo.branch_col_names) == list(tsim.topo.branch_col_names)
    return tsim, jcfg, jl


def waveforms(topo, t, rng, complex_=False):
    """(T, N) waveforms: each unknown a smooth curve of its own (a sine, an
    RC charge, a ramp) plus a little noise, so every crossing and window
    statistic has work to do."""
    N = topo.n_unknowns
    cols = []
    for j in range(N):
        w = 2 * np.pi * (j + 1) / (t[-1] - t[0] or 1.0)
        c = ((2.0 * np.sin(w * (t - t[0]) + 0.3 * j)) if j % 2 else
             (1.0 - np.exp(-(t - t[0]) / ((t[-1] - t[0]) / 8 or 1.0))))
        c = c + 1e-3 * rng.standard_normal(t.size)
        if complex_:
            c = c * np.exp(-1j * w * (t - t[0]) / 4)
        cols.append(c)
    return np.stack(cols, 1)


def assert_same(a, b, rtol=RTOL):
    assert len(a) == len(b)
    for (na, va), (nb, vb) in zip(a, b):
        assert na == nb
        if math.isnan(vb):
            assert math.isnan(va), na
        else:
            assert va == pytest.approx(vb, rel=rtol, abs=0.0), na


@pytest.mark.parametrize("analysis", ["tran", "ac", "dc"])
def test_host_measures_match_jax(analysis):
    """run_measures and measure_report on the same numpy waveforms: the
    transient deck (every kind), the AC deck (complex data, VDB/VP/VR/VI
    modifiers) and the DC deck (a swept-source axis), within 1e-12."""
    text = {"tran": TRAN_DECK, "ac": AC_DECK, "dc": DC_DECK}[analysis]
    tsim, jcfg, jl = both(text)
    rng = np.random.default_rng(7)
    if analysis == "tran":
        axis = np.linspace(0.0, 10e-6, 1001)
    elif analysis == "ac":
        axis = np.logspace(3, 7, 201)
    else:
        axis = np.arange(0.0, 2.0 + 1e-9, 0.05)
    xs = waveforms(tsim.topo, axis, rng, complex_=analysis == "ac")
    got = tmeas.run_measures(tsim.config.measures, tsim.topo, axis, xs,
                             analysis, bindings=tsim.config.param_values)
    want = jmeas.run_measures(jcfg.measures, jl.topo, axis, xs, analysis,
                              bindings=jcfg.param_values)
    assert len(got) == sum(m.analysis == analysis for m in jcfg.measures)
    assert sum(not math.isnan(v) for _, v in got) >= 2
    assert_same(got, want)
    assert tmeas.measure_report(got) == jmeas.measure_report(want)


def test_fourier_matches_jax():
    """fourier_of_samples on a pure tone and fourier_analysis /
    fourier_table over the .FOUR probes (probe_selection: node, branch and
    differential columns) on the same numpy waveform, within 1e-12."""
    f0 = 1e6
    t = np.linspace(0, 3 / f0, 3001)
    v = (0.25 + 2.0 * np.sin(2 * np.pi * f0 * t + 0.3)
         + 0.5 * np.cos(2 * np.pi * 3 * f0 * t))
    for a, b in zip(tfour.fourier_of_samples(t, v, f0, n_harm=5),
                    jfour.fourier_of_samples(t, v, f0, n_harm=5)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
    with pytest.raises(ValueError, match="full period"):
        tfour.fourier_of_samples(np.linspace(0, 1e-7, 10), np.zeros(10), f0)
    tsim, jcfg, jl = both(TRAN_DECK)
    cfg = tsim.config.four
    sel = tcsv.probe_selection(tsim.topo,
                               [TPrint(analysis="none", probes=cfg.probes)])
    jsel = jcsv.probe_selection(
        jl.topo, [JPrint(analysis="none", probes=jcfg.four.probes)])
    assert sel == jsel and len(sel) == 4
    tt = np.linspace(0.0, 10e-6, 1001)
    xs = waveforms(tsim.topo, tt, np.random.default_rng(3))
    got = tfour.fourier_analysis(tt, xs, cfg.f0, sel)
    want = jfour.fourier_analysis(tt, xs, jcfg.four.f0, jsel)
    for a, b in zip(got.rows, want.rows):
        assert a.label == b.label
        for f in ("dc", "mag", "phase_deg", "norm_mag", "thd"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=RTOL, atol=0)
    assert tfour.fourier_table(got) == jfour.fourier_table(want)


def test_simulator_measure_and_fourier_match_jax():
    """Simulator.measure / .fourier on a finished port transient: the same
    waveform through the JAX evaluators gives the same numbers; .MEASURE
    AC through Simulator.ac; .MEASURE DC over a DC sweep (the deck has no
    DC card: none, as JAX's evaluator gives); the errors of .FOUR."""
    tsim, jcfg, jl = both(TRAN_DECK.replace(".TRAN 10n 10u", ".TRAN 50n 3u"))
    res = tsim.transient()
    t, xs = res.times.numpy(), res.xs.numpy()
    assert_same(tsim.measure(res),
                jmeas.run_measures(jcfg.measures, jl.topo, t, xs, "tran",
                                   bindings=jcfg.param_values))
    four = tsim.fourier(res)
    assert [r.label for r in four.rows] == ["V(s)", "V(out)", "I(V1)",
                                            "V(s)-V(out)"]
    np.testing.assert_allclose(four.rows[0].mag[0], 2.0, rtol=1e-2)
    # .MEASURE DC was refused here until the .DC sweep was ported
    sw = tsim.dc_sweep(source="V1", values=[0.0, 1.0])
    assert tsim.measure(sw, analysis="dc") == jmeas.run_measures(
        jcfg.measures, jl.topo, sw.values, sw.xs.numpy(), "dc",
        bindings=jcfg.param_values) == []
    plain = Simulator.from_text("V1 a 0 SIN 0 1 1e6\nR1 a 0 1k\n"
                                ".TRAN 1e-8 4e-7\n", device="cpu")
    with pytest.raises(ValueError, match=".FOUR card missing"):
        plain.fourier(plain.transient())
    asim, ajcfg, ajl = both(AC_DECK)
    acres = asim.ac()
    got = asim.measure(acres, analysis="ac")
    assert_same(got, jmeas.run_measures(ajcfg.measures, ajl.topo,
                                        acres.freqs, acres.xs, "ac",
                                        bindings=ajcfg.param_values))
    f0 = 1.0 / (2 * np.pi * 1e3 * 1e-9)
    assert dict(got)["f3db"] == pytest.approx(f0, rel=2e-2)


def _jax_stream(sm, raw, ts, dt):
    """JAX's accumulators over the (T + 1, B, P) raw stream, one jitted
    scan (the first row is t = 0)."""
    def run(raw, ts):
        ys = sm.vals_from_raw(raw)
        acc = sm.init_vals(ys[0])

        def body(a, inp):
            y, t = inp
            return sm.update_vals(a, y, t, jnp.asarray(dt, jnp.float64)), None

        acc, _ = lax.scan(body, acc, (ys[1:], ts))
        return sm.finalize(acc)

    return {k: np.asarray(v) for k, v in jax.jit(run)(raw, ts).items()}


def test_streaming_accumulators_match_jax():
    """StreamingMeasures on the same numpy (T, B, P) probe stream in f64:
    every kind (stat with FROM/TO, WHEN with RISE/FALL/CROSS/LAST,
    TRIG/TARG, FIND AT, FIND WHEN, a VDB probe, an unresolvable probe) and
    the derived PARAM= measures, against JAX's accumulators under one
    jitted lax.scan, within 1e-12."""
    tsim, jcfg, jl = both(TRAN_DECK)
    sm = tstream.StreamingMeasures(tsim.config.measures, tsim.topo,
                                   torch.float64)
    jsm = jstream.StreamingMeasures(jcfg.measures, jl.topo, jnp.float64)
    np.testing.assert_array_equal(sm.probe_matrix.numpy(),
                                  np.asarray(jsm.probe_matrix))
    P = sm.probe_matrix.shape[0]
    assert P >= 5 and any(sm._db)
    T, B, dt = 400, 6, 25e-9
    ts = np.arange(1, T + 1) * dt
    rng = np.random.default_rng(11)
    tt = np.concatenate([[0.0], ts])[:, None, None]
    amp = 1.0 + 0.2 * rng.standard_normal((1, B, P))
    ph = rng.uniform(0, 2 * np.pi, (1, B, P))
    raw = (amp * np.sin(2 * np.pi * 1e6 * tt + ph)
           + 0.5 * (1 - np.exp(-tt / 2e-6))
           + 1e-3 * rng.standard_normal((T + 1, B, P)))
    raw[:, 0, :] = 0.0            # a lane with no crossing and a 0 V probe
    want = _jax_stream(jsm, jnp.asarray(raw), jnp.asarray(ts), dt)
    acc = sm.init_vals(sm.vals_from_raw(torch.as_tensor(raw[0])))
    ys = sm.vals_from_raw(torch.as_tensor(raw[1:]))
    dt_t = torch.tensor(dt, dtype=torch.float64)
    for i, t in enumerate(torch.as_tensor(ts)):
        acc = sm.update_vals(acc, ys[i], t, dt_t)
    got = {k: v.numpy() for k, v in sm.finalize(acc).items()}
    assert set(got) == set(want)
    got = tstream.apply_derived_measures(tsim.config.measures, got,
                                         tsim.config.param_values)
    want = jstream.apply_derived_measures(jcfg.measures, want,
                                          jcfg.param_values)
    assert "spread" in got and "scaled" in got
    finite = 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=0,
                                   err_msg=name)
        finite += int(np.isfinite(w).sum())
    assert finite > len(want) * B // 2


def test_mc_tols_match_jax():
    """LoweredCircuit.mc_tols on examples/mc_filter.sp and on the device
    tolerance deck equal the JAX lowering's."""
    with open(os.path.join(EXAMPLES, "mc_filter.sp")) as f:
        mc_text = f.read()
    for text, keys in ((mc_text, {"res_r", "cap_c"}),
                       (DEVICE_DECK, {"mos_vth", "dio_is", "bjt_bf",
                                      "jf_vto"})):
        tsim = Simulator.from_text(text, device="cpu")
        want = jax_lower(jax_parse(text)[0]).mc_tols
        got = tsim.lowered.mc_tols
        assert set(got) == set(want) == keys
        for k in want:
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, b)


def test_perturb_params_netlist():
    """The lanes are value * exp(dev z + lot z_lot) exactly under the
    documented draw order; LOT is one draw per lane shared by every
    element; the stratified samplers are refused by name."""
    sim = Simulator.from_text(DEVICE_DECK.replace(
        "RD vdd d 10k", "RD vdd d 10k LOT=10%").replace(
        "RE e 0 1k", "RE e 0 1k LOT=10%"), device="cpu")
    tols = sim.lowered.mc_tols
    B = 64
    bp = tmc.perturb_params_netlist(sim.params, torch.Generator().manual_seed(
        4), B, tols)
    g = torch.Generator().manual_seed(4)
    lot = torch.randn((B, 1), generator=g, dtype=torch.float64)
    for name in sorted(tols):
        arr = sim.params[name]
        z = torch.randn((B,) + arr.shape, generator=g, dtype=arr.dtype)
        dev, lt = (torch.as_tensor(v, dtype=arr.dtype) for v in tols[name])
        assert torch.equal(bp[name], arr[None] * torch.exp(dev * z + lt * lot))
    r = bp["res_r"]
    names = [e.name for e in sim.circuit.elements if e.name.startswith("R")]
    rd, re = names.index("RD"), names.index("RE")
    ratio = r[:, rd] / r[:, re] / (sim.params["res_r"][rd]
                                   / sim.params["res_r"][re])
    np.testing.assert_allclose(ratio.numpy(), 1.0, rtol=1e-12)
    assert float(r[:, rd].std()) > 0.0
    assert torch.equal(bp["mos_k"], sim.params["mos_k"].expand(B, -1))
    assert bool((bp["jf_vto"] < 0).all())
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        tmc.perturb_params_netlist(sim.params, torch.Generator(), 4, tols,
                                   sampler="lhs")


def stage(tmp_path, deck):
    """The goldens name the deck as examples/<deck>.sp, relative to the
    working directory, and the CSV as <deck>_tran.csv."""
    d = tmp_path / "examples"
    d.mkdir(exist_ok=True)
    shutil.copy(os.path.join(EXAMPLES, f"{deck}.sp"), d)
    return f"examples/{deck}.sp"


def read_golden(name):
    with open(os.path.join(GOLDENS, name)) as f:
        return f.read()


def test_cli_rc_step_stdout_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """examples/rc_step.sp (two WHEN measures over 2,000 steps): stdout
    byte-identical to the JAX CLI's (tests/goldens/rc_step_stdout_jax.txt)."""
    deck = stage(tmp_path, "rc_step")
    monkeypatch.chdir(tmp_path)
    assert main([deck, "rc_step_tran.csv", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == read_golden("rc_step_stdout_jax.txt")


def test_cli_mc_filter_stdout_and_run_mc(tmp_path, monkeypatch, capsys):
    """examples/mc_filter.sp: the stdout of the plain run byte-identical to
    the JAX CLI's (tests/goldens/mc_filter_stdout_jax.txt), then --run-mc
    64 writes the lane,settle,vfinal CSV with 64 rows and prints the
    statistics block; a .MEASURE DC card without --run-dc-sweep is left
    alone, as the JAX CLI leaves it (it was named on stderr and skipped
    until the .DC sweep was ported)."""
    deck = stage(tmp_path, "mc_filter")
    monkeypatch.chdir(tmp_path)
    with open(deck, "a") as f:
        f.write(".MEASURE DC vdc MAX V(out)\n")
    assert main([deck, "mc_filter_tran.csv", "--device", "cpu",
                 "--run-mc", "64", "--run-mc-out", "mc.csv"]) == 0
    out = capsys.readouterr()
    gold = read_golden("mc_filter_stdout_jax.txt")
    assert out.out.startswith(gold)
    tail = out.out[len(gold):].splitlines()
    assert tail[:4] == ["", "Running Monte-Carlo (64 lanes, one batched "
                        "solve)...", "", "==== Monte-Carlo measure "
                        "statistics ===="]
    assert tail[4].split(":")[0].strip() == "settle"
    assert tail[5].split(":")[0].strip() == "vfinal"
    assert tail[6] == ("Monte-Carlo finished. Per-lane results written to "
                       "'mc.csv'.")
    assert ".MEASURE DC" not in out.err and len(tail) == 7
    lines = (tmp_path / "mc.csv").read_text().splitlines()
    assert lines[0] == "lane,settle,vfinal" and len(lines) == 65
    vals = np.loadtxt(tmp_path / "mc.csv", delimiter=",", skiprows=1)
    assert np.isfinite(vals).all() and vals[:, 1].std() > 0
    np.testing.assert_allclose(np.median(vals[:, 2]), 0.995, atol=5e-3)


def test_cli_prints_measures_and_fourier(tmp_path, monkeypatch, capsys):
    """After the transient the CLI prints the .MEASURE TRAN block, then the
    .FOUR table, each equal to the report of Simulator.measure/.fourier on
    the same run."""
    deck = tmp_path / "m.sp"
    deck.write_text(TRAN_DECK.replace(".TRAN 10n 10u", ".TRAN 50n 3u"))
    monkeypatch.chdir(tmp_path)
    assert main([str(deck), "m.csv", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    sim = Simulator.from_file(str(deck), device="cpu")
    res = sim.transient()
    want = ("finished. Results written to 'm.csv'.\n\n"
            + tmeas.measure_report(sim.measure(res)) + "\n\n"
            + tfour.fourier_table(sim.fourier(res)) + "\n")
    assert out.endswith(want)


def test_cli_bjt_amp_run_ac_measures(tmp_path, monkeypatch, capsys):
    """examples/bjt_amp.sp with --run-ac: the whole stdout, its .MEASURE
    TRAN and .MEASURE AC blocks and the .TF block after them,
    byte-identical to the JAX CLI's
    (tests/goldens/bjt_amp_run_ac_stdout_jax.txt), and nothing on stderr."""
    deck = stage(tmp_path, "bjt_amp")
    monkeypatch.chdir(tmp_path)
    assert main([deck, "bjt_amp_tran.csv", "--device", "cpu", "--run-ac",
                 "bjt_amp_ac.csv"]) == 0
    out = capsys.readouterr()
    assert out.out == read_golden("bjt_amp_run_ac_stdout_jax.txt")
    assert "==== Transfer function ====" in out.out and out.err == ""
