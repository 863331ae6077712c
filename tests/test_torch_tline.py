"""Lossless transmission lines (T) in the PyTorch port on the CPU: the
Engine's stamps, EMF columns, delay counts and ring against the JAX
Engine; f64 transients, the DC short and the per-frequency AC route against
JAX; K1c-ii (the fused chunk's delay ring): its plain version against the
JAX Pallas kernel in interpret mode on a two-line deck and against the
port's non-fused loop across a chunk boundary; the gate; the CLI on
examples/tline_reflect.sp against the JAX CLI's goldens.  Each JAX
computation is shared between the cases of its deck."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.analysis import ac as tac
from circuitsimulator_tpu_torch.cli import main
from circuitsimulator_tpu_torch.convert import params_from_numpy
from circuitsimulator_tpu_torch.ops import fused_step
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc
from test_torch_fused_step import damped, dc_points, draw_lanes, jax_runner

# one intra-op thread, as in every port test file (pytest-xdist shares
# the cores between workers)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
REFLECT = os.path.join(REPO, "examples", "tline_reflect.sp")
RTOL = 1e-12

# the decks of tests/test_tline.py
MATCHED = """* matched 50-ohm line, TD=10ns
V1 src 0 PULSE(0 1 0 1p 1p 1 2)
Rs src in 50
T1 in 0 out 0 Z0=50 TD=10n
Rl out 0 50
.TRAN 0.1n 40n
"""
DC_SHORT = """* dc through line
V1 a 0 DC 3
R1 a in 1k
T1 in 0 out 0 Z0=75 TD=5n
R2 out 0 2k
.op
"""
AC_MATCHED = """* ac matched line
V1 src 0 DC 0 AC 1
Rs src in 50
T1 in 0 out 0 Z0=50 TD=10n
Rl out 0 50
.AC lin 5 1e6 9e6
"""
AC_QUARTER = """* quarter wave
V1 src 0 DC 0 AC 1
Rs src in 200
T1 in 0 out 0 Z0=100 TD=2.5n
Rl out 0 50
.AC lin 1 1e8 1e8
"""
# the diode-clamp deck of tests/test_pallas_step.py, and the same with a
# second line of another delay: at dt = 0.25 ns ticks 8 and 5
TL_DECK = """* T-line reflections + diode clamp at the far end
V1 in 0 PULSE(0 1 1n 0.2n 0.2n 6n 0)
RS in a 50
T1 a 0 b 0 Z0=50 TD=2n
RL b 0 200
D1 b 0
.op
"""
TL2_DECK = TL_DECK.replace(".op", """T2 b 0 c 0 Z0=75 TD=1.25n
RC c 0 100
.op""")


def eq(sim, name):
    return sim.circuit.nodes[sim.circuit.node_name_to_id[name]].eq_index


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(initial=0.0),
                                               1e-30))


def waves(sim, xs, z0):
    """w = V(p) - V(n) + Z0 i of both ports, from numpy xs (..., N)."""
    t = sim.topo
    xe = np.concatenate([xs, np.zeros(xs.shape[:-1] + (1,))], -1)
    return np.concatenate(
        [xe[..., t.tl_ep1] - xe[..., t.tl_em1] + z0 * xe[..., t.tl_k1],
         xe[..., t.tl_ep2] - xe[..., t.tl_em2] + z0 * xe[..., t.tl_k2]], -1)


@pytest.mark.parametrize("text", ["reflect", TL_DECK],
                         ids=["tline_reflect", "tl_deck"])
def test_engine_matches_jax(text):
    """The DC and transient COO entries, rhs_mat, tl_ticks, the ring of
    init_state, the RHS with the EMFs and the ring push, in f64 at
    rtol 1e-12 (one JAX computation per deck)."""
    if text == "reflect":
        js, ts = JaxSimulator.from_file(REFLECT), Simulator.from_file(
            REFLECT, device="cpu")
    else:
        js, ts = JaxSimulator.from_text(text), Simulator.from_text(
            text, device="cpu")
    je, te = js.engine, ts.engine
    dt, t = 0.25e-9, 3.3e-9
    assert np.array_equal(te.tl_ticks(dt), je.tl_ticks(dt))
    assert list(te.tl_ticks(1e-10)) == ([100] if text == "reflect" else [20])
    rng = np.random.default_rng(8)
    x, x2 = rng.uniform(-1.0, 1.0, (2, te.N))

    @jax.jit
    def ref(p, x, x2):
        # dt stays a Python float: the ring's length is static
        s = je.init_state(x, p, dt)
        # make the ring's slots differ, so the EMF columns are exercised
        s = je.make_update_state(dt)(p, x2, s)
        return (je.dc_static_entries(p)[2],
                je.tran_static_entries(p, jnp.asarray(dt), 1e-6)[2], s,
                je.make_tran_static_I(dt)(p, s, jnp.asarray(t)))

    jdc, jtr, js_, jI = ref(js.params, jnp.asarray(x), jnp.asarray(x2))
    tp = ts.params
    rows, cols, vals = te.dc_static_entries(tp)
    jr, jc, _ = je.dc_static_entries(js.params)
    assert np.array_equal(rows, jr) and np.array_equal(cols, jc)
    close(vals, jdc)
    rows, cols, vals = te.tran_static_entries(tp, torch.tensor(dt), 1e-6)
    jr, jc, _ = je.tran_static_entries(js.params, jnp.asarray(dt), 1e-6)
    assert np.array_equal(rows, jr) and np.array_equal(cols, jc)
    close(vals, jtr)
    close(te.rhs_mat, je.rhs_mat)
    s = te.init_state(torch.as_tensor(x), tp, dt)
    s = te.make_update_state(dt)(tp, torch.as_tensor(x2), s)
    for key in ("vc", "il", "tlw"):
        close(s[key], js_[key])
    close(te.make_tran_static_I(dt)(tp, s, torch.tensor(t)), jI)
    with pytest.raises(ValueError, match="init_state"):
        te.init_state(torch.as_tensor(x), tp)


@pytest.fixture(scope="module")
def matched_jax():
    """JAX transients of the matched and the open-end line: one Simulator,
    the open end through its params (one compile)."""
    js = JaxSimulator.from_text(MATCHED)
    openp = dict(js.params)
    openp["res_r"] = openp["res_r"].at[1].set(1e9)
    return js, [np.asarray(js.transient(params=p).xs)
                for p in (js.params, openp)]


@pytest.mark.parametrize("end", ["matched", "open"])
def test_transient_matches_jax(matched_jax, end):
    """f64 transients of the matched and the open-end line of
    tests/test_tline.py within 1e-9 V of JAX; the ring after the run (from
    the batched loop's carry) within 1e-9 V of the JAX waveform's last
    Dmax waves."""
    js, runs = matched_jax
    jxs = runs[end == "open"]
    text = MATCHED if end == "matched" else MATCHED.replace(
        "Rl out 0 50", "Rl out 0 1e9")
    ts = Simulator.from_text(text, device="cpu")
    res = ts.transient()
    np.testing.assert_allclose(res.xs.numpy(), jxs, rtol=0, atol=1e-9)
    dt = 1e-10
    carry = tmc.init_carry(ts.engine, res.xs[0], ts.params, dt)
    carry = tmc.batched_transient_chunk(ts.engine, ts.params, carry,
                                        res.times[1:], dt)[0]
    want = waves(ts, jxs[::-1][:100], float(ts.params["tl_z0"][0]))
    np.testing.assert_allclose(carry[1]["tlw"].numpy(), want, rtol=0,
                               atol=1e-9)
    vout = res.xs.numpy()[:, eq(ts, "out")]
    assert abs(vout[-1] - (0.5 if end == "matched" else 1.0)) < 5e-3


def test_dc_is_a_short():
    """tests/test_tline.py's DC deck: the 1k/2k divider across the line,
    V(in) = V(out) = 2 V within 1e-12."""
    ts = Simulator.from_text(DC_SHORT, device="cpu")
    x = ts.dc().numpy()
    assert abs(x[eq(ts, "out")] - 2.0) <= 1e-12
    assert abs(x[eq(ts, "in")] - 2.0) <= 1e-12


@pytest.mark.parametrize("text", [AC_MATCHED, AC_QUARTER],
                         ids=["matched", "quarter_wave"])
def test_ac_matches_jax(text, monkeypatch):
    """The matched line and the quarter-wave transformer through the
    per-frequency route: Simulator.ac within 1e-12 of the peak of JAX's in
    f64; then four perturbed lanes through make_ac_batched_fn, with K3
    (ac_sweep) made to raise, each lane equal to its own single-lane sweep
    at rtol 1e-12."""
    js = JaxSimulator.from_text(text)
    ts = Simulator.from_text(text, device="cpu")
    want = np.asarray(js.ac().xs)
    got = ts.ac().xs
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())

    def no_k3(*a, **k):
        raise AssertionError("a T-line deck reached K3")

    monkeypatch.setattr(tac, "ac_sweep", no_k3)
    jp = draw_lanes(js.params, 4, seed=2, sigmas=(("res_r", 0.05),
                                                  ("tl_z0", 0.05)))
    bp = params_from_numpy({k: np.array(v) for k, v in jp.items()})
    cfg = ts.config.ac
    freqs = tac.sweep_frequencies(cfg.sweep_type, cfg.n_points, cfg.fstart,
                                  cfg.fstop)
    x_ops = tmc.batched_dc_fast(ts.engine, bp)
    xr, xi = tac.make_ac_batched_fn(ts.engine, freqs)(bp, x_ops)
    for lane in range(4):
        one = tac.ac_analysis(ts.engine, {k: v[lane] for k, v in bp.items()},
                              freqs, x_op=x_ops[lane]).xs
        close(xr[lane].numpy() + 1j * xi[lane].numpy(), one)


def test_k1c_ii_plain_matches_jax_pallas_kernel():
    """K1c-ii's plain version against the JAX kernel in interpret mode
    (tlw=) on TL_DECK with a second line of another delay (nT = 2, read
    slots 7 and 4 at dt = 0.25 ns), B = 128, 40 steps, f32 damped, from
    the port's f64 batched DC: x and the ring within 5e-6 V, the bar of
    tests/test_pallas_step.py."""
    B, steps, dt = 128, 40, 0.25e-9
    js = JaxSimulator.from_text(TL2_DECK,
                                opts=damped(JAX_OPTIONS, jnp.float32))
    je = js.engine
    jp = draw_lanes(js.params, B, sigmas=(("res_r", 0.02),))
    x0 = jnp.asarray(dc_points(TL2_DECK, jp))
    ts = Simulator.from_text(TL2_DECK, device="cpu",
                             opts=damped(DEFAULT_OPTIONS, torch.float32))
    tp = params_from_numpy({k: np.array(v) for k, v in jp.items()},
                           dtype=torch.float32)
    x = torch.as_tensor(np.array(x0))
    st = ts.engine.init_state(x, tp, dt)
    runner = jax_runner(je, jp, dt)
    assert (runner.nT, runner.Dmax) == (2, 8)
    assert list(runner.tl_read) == [7, 4]
    want = runner.run_chunk(x0, x0, jnp.asarray(st["vc"].numpy()),
                            jnp.asarray(st["il"].numpy()),
                            jnp.zeros((B,), bool), 0, steps, interpret=True,
                            tlw=jnp.asarray(st["tlw"].numpy()))
    want = [np.asarray(a) for a in want]
    tr = fused_step.FusedStepRunner(ts.engine, tp, dt)
    got = tr.run_chunk_plain(x, x, st["vc"], st["il"],
                             torch.zeros((B,), dtype=torch.bool), 0, steps,
                             tlw=st["tlw"])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=5e-6)
    np.testing.assert_allclose(got[-1].numpy(), want[-1], rtol=0, atol=5e-6)
    np.testing.assert_array_equal(got[4].numpy(), want[4])
    assert not got[4].any() and got[5].min() > 0


def test_fused_plain_matches_nonfused_across_chunks():
    """tline_reflect.sp in f64, B = 16 lanes (Rs perturbed 2%): the fused
    carry (K1's plain version, two chunks of 150 steps, so the ring of 100
    slots crosses a chunk boundary mid-way) against the non-fused loop
    within 1e-12 V, x and ring."""
    ts = Simulator.from_file(REFLECT, device="cpu")
    bp = tmc.perturb_params(ts.params, torch.Generator().manual_seed(0), 16,
                            {"res_r": 0.02})
    dt = 1e-10
    carry, advance, meta = tmc.make_fused_transient_fn(ts.engine, bp, dt,
                                                       chunk=150)
    assert len(carry) == 6 and meta["runner"].Dmax == 100
    ref = tmc.init_carry(ts.engine, carry[0], bp, dt)
    for s in (0, 150):
        carry = advance(carry, s)[0]
    ts_ = torch.arange(1, 301, dtype=torch.float64) * torch.tensor(dt)
    ref = tmc.batched_transient_chunk(ts.engine, bp, ref, ts_, dt)[0]
    np.testing.assert_allclose(carry[0].numpy(), ref[0].numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(carry[5].numpy(), ref[1]["tlw"].numpy(),
                               rtol=0, atol=1e-12)


def test_gate():
    """Refused by name: no dt, nine lines, a ring of more than 1024 waves;
    admitted: TL_DECK at dt = 0.25 ns (tests/test_pallas_step.py)."""
    eng = Simulator.from_text(TL_DECK, device="cpu").engine
    assert "need dt" in fused_step.unsupported_reason(eng)
    assert fused_step.supported(eng, 0.25e-9)
    assert "ring" in fused_step.unsupported_reason(eng, 1e-12)
    nine = "".join(f"T{i} a 0 b{i} 0 Z0=50 TD=1n\nR{i} b{i} 0 50\n"
                   for i in range(2, 10))
    eng9 = Simulator.from_text(TL_DECK.replace(".op", nine + ".op"),
                               device="cpu").engine
    assert "9 transmission lines > 8" in fused_step.unsupported_reason(
        eng9, 0.25e-9)
    with pytest.raises(NotImplementedError, match="need dt"):
        fused_step.FusedStepRunner(eng, tmc.broadcast_params(
            Simulator.from_text(TL_DECK, device="cpu").params, 4), None)


def test_cli_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """examples/tline_reflect.sp through the CLI: stdout (DC tables, the
    transient and its WHEN and MAX measures) byte-identical to the JAX
    CLI's (tests/goldens/tline_reflect_stdout_jax.txt), the CSV within
    1e-9 V of the JAX CLI's (tests/goldens/tline_reflect_tran_jax.csv)."""
    (tmp_path / "examples").mkdir()
    shutil.copy(REFLECT, tmp_path / "examples")
    monkeypatch.chdir(tmp_path)
    assert main(["examples/tline_reflect.sp", "tline_reflect_tran.csv",
                 "--device", "cpu"]) == 0
    with open(os.path.join(GOLDENS, "tline_reflect_stdout_jax.txt")) as f:
        assert capsys.readouterr().out == f.read()
    with open(tmp_path / "tline_reflect_tran.csv") as f, open(
            os.path.join(GOLDENS, "tline_reflect_tran_jax.csv")) as g:
        assert f.readline() == g.readline()
    got = np.loadtxt(tmp_path / "tline_reflect_tran.csv", delimiter=",",
                     skiprows=1)
    want = np.loadtxt(os.path.join(GOLDENS, "tline_reflect_tran_jax.csv"),
                      delimiter=",", skiprows=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
