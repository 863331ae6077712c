"""The port's autonomous harmonic balance on the CPU, f64, against the JAX
package: ``hbosc.oscillator_hb`` (dense and GMRES) on van der Pol, the
Meissner MOS + K deck and the delay-line oscillator of
``examples/delay_osc.sp``; the HB PPV phase noise and injection lock; the
Monte-Carlo oscillators (``Simulator.monte_carlo_oscillator_phase_noise``:
the batched HB and the batched inverse-iteration PPV, f64, and f32 lanes);
subharmonic locking (the driven-HB fold search); and the CLI's
``--run-osc`` (HB, ``--osc-method``, ``--hb-solver``) and
``--run-subharmonic-lock``.

The JAX results are ``tests/goldens/hbosc_jax.npz`` and the JAX CLI's
``tests/goldens/osc_cli_hb_*_jax.*``; ``PYTHONPATH=. JAX_PLATFORMS=cpu
python tests/test_torch_hbosc.py`` remakes them.  The warm-ups are those
of ``tests/test_torch_osc.py`` (HB_WARM); the delay-line deck keeps the
solver's defaults (256 steps a period, 30 periods: shorter warm-ups settle
on another mode), and the port replays JAX's recorded warm-up samples
there (``warm_delay`` in the golden: the warm-up transient is the port's
tested ``lu`` trapezoidal step; 7,680 of its steps would take minutes on
the CPU).  The phase-noise and lock cases start from JAX's converged HB
in the golden.

Bars: f0 1e-9 relative and X 1e-8 V, Newton counts equal; c, period
jitter and lock ranges 1e-6 relative, L(df) 1e-4 dB; batched lanes f0
1e-8 relative with equal converged masks; f32 lanes f0 1e-4 relative of
JAX's f32; subharmonic edges: the same lock decisions, the edges within
rel_tol f0/m."""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import test_torch_osc as base
from test_torch_osc import (HB_WARM, SHOOT_MEISSNER, VDP, MEISSNER, OFFSETS,
                            host, mod, sim_of, eq_of, rel_err)

torch.set_num_threads(1)

REPO = base.REPO
GOLDEN = os.path.join(base.GOLDENS, "hbosc_jax.npz")
DELAY = open(os.path.join(REPO, "examples", "delay_osc.sp")).read()
VDP_TOL = (VDP.replace("L1 a 0 1u", "L1 a 0 1u DEV=2%")
           .replace("C1 a 0 1n", "C1 a 0 1n DEV=2%")
           .replace("Rl a 0 2k", "Rl a 0 2k DEV=5%"))
VDP2 = VDP.replace("0.5m*v(a)**3", "0.5m*v(a)**3 + 2m*v(a)**2")
HB_DECKS = {"vdp": (VDP, 5e6, "a", dict(HB_WARM)),
            "meissner": (MEISSNER, 1.6e6, "g",
                         dict(n_harm=9, **SHOOT_MEISSNER)),
            "delay": (DELAY, 1e8, "a", {})}
MC_LEAVES = ("ind_l", "cap_c", "res_r")


def hb_out(r):
    return {"f0": np.asarray(float(r.f0)), "times": host(r.times),
            "xs": host(r.xs), "spectrum": host(r.spectrum),
            "freqs": host(r.freqs), "iters": np.asarray(r.newton_iters),
            "residual": np.asarray(float(r.residual)),
            "converged": np.asarray(bool(r.converged))}


def hb_from(pkg, g):
    cls = mod(pkg, "analysis.hbosc").HBOscResult
    conv = (torch.as_tensor if pkg == "torch"
            else __import__("jax.numpy").numpy.asarray)
    return cls(f0=float(g["f0"]), times=conv(g["times"]), xs=conv(g["xs"]),
               freqs=conv(g["freqs"]), spectrum=np.asarray(g["spectrum"]),
               residual=float(g["residual"]), newton_iters=int(g["iters"]),
               converged=bool(g["converged"]))


def case_warm_delay(pkg, g):
    """JAX's warm-up of oscillator_hb on the delay deck at its defaults
    (the same program as hbosc.oscillator_hb's): the samples the port
    replays."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from circuitsimulator_tpu.analysis.dc import dc_operating_point
    from circuitsimulator_tpu.analysis.sstate import osc_engine
    from circuitsimulator_tpu.analysis.transient import transient_step_fn
    s = sim_of("jax", DELAY)
    eng = osc_engine(s.engine)
    Kw, wp, kick = 256, 30, 0.5
    dt_w = jnp.asarray(1.0 / (1e8 * Kw), eng.dtype)
    step_w = transient_step_fn(eng, s.params, dt_w)
    x0 = dc_operating_point(eng, s.params)
    x0 = x0.at[eq_of(s, "a")].add(jnp.asarray(kick, eng.dtype))
    carry = (x0, eng.init_state(x0, s.params, dt_w),
             jnp.zeros(x0.shape[:-1], bool))
    tw = jnp.arange(1, wp * Kw + 1, dtype=eng.dtype) * dt_w

    def wbody(c, t):
        c, (xo, _) = step_w(c, t)
        return c, xo
    _, xs_w = jax.jit(lambda c, t: lax.scan(wbody, c, t))(carry, tw)
    return {"xs": np.asarray(xs_w), "dt": np.asarray(float(dt_w))}


def case_hb(pkg, g, deck, solver):
    text, f0, node, kw = HB_DECKS[deck]
    return hb_out(sim_of(pkg, text).oscillator_hb(f0, node, solver=solver,
                                                  **kw))


def pnhb_out(p):
    return {"c": np.asarray(p.c), "c_flicker": np.asarray(p.c_flicker),
            "L_dbc": np.asarray(p.L_dbc),
            "period_jitter": np.asarray(p.period_jitter),
            "per_source": np.asarray(p.per_source), "ppv": host(p.ppv),
            "invariance": np.asarray(p.invariance),
            "sv_gap": np.asarray(p.sv_gap)}


def case_pn_hb(pkg, g, deck):
    text, _, node, _ = HB_DECKS[deck]
    s = sim_of(pkg, text)
    kw = {}
    if deck == "delay":
        kw = dict(extra_pairs=[(eq_of(s, node), -1)], extra_psd=[1e-18])
    return pnhb_out(s.oscillator_phase_noise_hb(
        OFFSETS, osc=hb_from(pkg, g[f"hb_{deck}_dense"]), **kw))


def case_lock_hb(pkg, g):
    s = sim_of(pkg, VDP)
    osc = hb_from(pkg, g["hb_vdp_dense"])
    out = {}
    for m in (1, 3):
        il = s.injection_lock("a", 1e-3, osc=osc, harmonic=m)
        out[f"m{m}"] = np.asarray([il.lock_range_hz, il.k_per_amp,
                                   il.p1.real, il.p1.imag, il.f0])
    return out


def _fixed_draws(arrays, params, generator, batch, mc_tols, sampler="mc"):
    """perturb_params_netlist's signature, returning given lanes."""
    out = {k: v.expand((batch,) + v.shape) for k, v in params.items()}
    for k, a in arrays.items():
        out[k] = torch.as_tensor(a, dtype=params[k].dtype)
    return out


MC_KW = dict(seed=1, n_harm=9, **HB_WARM)


def case_mc(pkg, g):
    """Simulator.monte_carlo_oscillator_phase_noise(4): JAX's draws (the
    port's lanes are fed JAX's, as in tests/test_torch_hb.py)."""
    s = sim_of(pkg, VDP_TOL)
    if pkg == "torch":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod(pkg, "parallel.montecarlo"),
                       "perturb_params_netlist", functools.partial(
                           _fixed_draws, {k: g["mc"][k] for k in MC_LEAVES}))
            bp, r = s.monte_carlo_oscillator_phase_noise(
                4, [1e4, 1e5], 5e6, "a", **MC_KW)
    else:
        bp, r = s.monte_carlo_oscillator_phase_noise(4, [1e4, 1e5], 5e6,
                                                     "a", **MC_KW)
    return {**{k: host(bp[k]) for k in MC_LEAVES},
            **{k: host(getattr(r, k)) for k in (
                "f0", "xs", "residual", "converged", "c", "c_flicker",
                "L_dbc", "period_jitter", "per_source")}}


def case_f32(pkg, g):
    """Two f32 lanes of the Monte-Carlo draws through the batched HB."""
    s = sim_of(pkg, VDP_TOL, f32=True)
    if pkg == "torch":
        bp = {k: v.expand((2,) + v.shape) for k, v in s.params.items()}
        for k in MC_LEAVES:
            bp[k] = torch.as_tensor(g["mc"][k][:2], dtype=torch.float32)
    else:
        import jax.numpy as jnp
        bp = {k: jnp.broadcast_to(v, (2,) + v.shape)
              for k, v in s.params.items()}
        for k in MC_LEAVES:
            bp[k] = jnp.asarray(g["mc"][k][:2], jnp.float32)
    r = mod(pkg, "analysis.hbosc").oscillator_hb_batched(
        s.engine, bp, 5e6, eq_of(s, "a"), n_harm=9, **HB_WARM)
    return {"f0": host(r.f0), "converged": host(r.converged)}


def case_sub(pkg, g):
    s = sim_of(pkg, VDP2)
    osc = s.oscillator_hb(5e6, "a", **HB_WARM)
    r = s.subharmonic_lock("a", amp=10e-3, m=2, osc=osc)
    return {"f0": np.asarray(r.f0), "f_lo": np.asarray(r.f_lo),
            "f_hi": np.asarray(r.f_hi),
            "lock_range_hz": np.asarray(r.lock_range_hz),
            "locked_center": host(r.locked_center)}


CASES = {"warm_delay": (case_warm_delay, ()),
         **{f"hb_{d}_{s}": (case_hb, (d, s)) for d in HB_DECKS
            for s in ("dense", "gmres") if not (d == "delay" and
                                                s == "gmres")},
         **{f"pn_hb_{d}": (case_pn_hb, (d,)) for d in HB_DECKS},
         "lock_hb": (case_lock_hb, ()),
         "mc": (case_mc, ()),
         "f32": (case_f32, ()),
         "sub": (case_sub, ())}

CLI = {"hb_osc_delay": (DELAY, ["--run-osc", "1e8:a:osc.csv"], ["osc.csv"]),
       "hb_osc_vdp": (VDP, ["--run-osc", "5e6:a:osc.csv", "--osc-method",
                            "hb", "--hb-solver", "gmres"], ["osc.csv"]),
       "hb_sublock": (VDP2, ["--run-subharmonic-lock", "5e6:a:a:10m:2"],
                      [])}
# the delay deck runs the solver's defaults (hb_kw None)
CLI_HB_KW = {"hb_osc_delay": None}


@pytest.fixture(scope="module")
def golden():
    return base.load_golden(GOLDEN)


@pytest.fixture(scope="module", autouse=True)
def shared_runs(golden):
    """The port's warm-ups and oscillator_hb solves computed once per
    distinct input (the dense and GMRES solves of a deck share a warm-up,
    the API and CLI cases their solves), and the delay deck's warm-up
    replayed from JAX's samples."""
    osc = mod("torch", "analysis.hbosc")
    ss = mod("torch", "analysis.sstate")
    real = ss.kicked_warmup
    w = golden["warm_delay"]

    def warmup(engine, params, f0_guess, anchor_eq, K, periods, kick,
               *a, **kw):
        if engine.n_tl and (f0_guess, K, periods, kick) == (1e8, 256, 30,
                                                            0.5):
            return float(w["dt"]), torch.as_tensor(w["xs"]), [], []
        return real(engine, params, f0_guess, anchor_eq, K, periods, kick,
                    *a, **kw)

    cache = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(osc, "kicked_warmup", warmup)
        base.memo(mp, osc, "kicked_warmup", cache)
        base.memo(mp, osc, "oscillator_hb", cache)
        yield


_runs = {}


def port(name, golden):
    if name not in _runs:
        fn, args = CASES[name]
        _runs[name] = fn("torch", golden, *args)
    return _runs[name]


@pytest.mark.parametrize("deck", list(HB_DECKS))
def test_oscillator_hb_dense_and_gmres_match_jax(deck, golden):
    for solver in ("dense", "gmres"):
        name = f"hb_{deck}_{solver}"
        if name not in CASES:
            continue
        got, ref = port(name, golden), golden[name]
        assert bool(got["converged"]) and bool(ref["converged"]), name
        assert int(got["iters"]) == int(ref["iters"]), name
        assert rel_err(got["f0"], ref["f0"]) <= 1e-9, name
        assert float(np.abs(got["xs"] - ref["xs"]).max()) <= 1e-8, name
        assert float(np.abs(got["spectrum"] - ref["spectrum"]).max()) \
            <= 1e-8, name
        assert rel_err(got["times"], ref["times"]) <= 1e-9, name


@pytest.mark.parametrize("deck", list(HB_DECKS))
def test_hb_phase_noise_matches_jax(deck, golden):
    got, ref = port(f"pn_hb_{deck}", golden), golden[f"pn_hb_{deck}"]
    for k in ("c", "period_jitter", "per_source"):
        assert rel_err(got[k], ref[k]) <= 1e-6, k
    assert rel_err(got["c_flicker"], ref["c_flicker"]) <= 1e-6
    assert float(np.abs(got["L_dbc"] - ref["L_dbc"]).max()) <= 1e-4
    assert rel_err(got["ppv"], ref["ppv"]) <= 1e-6
    assert abs(float(got["invariance"]) - float(ref["invariance"])) <= 1e-6
    assert rel_err(got["sv_gap"], ref["sv_gap"]) <= 1e-4


def test_hb_injection_lock_matches_jax(golden):
    got, ref = port("lock_hb", golden), golden["lock_hb"]
    for m in ("m1", "m3"):
        assert rel_err(got[m][:2], ref[m][:2]) <= 1e-6, m
        assert rel_err(got[m][2:4], ref[m][2:4]) <= 1e-6, m
    # method="auto" takes the HB oscillator on a T-line deck
    d = sim_of("torch", DELAY)
    il = d.injection_lock("a", 1e-3, f0_guess=1e8, anchor_node="a")
    assert isinstance(il.pn, mod("torch", "analysis.hbosc")
                      .HBOscPhaseNoiseResult)
    assert rel_err(il.f0, golden["hb_delay_dense"]["f0"]) <= 1e-9
    s = sim_of("torch", VDP)
    with pytest.raises(ValueError, match="exceeds the HB truncation"):
        s.injection_lock("a", 1e-3, osc=hb_from("torch",
                                                golden["hb_vdp_dense"]),
                         harmonic=10)


def test_monte_carlo_oscillator_matches_jax(golden):
    got, ref = port("mc", golden), golden["mc"]
    np.testing.assert_array_equal(got["converged"], ref["converged"])
    assert got["converged"].all()
    assert rel_err(got["f0"], ref["f0"]) <= 1e-8
    assert float(np.abs(got["xs"] - ref["xs"]).max()) <= 1e-8
    for k in ("c", "period_jitter", "per_source"):
        assert rel_err(got[k], ref[k]) <= 1e-6, k
    assert float(np.abs(got["L_dbc"] - ref["L_dbc"]).max()) <= 1e-4
    got, ref = port("f32", golden), golden["f32"]
    np.testing.assert_array_equal(got["converged"], ref["converged"])
    assert float(np.abs(got["f0"] / ref["f0"] - 1.0).max()) <= 1e-4
    s = sim_of("torch", VDP)
    with pytest.raises(ValueError, match="DEV=/LOT="):
        s.monte_carlo_oscillator_phase_noise(2, [1e4], 5e6, "a")
    with pytest.raises(KeyError, match="unknown node"):
        sim_of("torch", VDP_TOL).monte_carlo_oscillator_phase_noise(
            2, [1e4], 5e6, "nope")


def test_subharmonic_lock_matches_jax(golden):
    got, ref = port("sub", golden), golden["sub"]
    assert rel_err(got["f0"], ref["f0"]) <= 1e-9
    step = 1e-4 * float(ref["f0"]) / 2
    for k in ("f_lo", "f_hi"):
        assert abs(float(got[k]) - float(ref[k])) <= step, k
    assert float(np.abs(got["locked_center"] - ref["locked_center"]).max()) \
        <= 1e-8
    s = sim_of("torch", VDP2)
    osc = hb_from("torch", golden["hb_vdp_dense"])
    with pytest.raises(ValueError, match="m must be >= 2"):
        s.subharmonic_lock("a", amp=1e-3, m=1, osc=osc)
    with pytest.raises(ValueError, match="amplitude"):
        s.subharmonic_lock("a", amp=0.0, m=2, osc=osc)
    with pytest.raises(TypeError, match="HBOscResult"):
        s.subharmonic_lock("a", amp=1e-3, m=2,
                           osc=base.osc_from("torch",
                                             base.load_golden(base.GOLDEN)[
                                                 "shoot_vdp"]))


@pytest.mark.parametrize("name", list(CLI))
def test_cli_matches_jax_goldens(name, tmp_path):
    base.check_cli(name, tmp_path, CLI, "osc_cli", 1e-6,
                   CLI_HB_KW.get(name, HB_WARM))


def make_golden():
    base.make_golden(GOLDEN, CASES, {}, "osc_cli")
    import tempfile
    for name, (_, _, csvs) in CLI.items():
        with tempfile.TemporaryDirectory() as d:
            rc, stdout, stderr = base.run_cli("jax", name, d, CLI,
                                              CLI_HB_KW.get(name, HB_WARM))
            assert rc == 0, (name, stdout, stderr)
            with open(os.path.join(base.GOLDENS,
                                   f"osc_cli_{name}_stdout_jax.txt"),
                      "w") as f:
                f.write(stdout)
            for csv in csvs:
                with open(os.path.join(d, csv)) as src, open(os.path.join(
                        base.GOLDENS, f"osc_cli_{name}_{csv[:-4]}_jax.csv"),
                        "w") as dst:
                    dst.write(src.read())
        print("cli", name, flush=True)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, REPO)
    make_golden()
