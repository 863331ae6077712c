"""The AC small-signal path of the PyTorch port on the CPU: the plain version
of K3 against the JAX Pallas kernel (interpret mode) and complex128 numpy,
``ac_analysis`` and ``ac_analysis_batched`` against the JAX package (f64,
rtol 1e-9, atol 1e-12), the CSV writer, the CLI ``--run-ac`` and the
committed JAX goldens that ``chip_smoke.py`` reads."""

import dataclasses
import functools
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.analysis.ac import make_ac_batched_fn
from circuitsimulator_tpu.analysis.ac import write_ac_csv as jax_write_ac_csv
from circuitsimulator_tpu.ops.pallas_ac import ac_sweep_pallas
from circuitsimulator_tpu_torch import Simulator
from circuitsimulator_tpu_torch.analysis.ac import (ACResult,
                                                    ac_analysis_batched,
                                                    write_ac_csv)
from circuitsimulator_tpu_torch.cli import main as port_cli_main
from circuitsimulator_tpu_torch.convert import params_from_numpy
from circuitsimulator_tpu_torch.ops import ac_sweep, cuda_ac
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc

# one intra-op thread: the tensors are small, and under pytest-xdist
# several workers and JAX's own threads share the cores, where torch's
# spinning OpenMP workers slow everything on the machine many-fold
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
GOLDENS = os.path.join(REPO, "tests", "goldens")
RTOL, ATOL = 1e-9, 1e-12
SIGMAS = {"res_r": 0.01, "mos_vth": 0.02, "cap_c": 0.02}

# every linear controlled source with a reactive load, an AC phase on the
# input and an AC current source
CTRL_DECK = """* E/G/F/H small-signal deck
Vin in 0 DC 0.5 AC 1 30
Iac 0 a AC 1m -45
R1 in a 1k
C1 a 0 10n
E1 b 0 a 0 4
R2 b c 2k
G1 0 c a 0 1m
C2 c 0 2n
Vs c d DC 0
R3 d 0 500
F1 0 e Vs 3
R4 e 0 1k
H1 f 0 Vs 250
L1 f g 1m
R5 g 0 100
.AC dec 10 10 10meg
.end
"""

RC_DECK = """* RC lowpass
V1 in 0 DC 0 AC 1
R1 in out 1k
C1 out 0 1u
.AC dec 5 1 1meg
.end
"""

DECKS = {"cs_amp": os.path.join(EXAMPLES, "cs_amp.sp"),
         "feedback_loop": os.path.join(EXAMPLES, "feedback_loop.sp"),
         "opamp_filter": os.path.join(EXAMPLES, "opamp_filter.sp"),
         "sdomain_filter": os.path.join(EXAMPLES, "sdomain_filter.sp"),
         "rc": RC_DECK}


def port_sim(deck):
    src = CTRL_DECK if deck == "ctrl" else DECKS[deck]
    if src.endswith(".sp"):
        return Simulator.from_file(src, device="cpu")
    return Simulator.from_text(src, device="cpu")


@functools.lru_cache(maxsize=None)
def jax_ac(deck):
    """(JAX simulator, its f64 ACResult over the deck's .AC card).  A
    linear deck's AC system does not depend on the operating point, so its
    DC solve is skipped (x_op = 0 gives the same result bit for bit)."""
    src = DECKS[deck]
    js = (JaxSimulator.from_file(src) if src.endswith(".sp")
          else JaxSimulator.from_text(src))
    x_op = None if js.topo.has_nonlinear else jnp.zeros(js.engine.N)
    return js, js.ac(x_op=x_op)


def csv_phasors(path):
    """(freqs, phasors (F, probes)) rebuilt from a VM/VP CSV."""
    a = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    return a[:, 0], a[:, 1::2] * np.exp(1j * np.radians(a[:, 2::2]))


def assert_csv_close(path, ref_path, rtol=RTOL):
    """Phasors within rtol of the reference, relative to each probe's
    largest magnitude over the sweep."""
    with open(path) as f, open(ref_path) as g:
        assert f.readline() == g.readline()
    f1, x1 = csv_phasors(path)
    f2, x2 = csv_phasors(ref_path)
    np.testing.assert_array_equal(f1, f2)
    scale = np.maximum(np.abs(x2).max(axis=0), 1e-300)
    assert (np.abs(x1 - x2) / scale).max() <= rtol


# ---------------------------------------------------------------- K3
def lane_systems(B, n, seed):
    """Diagonally dominant lanes (tests/test_pallas_ac.py); lane 1 is
    exactly singular, lane 2 holds a NaN."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n)) + n * np.eye(n)
    B1 = rng.standard_normal((B, n, n))
    br = rng.standard_normal((B, n))
    bi = rng.standard_normal((B, n))
    G[1] = 0.0
    B1[1] = 0.0
    G[2, n // 2, 1] = np.nan
    return G, B1, br, bi


def zero_lanes(x):
    return np.all(x.reshape(x.shape[0], -1) == 0.0, axis=1)


@pytest.mark.parametrize("n", [5, 13])
def test_plain_matches_pallas_interpret_and_numpy(n):
    B, F = 6, 2
    G, B1, br, bi = lane_systems(B, n, seed=n)
    om = np.logspace(-1, 2, F)
    pr, pi = ac_sweep_pallas(*(jnp.asarray(a) for a in (G, B1, br, bi, om)),
                             interpret=True)
    want = np.asarray(pr) + 1j * np.asarray(pi)
    xr, xi = ac_sweep.ac_sweep_plain(
        *(torch.as_tensor(a) for a in (G, B1, br, bi, om)))
    got = xr.numpy() + 1j * xi.numpy()
    assert got.shape == (B, F, n)
    # the singular lane and the NaN lane come back all zeros in both
    np.testing.assert_array_equal(zero_lanes(got), zero_lanes(want))
    np.testing.assert_array_equal(zero_lanes(got),
                                  [False, True, True, False, False, False])
    good = ~zero_lanes(want)
    np.testing.assert_allclose(got[good], want[good], rtol=1e-9, atol=1e-11)
    A = G[good][:, None] + 1j * om[None, :, None, None] * B1[good][:, None]
    rhs = (br + 1j * bi)[good][:, None, :, None]
    exact = np.linalg.solve(A, np.broadcast_to(rhs, A.shape[:-1] + (1,)))
    np.testing.assert_allclose(got[good], exact[..., 0], rtol=1e-9,
                               atol=1e-11)


@pytest.fixture
def no_cuda_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA kernel was reached on the CPU")

    monkeypatch.setattr(cuda_ac, "ac_sweep_cuda", refuse)
    monkeypatch.setattr(cuda_ac, "_fn", refuse)


def test_dispatch_on_cpu_and_gate(no_cuda_kernel):
    G, B1, br, bi = (torch.as_tensor(a) for a in lane_systems(5, 4, seed=1))
    om = torch.tensor([1.0, 3.0])
    before = cuda_ac.LAUNCHES
    got = ac_sweep.ac_sweep(G, B1, br, bi, om, 1e-15)
    want = ac_sweep.ac_sweep_plain(G, B1, br, bi, om, 1e-15)
    assert cuda_ac.LAUNCHES == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    n = ac_sweep.N_MAX + 1
    big = torch.zeros((1, n, n), dtype=torch.float64)
    with pytest.raises(ValueError, match="outside"):
        ac_sweep.ac_sweep(big, big, big[:, 0], big[:, 0], om)
    with pytest.raises(TypeError):
        ac_sweep.ac_sweep(G.float(), B1, br, bi, om)
    with pytest.raises(ValueError, match="shapes"):
        ac_sweep.ac_sweep(G, B1, br[:, :2], bi, om)


# registers a thread of each K3 kernel by (itemsize, team capacity; 64 the
# wide route): the built library's counts on the H100 (chip_smoke.py's
# k3_timings), which the plan reads there; the CPU tests pass them in
PTXAS_REGS = {(4, 8): 64, (4, 16): 97, (4, 32): 90, (4, 64): 56,
              (8, 8): 122, (8, 16): 183, (8, 32): 163, (8, 64): 72}


def cuda_plan(N, itemsize, team=None):
    cap = team or min(c for c in cuda_ac.CAPACITIES if c >= N)
    return cuda_ac.plan(N, itemsize, team, PTXAS_REGS[(itemsize, cap)])


@pytest.mark.parametrize("itemsize", [4, 8])
def test_cuda_plan_fits_a_block(itemsize):
    # the launcher's plan for every N the kernel takes: the smallest team
    # capacity that holds N (33..64: the wide route) and its rows a thread,
    # blocks of whole warps within one H100 block, the shared memory of the
    # kernel's layout, and the systems per block of the residency rule
    for N in range(1, cuda_ac.MAX_N + 1):
        cap = min(c for c in (8, 16, 32, 64) if c >= N)
        p = cuda_plan(N, itemsize)
        assert p.cap == cap and p.rows == (2 if cap < 32 else 1)
        assert p.regs == PTXAS_REGS[(itemsize, cap)]
        assert p.threads % 32 == 0 and p.smem <= cuda_ac.SMEM_PER_BLOCK
        if p.cap == 64:
            assert p.team == 32
            assert 1 <= p.spb <= 4 and p.resident >= 1
            assert p.smem == p.spb * itemsize * (2 * N * (N | 1) + 2 * N)
            continue
        assert p.team == cap // p.rows and p.threads <= 256
        need = itemsize * 2 * N * (N | 1)
        assert need <= p.smem < need + 16 and p.smem % 16 == 0
        # a power of two; no larger one within a warp of the most resident
        # systems of any block size
        step = 32 // p.team
        assert p.spb in cuda_ac.SPB_SIZES and p.spb >= step
        others = [dataclasses.replace(p, spb=s)
                  for s in range(step, 256 // p.team + 1, step)]
        most = max(o.resident for o in others)
        assert most - step <= p.resident and p.resident >= 1
        assert not any(o.spb > p.spb and o.resident >= most - step
                       and o.spb in cuda_ac.SPB_SIZES for o in others)


def test_cuda_plan_overrides_and_refusals():
    for N in (1, 5, 8, 9, 17, 31, 32):
        for cap in (c for c in cuda_ac.CAPACITIES if c >= N):
            for itemsize in (4, 8):
                p = cuda_plan(N, itemsize, team=cap)
                assert (p.cap, p.rows) == (cap, cuda_ac.ROWS[cap])
        for cap in (c for c in cuda_ac.CAPACITIES if c < N):
            with pytest.raises(ValueError, match="does not hold"):
                cuda_ac.plan(N, 4, team=cap, regs=64)
    for bad in (0, cuda_ac.MAX_N + 1):
        with pytest.raises(ValueError, match="outside"):
            cuda_ac.plan(bad, 4, regs=64)
    with pytest.raises(ValueError):
        cuda_ac.plan(5, 4, team=12, regs=64)
    with pytest.raises(ValueError):
        cuda_ac.plan(5, 2, regs=64)
    # more registers a thread never raises the systems resident
    lean, fat = (cuda_ac.plan(31, 4, regs=r) for r in (40, 200))
    assert fat.resident < lean.resident


@pytest.mark.parametrize("N", [1, 5, 7, 10, 31, 40])
def test_cuda_launch_shape_covers_every_frequency(N):
    # each lane's frequencies in ceil(F / spb) blocks of whole warps whose
    # teams cover F with less than a warp's teams of slack a block
    for itemsize in (4, 8):
        for team in [None] + [c for c in cuda_ac.CAPACITIES if c >= N]:
            p = cuda_plan(N, itemsize, team)
            for F in (1, 3, 8, 64, 71, 201, 1000):
                teams, chunks = cuda_ac.launch_shape(p, F)
                if p.cap == 64:
                    assert (teams, chunks) == (p.spb, 0)
                    continue
                step = 32 // p.team
                assert 1 <= teams <= p.spb and (teams * p.team) % 32 == 0
                assert chunks == -(-F // p.spb)
                assert chunks * teams >= F > (chunks - 1) * teams
                assert chunks * teams - F < chunks * step


# ---------------------------------------------------------------- AC path
@pytest.mark.parametrize("deck", sorted(DECKS))
def test_ac_analysis_matches_jax(deck):
    _, jres = jax_ac(deck)
    tres = port_sim(deck).ac()
    np.testing.assert_array_equal(tres.freqs, np.asarray(jres.freqs))
    np.testing.assert_allclose(tres.xs, np.asarray(jres.xs), rtol=RTOL,
                               atol=ATOL)


def test_sdomain_filter_waits_for_behavioral_sources(tmp_path):
    # its LAPLACE expansion ends in a POLY(3) E source, which the frontend
    # lowers onto a behavioral (B) source: the port now runs it, and its
    # .AC sweep writes the JAX-made golden within 1e-9
    ts = Simulator.from_file(os.path.join(EXAMPLES, "sdomain_filter.sp"),
                             device="cpu")
    assert len(ts.lowered.b_sources) == 2
    path = tmp_path / "ac.csv"
    write_ac_csv(str(path), ts.topo, ts.ac())
    got = np.loadtxt(path, delimiter=",", skiprows=1)
    want = np.loadtxt(os.path.join(GOLDENS, "sdomain_filter_ac_jax.csv"),
                      delimiter=",", skiprows=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_ac_analysis_batched_matches_jax_on_dbmixer():
    """B = 4 lanes drawn with numpy, F = 5, linearized at the reference DC
    point (row 0 of the dbmixer golden) in both programs."""
    path = os.path.join(REPO, "tests", "netlists", "dbmixer.sp")
    js = JaxSimulator.from_file(path)
    rng = np.random.default_rng(1)
    jp = {k: np.broadcast_to(np.asarray(v), (4,) + np.shape(v)).copy()
          for k, v in js.params.items()}
    for key, sigma in SIGMAS.items():
        jp[key] = jp[key] * np.exp(sigma * rng.standard_normal(
            jp[key].shape))
    jp["vs_ac_mag"][:, 0] = 1.0
    jp = {k: jnp.asarray(v) for k, v in jp.items()}
    ts = Simulator.from_file(path, device="cpu")
    tp = params_from_numpy({k: np.array(v) for k, v in jp.items()})
    row0 = np.loadtxt(os.path.join(GOLDENS, "dbmixer_tran.csv"),
                      delimiter=",", skiprows=1, max_rows=1)
    x_op = np.zeros(ts.engine.N)
    x_op[np.concatenate([ts.topo.volt_col_eqs,
                         ts.topo.branch_col_eqs])] = row0[1:]
    x_ops = np.tile(x_op, (4, 1))
    freqs = np.logspace(6, 10, 5)
    res = ac_analysis_batched(ts.engine, tp, freqs,
                              x_ops=torch.as_tensor(x_ops))
    xr, xi = make_ac_batched_fn(js.engine, jnp.asarray(freqs))(
        jp, jnp.asarray(x_ops))
    want = np.asarray(xr) + 1j * np.asarray(xi)
    assert res.xs.shape == (4, 5, ts.engine.N)
    np.testing.assert_array_equal(res.freqs, freqs)
    np.testing.assert_allclose(res.xs, want, rtol=RTOL, atol=ATOL)
    assert np.abs(res.xs).max() > 0.5


# the 2-MOS stage under the charge model (tests/test_pallas_step.py), with
# the input as the AC source
CHARGE_DECK = """* charge-model CMOS stage
.OPTIONS MOSCAP=CHARGE
.MODEL 1 VT -0.75 MU 5e-2 COX 0.3e-4 LAMBDA 0.05 CJ0 4.0e-14
.MODEL 2 VT 0.83 MU 1.5e-1 COX 0.3e-4 LAMBDA 0.05 CJ0 4.0e-14
VDD 1 0 3
Vin 2 0 DC 1.4 AC 1
M1 3 2 1 p 30e-6 0.35e-6 1
M2 3 2 0 n 10e-6 0.35e-6 2
C1 3 0 0.5p
RL 3 0 10k
.op
"""


def test_ac_charge_trans_caps_match_jax():
    """MOSCAP=CHARGE: the trans-capacitances dq_t/dv_j at each lane's
    operating point enter B1 at the charge rows' entries.  Three lanes
    (res_r, mos_vth drawn with numpy) at the port's batched f64 DC points,
    8 frequencies up to 10 GHz: ac_analysis_batched against the JAX batched
    sweep within 1e-9 lane-relative; the fixed-cap result differs."""
    from circuitsimulator_tpu_torch.ops.assemble import Engine
    js = JaxSimulator.from_text(CHARGE_DECK)
    ts = Simulator.from_text(CHARGE_DECK, device="cpu")
    assert js.engine.mos_charge and ts.engine.mos_charge
    rng = np.random.default_rng(3)
    jp = {k: np.broadcast_to(np.asarray(v), (3,) + np.shape(v)).copy()
          for k, v in js.params.items()}
    for key in ("res_r", "mos_vth"):
        jp[key] = jp[key] * np.exp(0.02 * rng.standard_normal(jp[key].shape))
    tp = params_from_numpy(jp)
    x_ops = tmc.batched_dc_fast(ts.engine, tp)
    freqs = np.logspace(3, 10, 8)
    res = ac_analysis_batched(ts.engine, tp, freqs, x_ops=x_ops)
    jx = jnp.asarray(x_ops.numpy())
    xr, xi = make_ac_batched_fn(js.engine, jnp.asarray(freqs))(
        {k: jnp.asarray(v) for k, v in jp.items()}, jx)
    want = np.asarray(xr) + 1j * np.asarray(xi)
    scale = np.abs(want).reshape(3, -1).max(1)[:, None, None]
    assert (np.abs(res.xs - want) / scale).max() <= 1e-9
    fixed = Engine(ts.lowered, ts.opts.replace(mos_cap_model="fixed"), "cpu")
    other = ac_analysis_batched(fixed, tp, freqs, x_ops=x_ops).xs
    assert (np.abs(other - want) / scale).max() > 1e-3


def test_batched_lanes_equal_single_lane_runs():
    """ac_analysis_batched over lanes (its own batched DC) == ac_analysis
    of each lane alone: one route for one lane or many."""
    ts = port_sim("ctrl")
    bp = tmc.perturb_params(ts.params, torch.Generator().manual_seed(2), 3,
                            {"res_r": 0.05, "vcvs_gain": 0.05,
                             "cap_c": 0.05})
    freqs = np.logspace(2, 6, 7)
    res = ac_analysis_batched(ts.engine, bp, freqs)
    for b in range(3):
        one = ts.ac(params={k: v[b] for k, v in bp.items()}, freqs=freqs)
        np.testing.assert_allclose(res.xs[b], one.xs, rtol=1e-12, atol=0)


def test_reference_routes_agree():
    """ac_analysis (K3's plain version) against the complex system of
    ``ac_system`` and the real 2N route of ``_make_solve_sweep``."""
    from circuitsimulator_tpu_torch.analysis import ac
    ts = port_sim("ctrl")
    freqs = np.logspace(2, 7, 4)
    res = ts.ac(freqs=freqs)
    x_op = ts.dc()
    solve_one = ac._make_solve_sweep(ts.engine, ts.params, x_op)
    for f, want in zip(freqs, res.xs):
        Y, J = ac.ac_system(ts.engine, ts.params, x_op, 2.0 * np.pi * f)
        np.testing.assert_allclose(torch.linalg.solve(Y, J).numpy(), want,
                                   rtol=1e-10, atol=1e-14)
        xr, xi = solve_one(f)
        np.testing.assert_allclose(xr.numpy() + 1j * xi.numpy(), want,
                                   rtol=1e-10, atol=1e-14)


def test_ac_refuses_unported_stamps_by_name(monkeypatch):
    from circuitsimulator_tpu_torch.ops import assemble
    monkeypatch.setattr(assemble, "check_supported", lambda *a: None)
    ts = Simulator.from_text(RC_DECK + "L1 in x 1u\nL2 x 0 1u\n"
                             "K1 L1 L2 0.5\n", device="cpu")
    with pytest.raises(NotImplementedError, match="mutual inductance"):
        ts.ac()


# ---------------------------------------------------------------- output
@pytest.mark.parametrize("deck", ["cs_amp", "feedback_loop",
                                  "sdomain_filter"])
def test_goldens_are_current(deck, tmp_path):
    js, jres = jax_ac(deck)
    path = tmp_path / "ac.csv"
    jax_write_ac_csv(str(path), js.topo, jres)
    with open(os.path.join(GOLDENS, f"{deck}_ac_jax.csv")) as f:
        assert path.read_text() == f.read()


def test_write_ac_csv_matches_jax_writer(tmp_path):
    js, jres = jax_ac("feedback_loop")
    res = ACResult(freqs=np.asarray(jres.freqs), xs=np.asarray(jres.xs))
    eqs = js.topo.volt_col_eqs
    sel = [("V(a,b)", (int(eqs[1]), int(eqs[3]))), ("V(out)", int(eqs[2])),
           ("I(E1)", int(js.topo.branch_col_eqs[1]))]
    for selection in (None, sel):
        jax_write_ac_csv(str(tmp_path / "j.csv"), js.topo, jres,
                         selection=selection)
        write_ac_csv(str(tmp_path / "t.csv"), port_sim("feedback_loop").topo,
                     res, selection=selection)
        assert (tmp_path / "t.csv").read_text() == \
            (tmp_path / "j.csv").read_text()


def test_cli_run_ac_matches_jax_writer(tmp_path, monkeypatch, capsys):
    shutil.copy(os.path.join(EXAMPLES, "cs_amp.sp"), tmp_path)
    monkeypatch.chdir(tmp_path)
    assert port_cli_main(["cs_amp.sp", "--device", "cpu", "--no-tran",
                          "--run-ac", "ac.csv"]) == 0
    out = capsys.readouterr()
    assert "AC sweep finished (121 points). Results written to 'ac.csv'." \
        in out.out
    # the deck's .MEASURE AC card is printed after the sweep (it was named
    # on stderr as skipped before the measurement path was ported)
    assert "\n==== Measurements ====\n" in out.out
    assert "                f3db = " in out.out
    assert_csv_close(tmp_path / "ac.csv",
                     os.path.join(GOLDENS, "cs_amp_ac_jax.csv"))


def test_cli_stdout_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """No .TRAN card, --run-ac: the port's stdout is the JAX CLI's
    (tests/goldens/feedback_loop_run_ac_stdout_jax.txt, made by the JAX CLI
    with the same arguments), and the CSV agrees with the JAX-made golden
    that test_goldens_are_current holds to the JAX package."""
    shutil.copy(os.path.join(EXAMPLES, "feedback_loop.sp"), tmp_path)
    monkeypatch.chdir(tmp_path)
    argv = ["feedback_loop.sp", "--run-ac", "ac.csv"]
    assert port_cli_main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "\nNo .TRAN card; transient analysis skipped.\n" in got
    with open(os.path.join(GOLDENS,
                           "feedback_loop_run_ac_stdout_jax.txt")) as f:
        assert got == f.read()
    assert_csv_close(tmp_path / "ac.csv",
                     os.path.join(GOLDENS, "feedback_loop_ac_jax.csv"))
