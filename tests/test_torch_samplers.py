"""The port's sampling plans and z-space (``parallel/montecarlo.
normal_draws``, ``_z_layout``, ``perturb_params``, ``perturb_params_netlist``)
on the CPU.  JAX draws from keys and the port from a ``torch.Generator``,
so parity cases feed JAX's ``normal_draws`` Z into both packages (a
fixture patches the port's name for the case's duration): the z-space
layouts and the lot column are held bit for bit, the lognormal lanes to 2
ulp (XLA's exp and torch's differ in the last bit on some float64
arguments).  The port's own draws get exact structural tests: every LHS
column has one value per stratum, the antithetic half mirrors exactly, the
Sobol normals equal scipy's and JAX's bit for bit for one integer seed, and
LHS spreads a seeded mean less than "mc".  Then ``Simulator.monte_carlo``
under every plan and the CLI's ``--mc-sampler``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import ndtri
from scipy.stats import norm, qmc

from circuitsimulator_tpu.parallel import montecarlo as jmc
from circuitsimulator_tpu_torch import Simulator
from circuitsimulator_tpu_torch.cli import main
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULP2 = 4.5e-16           # two float64 ulp, relative

# float leaves of several shapes, an integer leaf and an empty leaf
PARAMS = {"res_r": np.array([1e3, 2e3, 3.3e3]),
          "cap_c": np.array([1e-6, 2.2e-9]),
          "mos_vth": np.array([[0.7, -0.6]]),
          "vs_kind": np.array([1, 2], np.int32),
          "dio_is": np.zeros((0,))}
SIGMAS = {"res_r": 0.05, "cap_c": 0.1, "mos_vth": 0.03, "vs_kind": 0.2,
          "dio_is": 0.1, "not_a_leaf": 0.5}


def torch_params():
    return {k: torch.as_tensor(v) for k, v in PARAMS.items()}


def jax_params():
    return {k: jnp.asarray(v) for k, v in PARAMS.items()}


class JaxDraws:
    """The port's ``normal_draws`` replaced by JAX's: each call takes the
    next key of ``keys`` and returns JAX's (batch, dims) draw as a
    tensor."""

    def __init__(self):
        self.keys = []

    def __call__(self, generator, batch, dims, sampler="mc"):
        z = jmc.normal_draws(self.keys.pop(0), batch, dims, sampler)
        return torch.tensor(np.asarray(z))


@pytest.fixture
def jax_draws(monkeypatch):
    draws = JaxDraws()
    monkeypatch.setattr(tmc, "normal_draws", draws)
    return draws


def test_z_layout_and_params_from_z():
    """Names, sizes and dims of the joint z-space; the column block of each
    leaf bit for bit; the lognormal lanes within 2 ulp; untouched leaves
    broadcast."""
    names, sizes, dims = tmc._z_layout(torch_params(), SIGMAS)
    assert (names, sizes, dims) == jmc._z_layout(jax_params(), SIGMAS)
    assert names == ["cap_c", "mos_vth", "res_r"] and dims == 7
    Z = np.random.default_rng(3).standard_normal((16, dims))
    cols = tmc._z_columns(torch_params(), names, sizes, torch.tensor(Z))
    off = 0
    for n, sz in zip(names, sizes):
        want = Z[:, off:off + sz].reshape((16,) + PARAMS[n].shape)
        assert np.array_equal(cols[n].numpy(), want)
        off += sz
    got = tmc._params_from_Z(torch_params(), SIGMAS, torch.tensor(Z))
    want = jmc._params_from_Z(jax_params(), SIGMAS, jnp.asarray(Z))
    assert set(got) == set(want)
    for k in PARAMS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=ULP2, atol=0,
                                   err_msg=k)
    assert torch.equal(got["vs_kind"][5], torch_params()["vs_kind"])


@pytest.mark.parametrize("sampler", ["sobol", "antithetic"])
def test_perturb_params_stratified_layout(jax_draws, sampler):
    """perturb_params under a stratified plan: JAX's joint draw in the
    _z_layout order (the draw itself fed in), lanes within 2 ulp."""
    key = jax.random.key(11)
    jax_draws.keys = [key]
    got = tmc.perturb_params(torch_params(), torch.Generator(), 32, SIGMAS,
                             sampler=sampler)
    want = jmc.perturb_params(jax_params(), key, 32, SIGMAS,
                              sampler=sampler)
    for k in PARAMS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=ULP2, atol=0, err_msg=k)


@pytest.mark.parametrize("sampler", ["sobol", "antithetic"])
def test_netlist_stratified_lot_column(jax_draws, sampler):
    """perturb_params_netlist's stratified branch: column 0 of the joint
    draw is the lot, shared by every LOT-toleranced element of a lane
    (bit for bit: dev * z + lot * z_lot with dev = 0 is lot * z_lot); the
    device columns follow in sorted-name order; lanes within 2 ulp."""
    params = {"res_r": torch.tensor([1e3, 1e3, 4.7e3], dtype=torch.float64),
              "cap_c": torch.tensor([1e-9], dtype=torch.float64)}
    tols = {"res_r": (np.array([0.0, 0.0, 0.05]), np.array([0.1, 0.1, 0.1])),
            "cap_c": (np.array([0.1]), np.array([0.0]))}
    key = jax.random.key(5)
    Z = np.asarray(jmc.normal_draws(key, 64, 5, sampler), np.float64)
    jax_draws.keys = [key]
    got = tmc.perturb_params_netlist(params, torch.Generator(), 64, tols,
                                     sampler=sampler)
    want = jmc.perturb_params_netlist(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()}, key, 64,
        {k: tuple(jnp.asarray(a) for a in v) for k, v in tols.items()},
        sampler=sampler)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=ULP2, atol=0, err_msg=k)
    r = got["res_r"]
    assert torch.equal(r[:, 0], r[:, 1])                  # the shared lot
    np.testing.assert_allclose(np.log(r[:, 0].numpy() / 1e3),
                               0.1 * Z[:, 0], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.log(got["cap_c"][:, 0].numpy() / 1e-9),
                               0.1 * Z[:, 1], rtol=1e-12, atol=1e-14)
    assert float(r[:, 0].std()) > 10.0


def test_lhs_stratification():
    """Every LHS column puts exactly one lane in each of the B
    equiprobable strata; float32, as JAX draws it."""
    B, D = 64, 5
    z = tmc.normal_draws(torch.Generator().manual_seed(0), B, D, "lhs")
    assert z.shape == (B, D) and z.dtype == torch.float32
    strata = np.floor(norm.cdf(z.numpy().astype(np.float64)) * B).astype(int)
    for d in range(D):
        assert sorted(strata[:, d]) == list(range(B)), d


@pytest.mark.parametrize("batch", [32, 33])
def test_antithetic_mirror(batch):
    z = tmc.normal_draws(torch.Generator().manual_seed(1), batch, 3,
                         "antithetic")
    half = (batch + 1) // 2
    assert z.shape == (batch, 3) and z.dtype == torch.float64
    assert torch.equal(z[half:], -z[:batch - half])


def test_sobol_bits_equal_scipy_and_jax():
    """One integer seed: the port's normals are scipy's scrambled Sobol
    points through the float64 inverse CDF, cast to float32, and JAX's
    normal_draws(key, "sobol") bit for bit (its seed from the key data);
    the port's generator draws the seed, so two generators of one seed
    give the same points."""
    key = jax.random.key(2)
    seed = int(np.asarray(jax.random.key_data(key)).ravel()[-1]) & 0x7FFFFFFF
    got = tmc.sobol_normals(seed, 256, 3)
    u = qmc.Sobol(d=3, scramble=True, seed=seed).random(256)
    assert np.array_equal(got, ndtri(np.clip(u, 1e-12, 1 - 1e-12))
                          .astype(np.float32))
    assert np.array_equal(got, np.asarray(
        jmc.normal_draws(key, 256, 3, "sobol")))
    a, b = (tmc.normal_draws(torch.Generator().manual_seed(9), 64, 2,
                             "sobol") for _ in range(2))
    assert a.dtype == torch.float32 and torch.equal(a, b)


def test_unknown_sampler_raises():
    with pytest.raises(ValueError, match="unknown sampler"):
        tmc.normal_draws(torch.Generator(), 8, 1, "qmc")


def test_lhs_variance_reduction():
    """The mean of exp(sigma z) at B = 64 over 24 seeds: LHS's squared
    error against the exact lognormal mean is under a fifth of "mc"'s."""
    B, sig, reps = 64, 0.3, 24
    exact = float(np.exp(sig * sig / 2))

    def sq_err(sampler):
        return np.mean([(float(torch.exp(sig * tmc.normal_draws(
            torch.Generator().manual_seed(100 + s), B, 1, sampler)).mean())
            - exact) ** 2 for s in range(reps)])

    assert sq_err("lhs") < 0.2 * sq_err("mc")


MC_DECK = """* mc divider
V1 in 0 DC 1
R1 in out 1k DEV=5%
R2 out 0 1k DEV=5% LOT=2%
.op
"""


@pytest.mark.parametrize("sampler", ["mc", "lhs", "sobol", "antithetic"])
def test_monte_carlo_every_sampler(sampler):
    sim = Simulator.from_text(MC_DECK, device="cpu")
    _, xs = sim.monte_carlo(64, seed=1, sampler=sampler)
    v = xs[:, sim._node_eq("out")].numpy()
    assert abs(v.mean() - 0.5) < 0.01
    assert 0.002 < v.std() < 0.06
    assert len(np.unique(np.round(v, 9))) > 40


def test_cli_mc_sampler_lhs(tmp_path, monkeypatch, capsys):
    """--mc-sampler lhs on examples/mc_filter.sp: the per-lane CSV (a
    header and one finite row per lane) and the statistics block of both
    measures."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "mc.csv"
    assert main([os.path.join(REPO, "examples", "mc_filter.sp"), "t.csv",
                 "--device", "cpu", "--no-tran", "--run-mc", "16",
                 "--run-mc-out", str(out), "--mc-sampler", "lhs"]) == 0
    rows = out.read_text().splitlines()
    assert rows[0] == "lane,settle,vfinal" and len(rows) == 17
    vals = np.array([[float(c) for c in r.split(",")] for r in rows[1:]])
    assert np.array_equal(vals[:, 0], np.arange(16))
    assert np.all(np.isfinite(vals))
    text = capsys.readouterr().out
    assert "Running Monte-Carlo (16 lanes, one batched solve)..." in text
    assert "==== Monte-Carlo measure statistics ====" in text
    for name in ("settle", "vfinal"):
        assert f"{name:>16s}: mean=" in text
