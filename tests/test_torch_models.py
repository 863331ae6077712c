"""Lowering, source waveforms and the Level-1 MOSFET of the PyTorch port
against the JAX package, on the same numpy inputs (f64, CPU)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.models import mosfet as jmos
from circuitsimulator_tpu.models import sources as jsrc
from circuitsimulator_tpu_torch import Simulator
from circuitsimulator_tpu_torch.models import mosfet as tmos
from circuitsimulator_tpu_torch.models import sources as tsrc

# one intra-op thread: the tensors are small, and under pytest-xdist
# several workers and JAX's own threads share the cores, where torch's
# spinning OpenMP workers slow everything on the machine many-fold
torch.set_num_threads(1)

DECKS = ["buffer", "dbmixer"]


@pytest.mark.parametrize("deck", DECKS)
def test_lowering_params_equal_jax_leaves(deck):
    path = f"tests/netlists/{deck}.sp"
    jp = JaxSimulator.from_file(path).params
    tp = Simulator.from_file(path, device="cpu").params
    assert sorted(jp) == sorted(tp)
    for k in jp:
        a, b = np.asarray(jp[k]), tp[k].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("deck", DECKS)
def test_lowering_topology_equal_jax(deck):
    path = f"tests/netlists/{deck}.sp"
    jt = JaxSimulator.from_file(path).topo
    tt = Simulator.from_file(path, device="cpu").topo
    for f in ("n_unknowns", "n_node_eq", "n_nodes", "n_elements",
              "has_nonlinear", "node_table", "branch_table",
              "volt_col_names", "branch_col_names"):
        assert getattr(jt, f) == getattr(tt, f), f
    for f in ("node_eqs", "res_e1", "res_e2", "cap_e1", "cap_e2", "ind_ep",
              "ind_em", "ind_k", "vs_ep", "vs_em", "vs_k", "is_ep", "is_em",
              "mos_ed", "mos_eg", "mos_es", "mos_eb", "volt_col_eqs",
              "branch_col_eqs"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), f)


def _source_pack(seed, nS=12, P=5):
    rng = np.random.default_rng(seed)
    kind = np.arange(nS, dtype=np.int32) % 6
    pulse = np.stack([rng.uniform(-1, 1, nS), rng.uniform(-1, 2, nS),
                      rng.uniform(0, 5e-9, nS), rng.uniform(0, 2e-9, nS),
                      rng.uniform(0, 2e-9, nS), rng.uniform(1e-9, 5e-9, nS),
                      np.where(np.arange(nS) % 4 < 2, 0.0,
                               rng.uniform(1e-8, 2e-8, nS))], 1)
    pulse[1, 3] = 0.0                          # zero rise time: x/0 path
    sin = np.stack([rng.uniform(-1, 1, nS), rng.uniform(0, 2, nS),
                    rng.uniform(1e6, 3e8, nS), rng.uniform(0, 5e-9, nS),
                    rng.uniform(-3, 3, nS)], 1)
    pwl_t = np.sort(rng.uniform(0, 4e-8, (nS, P)), axis=1)
    pwl_v = rng.uniform(-2, 2, (nS, P))
    pwl_n = rng.integers(0, P + 1, nS).astype(np.int32)
    dc = rng.uniform(-1, 1, nS)
    return dc, kind, pulse, sin, pwl_t, pwl_v, pwl_n


def test_sources_all_kinds_match_jax():
    dc, kind, pulse, sin, pwl_t, pwl_v, pwl_n = _source_pack(seed=5)
    ts = np.linspace(0.0, 5e-8, 41)
    jf = jax.jit(lambda t: (
        jsrc.eval_tran(dc, kind, pulse, sin, pwl_t, pwl_v, pwl_n, t),
        jsrc.eval_tran_static_kinds(kind, dc, pulse, sin, pwl_t, pwl_v,
                                    pwl_n, t),
        jsrc.eval_dc(dc, kind, sin, 0.3 + t * 1e7, pulse=pulse)))
    T = [torch.as_tensor(a) for a in (dc, kind, pulse, sin, pwl_t, pwl_v,
                                      pwl_n)]
    for t in ts:
        want = [np.asarray(w) for w in jf(jnp.asarray(t))]
        tt = torch.tensor(t, dtype=torch.float64)
        got = [tsrc.eval_tran(*T, tt),
               tsrc.eval_tran_static_kinds(kind, *T[:1], *T[2:], tt),
               tsrc.eval_dc(T[0], T[1], T[3], 0.3 + tt * 1e7, pulse=T[2])]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("variant", ["reference", "reverse", "body"])
def test_mos_linearize_matches_jax(variant):
    rng = np.random.default_rng(7)
    n = 400
    vth = rng.uniform(-0.8, 0.8, n)
    k = rng.uniform(1e-5, 2e-3, n)
    lam = rng.uniform(0.0, 0.1, n)
    p = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
    vd, vg, vs = (rng.uniform(-3, 3, n) for _ in range(3))
    kw = dict(off_gds=1e-12, reverse_region=variant == "reverse")
    if variant == "body":
        kw.update(gamma=rng.uniform(0.0, 0.6, n), phi=rng.uniform(0.5, 0.9, n))
    args = (vth, k, lam, p, vd, vg, vs)
    want = jax.jit(lambda *a: jmos.mos_stamp_vals(*a, **kw))(*args)
    tkw = {k2: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k2, v in kw.items()}
    got = tmos.mos_stamp_vals(*(torch.as_tensor(a) for a in args), **tkw)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-14,
                                   atol=1e-14 * np.abs(w).max())
