"""Checkpoint / resume of long transients in the PyTorch port on the CPU
(``parallel/checkpoint.py``): buffer.sp chunked against straight, an
interrupted run resumed bit for bit (as tests/test_parallel.py:101-131
holds the JAX package), the T-line ring and the TRNOISE state through a
file, and the file layout shared with the JAX package's save_carry /
load_carry in both directions."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.parallel import checkpoint as jck
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc
from circuitsimulator_tpu_torch.parallel.checkpoint import (
    ChunkedTransient, load_carry, save_carry)
from circuitsimulator_tpu_torch.utils import prng

# one intra-op thread, as in every port test file (pytest-xdist shares
# the cores between workers)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUFFER = os.path.join(REPO, "tests", "netlists", "buffer.sp")

# a T-line and a flicker TRNOISE source (white and 1/f): the ring and the
# noise state; STATE_DECK adds a MOS under MOSCAP=CHARGE (qm, qi), every
# kind of state entry in one carry
NOISY_TLINE_DECK = """* ring and noise state
V1 in 0 PULSE(0 1 1n 0.2n 0.2n 6n 0) TRNOISE(10m 0.3n 1 5m)
RS in a 50
T1 a 0 b 0 Z0=50 TD=0.5n
RL b 0 200
C1 b 0 1p
.TRAN 0.1n 1.2n
"""
STATE_DECK = NOISY_TLINE_DECK.replace(".TRAN", """\
.MODEL 2 VT 0.4 MU 1e-2 COX 1e-3 LAMBDA 0.05 CJ0 1e-13
M1 c b 0 n 10e-6 1e-6 2
RD vdd c 1k
VDD vdd 0 3
.OPTIONS MOSCAP=CHARGE
.TRAN""")


def assert_carry_equal(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert set(a[1]) == set(b[1])
    for k in a[1]:
        va, vb = a[1][k], b[1][k]
        assert (va == vb) if isinstance(va, int) else torch.equal(va, vb), k


def test_chunked_and_resumed_buffer(tmp_path):
    """buffer.sp, 60 steps: chunks of 17 against the straight run within
    1e-12 V with the same Newton iterations; stopped after a first chunk
    of 25, written, and resumed by a new object: bit for bit the
    uninterrupted run's carry."""
    sim = Simulator.from_file(BUFFER, device="cpu")
    tstep, tstop = 1e-9, 60e-9
    ck = str(tmp_path / "run.npz")
    r2 = ChunkedTransient(sim.engine, sim.params, tstep, tstop,
                          ckpt_path=ck, chunk_steps=25)
    carry0 = r2.initial_carry()          # one DC for the straight run too
    ref = sim.transient(tstep=tstep, tstop=tstop, save_xs=False,
                        x_op=carry0[0])
    carry1, iters1 = ChunkedTransient(sim.engine, sim.params, tstep, tstop,
                                      chunk_steps=17).run()
    np.testing.assert_allclose(carry1[0].numpy(), ref.x_final.numpy(),
                               rtol=0, atol=1e-12)
    assert iters1 == int(ref.newton_iters.sum())

    ts = torch.arange(1, 26, dtype=torch.float64) * tstep
    carry, _ = r2._run_chunk(carry0, ts)
    save_carry(ck, carry, 25)
    assert not os.path.exists(ck + ".tmp.npz")
    carry3, _ = ChunkedTransient(sim.engine, sim.params, tstep, tstop,
                                 ckpt_path=ck, chunk_steps=25).run()
    assert_carry_equal(carry3, carry1)


@pytest.mark.parametrize("lanes", [0, 3])
def test_state_deck_resume_bitwise(tmp_path, lanes):
    """The T-line ring and the noise keys, step counter, values and
    flicker banks through a checkpoint: a trapezoidal run stopped after 4
    of 12 steps and resumed from the file equals the uninterrupted one bit
    for bit, single lane and a batch of three (one noise key per lane)."""
    sim = Simulator.from_text(NOISY_TLINE_DECK, opts=DEFAULT_OPTIONS.replace(
        tran_method="trap"), device="cpu")
    eng = sim.engine
    params, key = sim.params, prng.key(5)
    if lanes:
        params = tmc.broadcast_params(params, lanes)
        key = tmc.lane_keys(eng, params, key)
    tstep, tstop = 1e-10, 1.2e-9
    full, _ = ChunkedTransient(eng, params, tstep, tstop, chunk_steps=12,
                               noise_key=key).run()
    assert {"tlw", "tn_key", "tn_kv", "tn_fv", "tn_step"} <= set(full[1])
    assert full[1]["tn_step"] == 13 and not bool(full[2].any())
    ck = str(tmp_path / "state.npz")
    ChunkedTransient(eng, params, tstep, 4e-10, ckpt_path=ck, chunk_steps=4,
                     noise_key=key).run()
    with np.load(ck) as z:
        assert int(z["step_done"]) == 4
        assert z["k_tn_key"].dtype == np.uint32
        assert z["s_tn_step"].dtype == np.int32
        assert not any(k in z.files for k in ("s_tn_kv", "k_tn_kv"))
    resumed, _ = ChunkedTransient(eng, params, tstep, tstop, ckpt_path=ck,
                                  chunk_steps=4, noise_key=key).run()
    assert_carry_equal(resumed, full)


def test_checkpoint_files_cross_packages(tmp_path):
    """A carry written by JAX's save_carry loads in the port with the keys
    the port's own state has and JAX's arrays; a carry written by the
    port loads in JAX's load_carry with the keys of JAX's state and the
    port's arrays."""
    tstep = 1e-10
    js = JaxSimulator.from_text(STATE_DECK, opts=JAX_OPTIONS.replace(
        dtype=jnp.float64, tran_method="trap"))
    ts = Simulator.from_text(STATE_DECK, opts=DEFAULT_OPTIONS.replace(
        tran_method="trap"), device="cpu")
    # any point will do for the layout: no DC
    x0 = torch.as_tensor(np.random.default_rng(3).uniform(
        0.0, 1.0, ts.engine.N))
    jx0 = jnp.asarray(x0.numpy())
    jstate = jax.jit(lambda x, p: js.engine.init_state(
        x, p, tstep, noise_key=jax.random.key(7)))(jx0, js.params)
    jcarry = (jx0, jstate, jnp.zeros((), bool))
    tcarry = (x0, ts.engine.init_state(x0, ts.params, tstep,
                                       noise_key=prng.key(7)),
              torch.zeros((), dtype=torch.bool))

    jfile = str(tmp_path / "jax.npz")
    jck.save_carry(jfile, jax.device_get(jcarry), 4)
    loaded, step = load_carry(jfile, ts.engine)
    assert step == 4 and set(loaded[1]) == set(tcarry[1])
    assert torch.equal(loaded[0], x0)
    assert loaded[1]["tn_step"] == 1
    for k, v in loaded[1].items():
        if k == "tn_step":
            continue
        if k.startswith("tn_k") or k.startswith("tn_b"):
            assert torch.equal(v, tcarry[1][k]), k    # threefry keys
        else:
            jv = jstate[k]
            want = (jax.random.key_data(jv) if k == "tn_key"
                    else np.asarray(jv))
            np.testing.assert_array_equal(v.numpy(), np.asarray(want),
                                          err_msg=k)
            np.testing.assert_allclose(v.numpy(), tcarry[1][k].numpy(),
                                       rtol=1e-12, atol=1e-15, err_msg=k)

    tfile = str(tmp_path / "port.npz")
    save_carry(tfile, tcarry, 4)
    (jx, jst, jfailed), jstep = jck.load_carry(tfile)
    assert jstep == 4 and set(jst) == set(jstate)
    np.testing.assert_array_equal(np.asarray(jx), x0.numpy())
    for k, v in jst.items():
        if k == "tn_key":
            np.testing.assert_array_equal(
                np.asarray(jax.random.key_data(v)),
                np.asarray(jax.random.key_data(jstate[k])))
        else:
            got = tcarry[1][k]
            np.testing.assert_array_equal(
                np.asarray(v), np.asarray(got, np.int32) if k == "tn_step"
                else got.numpy(), err_msg=k)
