"""TRNOISE (transient source noise) in the PyTorch port on the CPU: the torch
threefry (``utils/prng.py``) against ``jax.random``; the Engine's draws,
flicker banks and stream against the JAX Engine's; f64 noisy transients
(single lane, batched with per-lane keys) and streaming measures against
JAX; K1c-iii (the fused chunk's noise block): its plain version against
the JAX Pallas kernel in interpret mode; the CLI against the JAX CLI's
goldens; the threefry golden ``tests/goldens/trnoise_stream_jax.csv``
(which ``chip_smoke.py`` holds the card's draws to) against JAX and the
port.  Each JAX computation is shared between the cases of its deck.

    JAX_PLATFORMS=cpu python tests/test_torch_trnoise.py

rewrites the threefry golden with the JAX package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.analysis.measure_stream import (
    StreamingMeasures as JaxStreamingMeasures)
from circuitsimulator_tpu.analysis.measure_stream import (
    run_transient_streaming as jax_streaming)
from circuitsimulator_tpu.analysis.transient import (
    run_transient as jax_run_transient)
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.cli import main
from circuitsimulator_tpu_torch.convert import (key_from_numpy,
                                                params_from_numpy)
from circuitsimulator_tpu_torch.ops import fused_step
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc
from circuitsimulator_tpu_torch.utils import prng
from test_torch_fused_step import damped, dc_points, draw_lanes, jax_runner

# one intra-op thread, as in every port test file (pytest-xdist shares
# the cores between workers)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
STREAM_GOLDEN = os.path.join(GOLDENS, "trnoise_stream_jax.csv")

# the decks of tests/test_trnoise_fused.py
WHITE_DECK = """* white noise, V and I sources, diode load
V1 in 0 DC 1 TRNOISE(5m 0)
I1 0 out 1m TRNOISE(2u 2.5e-7)
R1 in out 1k
R2 out 0 1k
C1 out 0 1n
D1 out 0
.TRAN 1e-7 4e-6
"""
FLICKER_DECK = """* white + flicker, sample-hold window
V1 in 0 DC 1 TRNOISE(2m 3e-7 1.0 1m)
R1 in out 1k
R2 out 0 1k
C1 out 0 1n
.TRAN 1e-7 3e-6
.MEASURE TRAN vavg AVG V(out) FROM=0 TO=3e-6
"""
DT = 1e-7


def ulps32(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_prng_matches_jax_random():
    """Key data of seeds 0, 7, 123 and 2**33 + 5, fold_in, split and
    32/64-bit bits bit-equal to jax.random; normals in f64 within 1e-14
    and in f32 within 2 ulp (20,000 draws each); JAX key data through
    convert.key_from_numpy."""
    seeds = (0, 7, 123, 2 ** 33 + 5)
    data = (0, 1, 5, 2 ** 31 + 3)

    @jax.jit
    def ref():
        k = jax.random.key(7)
        return ([jax.random.key_data(jax.random.key(s)) for s in seeds],
                [jax.random.key_data(jax.random.fold_in(k, jnp.uint32(d)))
                 for d in data],
                jax.random.key_data(jax.random.split(k, 1000)),
                jax.random.bits(k, (7, 33), jnp.uint32),
                jax.random.bits(k, (7, 33), jnp.uint64),
                jax.random.normal(k, (20000,), jnp.float64),
                jax.random.normal(k, (20000,), jnp.float32))

    kd, folds, splits, b32, b64, n64, n32 = ref()
    tk = prng.key(7)
    for s, want in zip(seeds, kd):
        assert np.array_equal(prng.key(s).numpy(), np.asarray(want)), s
    for d, want in zip(data, folds):
        assert np.array_equal(prng.fold_in(tk, d).numpy(),
                              np.asarray(want).astype(np.int64)), d
    assert np.array_equal(prng.split(tk, 1000).numpy(),
                          np.asarray(splits).astype(np.int64))
    # JAX-made keys carried across: the port draws JAX's lanes from them
    lanes = key_from_numpy(np.asarray(splits)[:3])
    assert lanes.dtype == torch.int64
    assert torch.equal(prng.normal(lanes, (4,)),
                       prng.normal(prng.split(tk, 3), (4,)))
    assert np.array_equal(prng.bits(tk, (7, 33)).numpy(),
                          np.asarray(b32).astype(np.int64))
    assert np.array_equal(prng.bits(tk, (7, 33), 64).numpy(),
                          np.asarray(b64).view(np.int64))
    got = prng.normal(tk, (20000,), torch.float64).numpy()
    assert np.abs(got - np.asarray(n64)).max() <= 1e-14
    got = prng.normal(tk, (20000,), torch.float32).numpy()
    assert ulps32(got, n32).max() <= 2


@pytest.fixture(scope="module")
def engine_refs():
    """The JAX Engine's noise, each deck under one jit (steps as a scan and
    a vmap, not unrolled): trnoise_draw of steps 1..12 (key 7) on the white
    deck in f64 and f32 (the I source's hold indices) and on the flicker
    deck; on the flicker deck (white + flicker) also the state's tn_*
    through 12 steps, flicker_init and flicker_step of the V bank and
    trnoise_stream over 12 steps."""
    out = {}
    for name, deck, jd in (("white64", WHITE_DECK, jnp.float64),
                           ("flicker64", FLICKER_DECK, jnp.float64),
                           ("white32", WHITE_DECK, jnp.float32)):
        js = JaxSimulator.from_text(deck, opts=JAX_OPTIONS.replace(dtype=jd))
        je = js.engine

        @jax.jit
        def ref(p):
            key, dt = jax.random.key(7), jnp.asarray(DT, jd)
            draws = [jax.vmap(lambda s: je.trnoise_draw(p[tn], key, salt, s,
                                                        dt))(
                jnp.arange(1, 13)) for tn, salt in (("vs_tn", 0),
                                                    ("is_tn", 1))]
            if not je.vs_flicker:
                return None, draws, None, None
            x0 = jnp.zeros((je.N,), jd)
            st = je.init_state(x0, p, DT, noise_key=key)
            upd = je.make_update_state(dt)
            names = [k for k in ("tn_v", "tn_i", "tn_fv") if k in st]

            def body(c, _):
                c = upd(p, x0, c)
                return c, {k: c[k] for k in names}

            seq = jax.lax.scan(body, st, None, length=11)[1]
            seq = {k: jnp.concatenate([st[k][None], seq[k]]) for k in names}
            banks = None
            if je.vs_flicker:
                b0 = je.flicker_init(p["vs_tn"], key, 4, dt)
                banks = (b0, je.flicker_step(p["vs_tn"], key, 4, 2, dt, b0))
            return seq, draws, banks, je.trnoise_stream(p, key, 0, 12, DT)

        out[name] = (je, ref(js.params))
    return out


@pytest.mark.parametrize("name", ["white64", "flicker64", "white32"])
def test_engine_noise_matches_jax(engine_refs, name):
    """The static flags and noisy index sets equal JAX's; trnoise_draw of
    steps 1..12 within 1e-14 relative of JAX's in f64 and within 2 ulp in
    f32 (on the white deck steps 1..12 cross I1's hold windows of 2.5
    steps, step 5 on a boundary: the draws repeat where JAX's repeat, so
    the hold indices are equal); on the flicker deck the state's tn_v /
    tn_i and bank through 12 steps, flicker_init / flicker_step and
    trnoise_stream within 1e-14 relative, and the port's stream bit-equal
    to its own per-step carry, also stitched from chunks of 5 and 7."""
    je, (seq, draws, banks, stream) = engine_refs[name]
    deck = FLICKER_DECK if name.startswith("flicker") else WHITE_DECK
    td = torch.float32 if name.endswith("32") else torch.float64
    ts = Simulator.from_text(deck, device="cpu",
                             opts=DEFAULT_OPTIONS.replace(dtype=td))
    te, tp = ts.engine, ts.params
    for flag in ("has_trnoise", "vs_flicker", "is_flicker"):
        assert getattr(te, flag) == getattr(je, flag), flag
    assert list(te.vs_noisy) == list(je.vs_noisy)
    assert list(te.is_noisy) == list(je.is_noisy)
    key = prng.key(7)
    tdraws = [te.trnoise_draw(tp[tn], key, salt, torch.arange(1, 13), DT)
              for tn, salt in (("vs_tn", 0), ("is_tn", 1))]
    for a, b in zip(tdraws, draws):
        if td == torch.float32:
            assert ulps32(a.numpy(), b).max(initial=0) <= 2
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-14 * max(np.abs(
                                           np.asarray(b)).max(initial=0.0),
                                           1e-300))
    if seq is None:
        # I1's draws repeat where JAX's do: equal hold indices
        i_draws = np.asarray(draws[1])[:, 0]
        same = i_draws[1:] == i_draws[:-1]
        assert same.any() and not same.all()
        mine = tdraws[1][:, 0].numpy()
        assert np.array_equal(mine[1:] == mine[:-1], same)
        return
    x0 = torch.zeros((te.N,), dtype=td)
    st = te.init_state(x0, tp, DT, noise_key=key)
    upd = te.make_update_state(torch.tensor(DT, dtype=td))
    mine = [st]
    for _ in range(11):
        mine.append(upd(tp, x0, mine[-1]))
    got = {k: torch.stack([s[k] for s in mine]) for k in seq}
    tstream = te.trnoise_stream(tp, key, 0, 12, DT)
    pairs = [(got[k], seq[k]) for k in seq]
    pairs += list(zip(tstream[:2], stream[:2]))
    if banks is not None:
        b0 = te.flicker_init(tp["vs_tn"], key, 4, DT)
        pairs += [(b0, banks[0]),
                  (te.flicker_step(tp["vs_tn"], key, 4, 2, DT, b0), banks[1]),
                  (tstream[2], stream[2])]
    for a, b in pairs:
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-14 * max(
            np.abs(b).max(initial=0.0), 1e-300))
    # the stream is the per-step carry, bit for bit, across a chunk seam
    a = te.trnoise_stream(tp, key, 0, 5, DT)
    b = te.trnoise_stream(tp, key, 5, 7, DT, a[2], a[3])
    assert torch.equal(tstream[0], got["tn_v"])
    assert torch.equal(torch.cat([a[0], b[0]]), got["tn_v"])
    assert torch.equal(torch.cat([a[1], b[1]]), got["tn_i"])


# the white deck with a .MEASURE card, for the streaming measures
MEASURE_CARD = ".MEASURE TRAN vavg AVG V(out) FROM=0 TO=4e-6\n"


@pytest.fixture(scope="module")
def white_jax():
    """JAX's f64 noisy transients of the white deck, one vmapped jit over 5
    lanes: lane 0 the nominal deck with key(0) (``Simulator.transient``'s
    default noise_seed), lanes 1-4 resistors 1% with the per-lane keys
    split(key(5), 4), all from the port's batched DC points (equal to
    JAX's to rounding; a DC inside the jit would double its compile); and
    JAX's streaming accumulators of MEASURE_CARD over lanes 1-4 of those
    waveforms, as ``run_transient_streaming`` updates them step by step."""
    js = JaxSimulator.from_text(WHITE_DECK)
    jp = draw_lanes(js.params, 5, sigmas=(("res_r", 0.01),))
    jp["res_r"] = jp["res_r"].at[0].set(js.params["res_r"])
    tp = params_from_numpy({k: np.array(v) for k, v in jp.items()})
    ts = Simulator.from_text(WHITE_DECK, device="cpu")
    x0 = tmc.batched_dc_fast(ts.engine, tp)
    keys = jnp.concatenate([jax.random.key(0)[None],
                            jax.random.split(jax.random.key(5), 4)])
    xs = jax.jit(jax.vmap(lambda p, x, k: jax_run_transient(
        js.engine, p, DT, 4e-6, x0=x, noise_key=k).xs))(
        jp, jnp.asarray(x0.numpy()), keys)
    sm = JaxStreamingMeasures(JaxSimulator.from_text(
        WHITE_DECK + MEASURE_CARD).config.measures, js.topo, jnp.float64)

    def vavg(lane_xs):
        dt = jnp.asarray(DT, jnp.float64)
        ts = jnp.arange(1, lane_xs.shape[0], dtype=jnp.float64) * dt
        acc = jax.lax.scan(
            lambda a, xt: (sm.update(js.engine, a, xt[0], xt[1], dt), None),
            sm.init(js.engine, lane_xs[0]), (lane_xs[1:], ts))[0]
        return sm.finalize(acc)["vavg"]

    vavgs = np.asarray(jax.jit(jax.vmap(vavg))(xs[1:]))
    xs = np.moveaxis(np.asarray(xs), 0, 1)               # (n + 1, 5, N)
    lanes = {k: v[1:] for k, v in tp.items()}
    return x0[0], xs[:, 0], lanes, x0[1:], xs[:, 1:], vavgs


def test_single_lane_transient_matches_jax(white_jax):
    """Simulator.transient() on the white deck (noise_seed 0) within 1e-9
    V of JAX's run with key(0), and the JAX CLI golden's CSV within 1e-9 V
    of that run (the golden is current); noise_seed=None runs it
    noise-free."""
    x1, single = white_jax[:2]
    ts = Simulator.from_text(WHITE_DECK, device="cpu")
    res = ts.transient(x_op=x1)
    np.testing.assert_allclose(res.xs.numpy(), single, rtol=0, atol=1e-9)
    gold = np.loadtxt(os.path.join(GOLDENS, "trnoise_white_tran_jax.csv"),
                      delimiter=",", skiprows=1)
    np.testing.assert_allclose(gold[:, 1:], single, rtol=0, atol=1e-9)
    quiet = ts.transient(tstop=5e-7, x_op=x1, noise_seed=None).xs.numpy()
    assert np.abs(quiet[1:, 0] - 1.0).max() < 1e-9              # V(in) = 1
    assert np.abs(single[1:6, 0] - 1.0).max() > 1e-3


def test_batched_transient_matches_jax(white_jax):
    """batched_transient(noise_key=key(5)) in f64: lane b keyed by
    split(key(5), 4)[b] within 1e-9 V of JAX's vmapped run; the lanes'
    realisations differ; the fused path (K1's plain version with the
    noise block) on the same lanes within 1e-12 V of the non-fused one."""
    tp, x0, want = white_jax[2:5]
    ts = Simulator.from_text(WHITE_DECK, device="cpu")
    res = tmc.batched_transient(ts.engine, tp, DT, 4e-6, save_xs=True,
                                x0=x0, noise_key=prng.key(5))
    np.testing.assert_allclose(res.xs.numpy(), want, rtol=0, atol=1e-9)
    vin = res.xs[1:, :, 0].numpy()
    assert np.abs(vin[:, 0] - vin[:, 1]).max() > 1e-4
    fused = tmc.batched_transient(ts.engine, tp, DT, 4e-6, fused=True,
                                  x0=x0, noise_key=prng.key(5))
    np.testing.assert_allclose(fused.x_final.numpy(), res.x_final.numpy(),
                               rtol=0, atol=1e-12)


def test_k1c_iii_plain_matches_jax_pallas_kernel():
    """K1c-iii's plain version against the JAX kernel in interpret mode
    (noise_idx, noise=) on the white deck (V1 and I1 noisy, nN = 2),
    B = 128, 10 steps, f32 damped, from the port's f64 batched DC, the same
    random noise block (mV on V1, uA on I1): x within 5e-6 V, the bar of
    tests/test_pallas_step.py; the gate admits the deck."""
    B, steps = 128, 10
    js = JaxSimulator.from_text(WHITE_DECK,
                                opts=damped(JAX_OPTIONS, jnp.float32))
    je = js.engine
    jp = draw_lanes(js.params, B, sigmas=(("res_r", 0.02),))
    x0 = jnp.asarray(dc_points(WHITE_DECK, jp))
    idx = np.concatenate([je.vs_noisy, len(je.topo.vs_ep) + je.is_noisy])
    rng = np.random.default_rng(3)
    nz = (rng.standard_normal((steps, 2, B))
          * np.array([5e-3, 2e-6])[None, :, None]).astype(np.float32)
    runner = jax_runner(je, jp, DT, noise_idx=idx)
    st0 = jax.jit(jax.vmap(je.init_state))(x0)
    want = runner.run_chunk(x0, x0, st0["vc"], st0["il"],
                            jnp.zeros((B,), bool), 0, steps, interpret=True,
                            noise=jnp.asarray(nz))
    want = [np.asarray(a) for a in want]
    ts = Simulator.from_text(WHITE_DECK, device="cpu",
                             opts=damped(DEFAULT_OPTIONS, torch.float32))
    assert fused_step.supported(ts.engine, DT)
    tp = params_from_numpy({k: np.array(v) for k, v in jp.items()},
                           dtype=torch.float32)
    x = torch.as_tensor(np.array(x0))
    st = ts.engine.init_state(x, tp)
    tr = fused_step.FusedStepRunner(ts.engine, tp, DT, noise_idx=idx)
    assert tr.nN == 2 and tr.noise_col.tolist() == [0, 1]
    got = tr.run_chunk_plain(x, x, st["vc"], st["il"],
                             torch.zeros((B,), dtype=torch.bool), 0, steps,
                             noise=torch.as_tensor(nz))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=5e-6)
    np.testing.assert_array_equal(got[4].numpy(), want[4])
    quiet = tr.run_chunk_plain(x, x, st["vc"], st["il"],
                               torch.zeros((B,), dtype=torch.bool), 0, steps,
                               noise=torch.zeros_like(torch.as_tensor(nz)))
    assert (got[0] - quiet[0]).abs().max() > 1e-4
    with pytest.raises(ValueError, match="noise"):
        tr.run_chunk_plain(x, x, st["vc"], st["il"],
                           torch.zeros((B,), dtype=torch.bool), 0, steps)


def test_measures_match_jax(white_jax):
    """batched_transient_measures(noise_key=key(5)) on the white deck with
    MEASURE_CARD in f64, lanes 1-4 of the fixture: per-lane vavg within
    1e-9 relative of JAX's accumulators over JAX's noisy waveforms, on the
    non-fused loop and on the fused path (K1's plain version with its
    noise block)."""
    tp, x0, _, want = white_jax[2:]
    ts = Simulator.from_text(WHITE_DECK + MEASURE_CARD, device="cpu")
    for fused in (False, True):
        _, vals = tmc.batched_transient_measures(
            ts.engine, tp, DT, 4e-6, ts.config.measures, ts.topo,
            fused=fused, x0=x0, noise_key=prng.key(5))
        np.testing.assert_allclose(vals["vavg"].numpy(), want, rtol=1e-9,
                                   atol=0)


def test_fused_flicker_banks_cross_chunk_seams():
    """The flicker deck in f64, 8 lanes (resistors 1%): the fused path in
    chunks of 7 over 30 steps (the banks handed from chunk to chunk in the
    carry) equal to the non-fused loop within 1e-12 V, as
    tests/test_trnoise_fused.py holds JAX's fused path."""
    ts = Simulator.from_text(FLICKER_DECK, device="cpu")
    bp = tmc.perturb_params(ts.params, torch.Generator().manual_seed(0), 8,
                            {"res_r": 0.01})
    ref = tmc.batched_transient(ts.engine, bp, DT, 3e-6, fused=False,
                                noise_key=prng.key(5))
    carry, advance, meta = tmc.make_fused_transient_fn(
        ts.engine, bp, DT, chunk=7, noise_key=prng.key(5))
    assert meta["feed"] is not None and carry[-1] == (None, None)
    for s in range(0, 30, 7):
        carry = advance(carry, s, min(7, 30 - s))[0]
    assert carry[-1][0].shape == (8, 1, ts.engine.FLICKER_M)
    np.testing.assert_allclose(carry[0].numpy(), ref.x_final.numpy(),
                               rtol=0, atol=1e-12)


def test_cli_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """The white deck through the CLI (noise seed 0): stdout byte-identical
    to the JAX CLI's (tests/goldens/trnoise_white_stdout_jax.txt), the CSV
    within 1e-9 V of the JAX CLI's (tests/goldens/trnoise_white_tran_jax
    .csv)."""
    (tmp_path / "trnoise_white.sp").write_text(WHITE_DECK)
    monkeypatch.chdir(tmp_path)
    assert main(["trnoise_white.sp", "trnoise_white_tran.csv",
                 "--device", "cpu"]) == 0
    with open(os.path.join(GOLDENS, "trnoise_white_stdout_jax.txt")) as f:
        assert capsys.readouterr().out == f.read()
    with open(tmp_path / "trnoise_white_tran.csv") as f, open(
            os.path.join(GOLDENS, "trnoise_white_tran_jax.csv")) as g:
        assert f.readline() == g.readline()
    got = np.loadtxt(tmp_path / "trnoise_white_tran.csv", delimiter=",",
                     skiprows=1)
    want = np.loadtxt(os.path.join(GOLDENS, "trnoise_white_tran_jax.csv"),
                      delimiter=",", skiprows=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


# ---- the threefry golden: lanes 0-3 of split(key(123), 8192) on the flicker
# deck in f32, 64 steps: per lane and step the hold index j of V1's white
# draw, that draw's 32 bits and normal, the 16 bits and normals of the
# flicker bank's draw entering the step (step 1: the stationary draw), and
# JAX's stream value tn_v
STREAM_LANES, STREAM_STEPS = 4, 64
STREAM_COLS = (["lane", "step", "j", "white_bits", "white_z"]
               + [f"flicker_bits_{m}" for m in range(16)]
               + [f"flicker_z_{m}" for m in range(16)] + ["tn_v"])


def jax_stream_table():
    """The golden's rows, computed with the JAX package (f32)."""
    js = JaxSimulator.from_text(FLICKER_DECK,
                                opts=JAX_OPTIONS.replace(dtype=jnp.float32))
    je, f32 = js.engine, jnp.float32
    fold, kd = jax.random.fold_in, jax.random.key_data

    @jax.jit
    def table(p):
        keys = jax.random.split(jax.random.key(123), 8192)[:STREAM_LANES]
        steps = jnp.arange(1, STREAM_STEPS + 1)
        j = jnp.floor(steps.astype(f32) * jnp.asarray(DT, f32)
                      / jnp.maximum(p["vs_tn"][0, 1], 1e-30)).astype(
                          jnp.int32)

        def lane(k):
            wk = jax.vmap(lambda jj: fold(fold(fold(k, 0), 0), jj))(j)
            base = fold(k, 4)
            fk = jax.random.wrap_key_data(jnp.where(
                (steps == 1)[:, None], kd(base)[None],
                jax.vmap(lambda s: kd(fold(base, s)))(steps)))
            return (jax.vmap(lambda q: jax.random.bits(q, (), jnp.uint32))(wk),
                    jax.vmap(lambda q: jax.random.normal(q, (), f32))(wk),
                    jax.vmap(lambda q: jax.random.bits(
                        q, (1, 16), jnp.uint32))(fk)[:, 0],
                    jax.vmap(lambda q: jax.random.normal(
                        q, (1, 16), f32))(fk)[:, 0],
                    je.trnoise_stream(p, k, 0, STREAM_STEPS, DT)[0][:, 0])

        return j, jax.vmap(lane)(keys)

    j, (wb, wz, fb, fz, tnv) = (np.asarray(a) if not isinstance(a, tuple)
                                else tuple(np.asarray(b) for b in a)
                                for a in table(js.params))
    rows = []
    for lane in range(STREAM_LANES):
        for i in range(STREAM_STEPS):
            rows.append([lane, i + 1, int(j[i]), int(wb[lane, i]),
                         float(wz[lane, i])]
                        + [int(v) for v in fb[lane, i]]
                        + [float(v) for v in fz[lane, i]]
                        + [float(tnv[lane, i])])
    return rows


def write_stream_golden(path=STREAM_GOLDEN):
    with open(path, "w") as f:
        f.write(",".join(STREAM_COLS) + "\n")
        for r in jax_stream_table():
            f.write(",".join(f"{v:.9e}" if isinstance(v, float) else str(v)
                             for v in r) + "\n")


def read_stream_golden():
    a = np.loadtxt(STREAM_GOLDEN, delimiter=",", skiprows=1)
    return {c: a[:, i] for i, c in enumerate(STREAM_COLS)}


def port_stream_table(device="cpu"):
    """The golden's columns from the port (f32 engine on ``device``)."""
    ts = Simulator.from_text(
        FLICKER_DECK, device=device,
        opts=DEFAULT_OPTIONS.replace(dtype=torch.float32))
    keys = prng.split(prng.key(123, device), 8192)[:STREAM_LANES]
    steps = torch.arange(1, STREAM_STEPS + 1, device=device)
    nt = ts.params["vs_tn"][0, 1]
    j = torch.floor(steps.float() * torch.tensor(DT, device=device)
                    / torch.clamp_min(nt, 1e-30)).long()
    wk = prng.fold_in(prng.fold_in(prng.fold_in(keys, 0), 0)[:, None], j)
    base = prng.fold_in(keys, 4)
    fk = prng.fold_in(base[:, None], steps)
    fk[:, 0] = base
    bp = tmc.broadcast_params(ts.params, STREAM_LANES)
    tnv = ts.engine.trnoise_stream(bp, keys, 0, STREAM_STEPS, DT)[0]
    return {"j": j.expand(STREAM_LANES, -1),
            "white_bits": prng.bits(wk), "white_z": prng.normal(
                wk, (), torch.float32),
            "flicker_bits": prng.bits(fk, (1, 16))[:, :, 0],
            "flicker_z": prng.normal(fk, (1, 16), torch.float32)[:, :, 0],
            "tn_v": tnv[:, :, 0].T}


def test_stream_golden():
    """tests/goldens/trnoise_stream_jax.csv is what the JAX package computes
    today (bits and values exact), and the port's CPU draws hold to it as
    chip_smoke.py holds the card's: hold indices and bits equal, normals
    within 2 ulp, the stream within 1e-5 of its largest value (the flicker
    recursion's float32 rounding follows XLA's fusion in JAX)."""
    gold = read_stream_golden()
    now = np.asarray(jax_stream_table(), np.float64)
    for i, c in enumerate(STREAM_COLS):
        if c.startswith(("white_z", "flicker_z", "tn_v")):
            assert np.array_equal(now[:, i].astype(np.float32),
                                  gold[c].astype(np.float32)), c
        else:
            assert np.array_equal(now[:, i], gold[c]), c
    got = {k: v.cpu().numpy().reshape(-1) if v.dim() == 2
           else v.cpu().numpy().reshape(-1, 16)
           for k, v in port_stream_table().items()}
    assert np.array_equal(got["j"], gold["j"])
    assert np.array_equal(got["white_bits"], gold["white_bits"])
    fb = np.stack([gold[f"flicker_bits_{m}"] for m in range(16)], 1)
    fz = np.stack([gold[f"flicker_z_{m}"] for m in range(16)], 1)
    assert np.array_equal(got["flicker_bits"], fb)
    assert ulps32(got["white_z"], gold["white_z"]).max() <= 2
    assert ulps32(got["flicker_z"], fz).max() <= 2
    tnv = gold["tn_v"]
    assert np.abs(got["tn_v"] - tnv).max() <= 1e-5 * np.abs(tnv).max()


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_stream_golden()
    print(f"wrote {STREAM_GOLDEN}")
