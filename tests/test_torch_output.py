"""The port's output flags on the CPU: the ngspice rawfile (transient, AC
and DC-sweep plots appended in one file) against the JAX package's writer,
the run metadata (``--stats``) against JAX's keys, ``--probes-only`` on
tests/netlists/buffer.sp's .PLOTNV probes and on .PRINT AC probes,
``--connectivity`` against the JAX circuit's table, and ``--profile``."""

import json
import os
import types

import numpy as np
import pytest
import torch

from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.io import csvout as jcsv
from circuitsimulator_tpu.io import metadata as jmeta
from circuitsimulator_tpu.io import rawfile as jraw
from circuitsimulator_tpu_torch import Simulator
from circuitsimulator_tpu_torch.cli import main
from circuitsimulator_tpu_torch.io.metadata import transient_metadata

from test_torch_cli import _raw_plots

# one intra-op thread: the tensors are small, and under pytest-xdist
# several workers and JAX's own threads share the cores, where torch's
# spinning OpenMP workers slow everything on the machine many-fold
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the deck of tests/test_rawfile.py, with a .PRINT AC probe
RAW_DECK = """* rc lowpass
V1 in 0 DC 0 AC 1 PULSE(0 1 0 1n 1n 1 1)
R1 in out 1k
C1 out 0 1u
.TRAN 1e-4 2e-3
.AC lin 3 100 300
.DC V1 0 1 0.5
.print ac V(out) V(in,out)
.end
"""

# the deck of tests/test_probes_meta.py
PROBE_DECK = ("V1 1 0 SIN 0 1 1e6\nR1 1 2 1k\nC1 2 0 1n\nL1 2 3 1u\n"
              "R2 3 0 1k\n.TRAN 1e-8 2e-7\n.PLOTNV 2 0\n.plotnc L1\n"
              ".print tran V(1,2) I(V1)\n")


def test_rawfile_plots_match_jax_writer(tmp_path):
    """Transient, AC and DC-sweep plots appended to one file: the same
    bytes as the JAX package's writer on the same results (the values
    themselves are held to the JAX package's by the sweep, AC and CLI
    tests: tests/test_torch_cli.py's bjt_amp case compares a rawfile with
    the JAX CLI's)."""
    ts = Simulator.from_text(RAW_DECK, device="cpu")
    res, ac, sw = ts.transient(), ts.ac(), ts.dc_sweep()
    t = str(tmp_path / "t.raw")
    ts.write_raw(t, res)
    ts.write_raw(t, ac, mode="a")
    ts.write_raw(t, sw, mode="a")
    j = str(tmp_path / "j.raw")
    jraw.write_raw_transient(j, ts.topo, res.times.numpy(), res.xs.numpy())
    jraw.write_raw_ac(j, ts.topo, ac.freqs, ac.xs, mode="a")
    jraw.write_raw_dc_sweep(j, ts.topo, sw.values, sw.xs.numpy(), sw.source,
                            mode="a")
    assert open(t).read() == open(j).read()
    assert [h[2] for h, _ in _raw_plots(t)] == [
        "Plotname: Transient Analysis", "Plotname: AC Analysis",
        "Plotname: DC transfer characteristic"]
    with pytest.raises(TypeError):
        ts.write_raw(str(tmp_path / "x.raw"), object())


def _numpy_view(sim, result):
    """The port's simulator and result as the JAX metadata writer reads
    them (numpy arrays, a numpy dtype)."""
    opts = types.SimpleNamespace(**{
        k: getattr(sim.opts, k) for k in ("tran_solver", "tran_tol",
                                           "tran_alpha", "tran_gmin",
                                           "tran_max_newton_iters")},
        dtype=np.float64)
    return (types.SimpleNamespace(topo=sim.topo, config=sim.config,
                                  opts=opts),
            types.SimpleNamespace(n_steps=result.n_steps,
                                  newton_iters=result.newton_iters.numpy(),
                                  failed=result.failed.numpy()))


def test_metadata_matches_jax_keys_and_values(tmp_path):
    sim = Simulator.from_text(PROBE_DECK, device="cpu")
    res = sim.transient()
    meta = transient_metadata(sim, res, wall_s=1.5, extra={"netlist": "x"})
    want = jmeta.transient_metadata(*_numpy_view(sim, res), wall_s=1.5,
                                    extra={"netlist": "x"})
    assert meta.pop("engine") == "circuitsimulator_tpu_torch"
    assert want.pop("engine") == "circuitsimulator_tpu"
    assert meta == want
    assert meta["solver"]["dtype"] == "float64"
    assert meta["newton"]["total"] == int(res.newton_iters.sum())
    assert meta["timesteps_per_second"] == pytest.approx(res.n_steps / 1.5)
    from circuitsimulator_tpu_torch.io.metadata import write_metadata
    write_metadata(str(tmp_path / "m.json"), meta)
    assert json.loads((tmp_path / "m.json").read_text()) == meta


def test_probes_only_csv_matches_jax_writer(tmp_path):
    """The selection and the CSV bytes equal the JAX package's writer's on
    the same rows: V(2), ground, I(L1), V(1)-V(2), I(V1)."""
    from circuitsimulator_tpu_torch.io.csvout import probe_selection
    sim = Simulator.from_text(PROBE_DECK, device="cpu")
    res = sim.transient()
    sel = probe_selection(sim.topo, sim.config.print_commands)
    assert [lbl for lbl, _ in sel] == ["V(2)", "V(0)", "I(L1)", "V(1)-V(2)",
                                       "I(V1)"]
    sim.write_transient_csv(str(tmp_path / "t.csv"), res, probes_only=True)
    jcsv.write_transient_csv(str(tmp_path / "j.csv"), sim.topo,
                             res.times.numpy(), res.xs.numpy(),
                             selection=sel)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


def test_cli_probes_only_connectivity_stats_profile(tmp_path, monkeypatch,
                                                    capsys):
    """buffer.sp (its .TRAN cut to 20 steps in a staged copy) through the
    CLI with --probes-only, --connectivity, --stats, --profile and --raw:
    the CSV holds the deck's two .PLOTNV columns, equal to the rawfile's;
    the connectivity table is the JAX circuit's; the metadata and the
    trace are written."""
    text = open(os.path.join(REPO, "tests", "netlists", "buffer.sp")).read()
    text = text.replace(".TRAN 1e-9 300e-9", ".TRAN 1e-9 20e-9")
    (tmp_path / "buffer.sp").write_text(text)
    monkeypatch.chdir(tmp_path)
    assert main(["buffer.sp", "sel.csv", "--device", "cpu", "--probes-only",
                 "--connectivity", "--stats", "run.json", "--profile",
                 "prof", "--raw", "all.raw"]) == 0
    out = capsys.readouterr().out
    conn = JaxSimulator.from_text(text).circuit.connectivity_report()
    assert "\n\n" + conn + "\n\nRunning DC operating point..." in out
    assert "Run metadata written to 'run.json'." in out
    assert "Profiler trace written to 'prof'." in out
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    meta = json.loads((tmp_path / "run.json").read_text())
    assert meta["n_steps"] == 20 and meta["netlist"] == "buffer.sp"
    # the probe columns against the rawfile's every column (15 digits)
    assert open("sel.csv").readline().strip() == "time,V(101),V(118)"
    sel = np.loadtxt("sel.csv", delimiter=",", skiprows=1)
    (head, vals), = _raw_plots("all.raw")
    names = [h.split("\t")[2] for h in head[7:-1]]
    cols = [names.index(n) for n in ("time", "v(101)", "v(118)")]
    np.testing.assert_allclose(sel, vals.real[:, cols], rtol=1e-9,
                               atol=1e-15)


def test_cli_probes_only_ac_and_raw_append(tmp_path, monkeypatch, capsys):
    """--run-ac with --probes-only keeps the .PRINT AC probes (V(out) and
    the differential V(in,out)); --raw collects the transient, AC and DC
    sweep plots in order."""
    (tmp_path / "rc.sp").write_text(RAW_DECK)
    monkeypatch.chdir(tmp_path)
    assert main(["rc.sp", "t.csv", "--device", "cpu", "--probes-only",
                 "--run-ac", "ac.csv", "--run-dc-sweep", "dc.csv", "--raw",
                 "all.raw"]) == 0
    capsys.readouterr()
    assert open("ac.csv").readline().strip() == \
        "freq,VM(out),VP(out),VM(in)-V(out),VP(in)-V(out)"
    assert [h[2] for h, _ in _raw_plots("all.raw")] == [
        "Plotname: Transient Analysis", "Plotname: AC Analysis",
        "Plotname: DC transfer characteristic"]
