"""The port's CLI (``python -m circuitsimulator_tpu_torch``) on the CPU:
stdout byte-identical to the reference goldens, the CSV within 1e-9 V; the
.DC sweep, .STEP and mutual-inductance decks and buffer.sp's ``--method
trap`` and ``--adaptive`` runs against the JAX CLI's."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from circuitsimulator_tpu_torch.cli import main

# one intra-op thread: the tensors are small, and under pytest-xdist
# several workers and JAX's own threads share the cores, where torch's
# spinning OpenMP workers slow everything on the machine many-fold
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")


def read_golden(name):
    with open(os.path.join(GOLDENS, name)) as f:
        return f.read()


def stage_deck(tmp_path, deck):
    """The goldens name the deck as tests/netlists/<deck>.sp and the CSV as
    <deck>_tran.csv, relative to the working directory."""
    d = tmp_path / "tests" / "netlists"
    d.mkdir(parents=True)
    shutil.copy(os.path.join(REPO, "tests", "netlists", f"{deck}.sp"), d)
    return f"tests/netlists/{deck}.sp"


def test_buffer_cli_stdout_and_csv_match_goldens(tmp_path, monkeypatch,
                                                 capsys):
    deck = stage_deck(tmp_path, "buffer")
    monkeypatch.chdir(tmp_path)
    assert main([deck, "buffer_tran.csv", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == read_golden("buffer_stdout.txt")
    with open(tmp_path / "buffer_tran.csv") as f:
        header = f.readline()
    assert header == read_golden("buffer_tran.csv").splitlines(True)[0]
    got = np.loadtxt(tmp_path / "buffer_tran.csv", delimiter=",", skiprows=1)
    ref = np.loadtxt(os.path.join(GOLDENS, "buffer_tran.csv"),
                     delimiter=",", skiprows=1)
    assert got.shape == ref.shape == (301, 14)
    err = np.abs(got - ref).max()
    assert err <= 1e-9, err


def test_dbmixer_cli_dc_table_matches_golden(tmp_path, monkeypatch, capsys):
    # the DC part of the reference stdout, then the JAX CLI's line for a
    # skipped transient; the full 50,000-step transient is left to the GPU
    # (and to a manual CPU run, about ten minutes)
    deck = stage_deck(tmp_path, "dbmixer")
    monkeypatch.chdir(tmp_path)
    assert main([deck, "--device", "cpu", "--no-tran"]) == 0
    ref = read_golden("dbmixer_stdout.txt")
    cut = ref.index("DC analysis finished.\n") + len("DC analysis finished.\n")
    assert capsys.readouterr().out == (
        ref[:cut] + "\nNo .TRAN card; transient analysis skipped.\n")


# (deck, arguments, stdout golden, [(CSV written, its JAX-made golden)]):
# the JAX CLI's runs of the .DC sweep, .STEP and mutual-inductance decks,
# made from a directory holding examples/ (CHANGES.md has the commands)
SWEEP_STEP_K = {
    "mos_family": (["--run-dc-sweep", "mos_family_dcsweep.csv"],
                   "mos_family_dcsweep_stdout_jax.txt",
                   [("mos_family_dcsweep.csv", "mos_family_dcsweep_jax.csv")]),
    "diode_temp": (["--run-dc-sweep", "diode_temp_dcsweep.csv",
                    "--run-step", "diode_temp_step.csv"],
                   "diode_temp_stdout_jax.txt",
                   [("diode_temp_dcsweep.csv", "diode_temp_dcsweep_jax.csv"),
                    ("diode_temp_step.csv", "diode_temp_step_jax.csv")]),
    "rc_step": (["--no-tran", "--run-step", "rc_step_step.csv"],
                "rc_step_run_step_stdout_jax.txt",
                [("rc_step_step.csv", "rc_step_step_jax.csv")]),
    "xfmr": (["xfmr_tran.csv", "--run-ac", "xfmr_ac.csv"],
             "xfmr_stdout_jax.txt",
             [("xfmr_tran.csv", "xfmr_tran_jax.csv"),
              ("xfmr_ac.csv", "xfmr_ac_jax.csv")]),
}


@pytest.mark.parametrize("deck", list(SWEEP_STEP_K))
def test_sweep_step_and_mutual_cli_match_jax_goldens(deck, tmp_path,
                                                     monkeypatch, capsys):
    """--run-dc-sweep (with its .MEASURE DC report), --run-step and
    xfmr.sp's transient and --run-ac: stdout byte-identical to the JAX
    CLI's, every CSV's header equal and its values within 1e-9."""
    args, stdout, csvs = SWEEP_STEP_K[deck]
    (tmp_path / "examples").mkdir()
    shutil.copy(os.path.join(REPO, "examples", f"{deck}.sp"),
                tmp_path / "examples")
    monkeypatch.chdir(tmp_path)
    assert main([f"examples/{deck}.sp", *args, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == read_golden(stdout)
    for got_name, gold in csvs:
        with open(tmp_path / got_name) as f:
            assert f.readline() == read_golden(gold).splitlines(True)[0]
        got = np.loadtxt(tmp_path / got_name, delimiter=",", skiprows=1,
                         ndmin=2)
        ref = np.loadtxt(os.path.join(GOLDENS, gold), delimiter=",",
                         skiprows=1, ndmin=2)
        assert got.shape == ref.shape
        err = np.abs(got - ref).max()
        assert err <= 1e-9, (gold, err)


@pytest.mark.parametrize("flag", ["trap", "adaptive"])
def test_buffer_method_trap_and_adaptive_match_jax_goldens(
        flag, tmp_path, monkeypatch, capsys):
    """buffer.sp with ``--method trap`` and with ``--adaptive``: stdout
    byte-identical to the JAX CLI's (its "(Backward Euler)" banner
    included), the CSV within 1e-9 V of the JAX CLI's (made with the JAX
    CLI from a directory holding tests/netlists/buffer.sp: `--engine jax
    --method trap` and `--engine jax --adaptive`)."""
    deck = stage_deck(tmp_path, "buffer")
    monkeypatch.chdir(tmp_path)
    args = ["--method", "trap"] if flag == "trap" else ["--adaptive"]
    csv = f"buffer_{flag}_tran.csv"
    assert main([deck, csv, *args, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == read_golden(
        f"buffer_{flag}_stdout_jax.txt")
    gold = f"buffer_{flag}_tran_jax.csv"
    with open(tmp_path / csv) as f:
        assert f.readline() == read_golden(gold).splitlines(True)[0]
    got = np.loadtxt(tmp_path / csv, delimiter=",", skiprows=1)
    ref = np.loadtxt(os.path.join(GOLDENS, gold), delimiter=",", skiprows=1)
    assert got.shape == ref.shape == (301, 14)
    err = np.abs(got - ref).max()
    assert err <= 1e-9, err


def test_module_entry_point_runs():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-m", "circuitsimulator_tpu_torch",
                        "--help"], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "--device" in r.stdout, r.stderr


def test_cli_refuses_cuda_without_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert main([os.path.join(REPO, "tests", "netlists", "buffer.sp"),
                 "--device", "cuda"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def _peak_rel_err(got, ref):
    """Largest |got - ref| over each column's peak |ref| (a column of zeros
    is held absolutely)."""
    peak = np.abs(ref).max(axis=0)
    peak = np.where(peak > 0, peak, 1.0)
    return float((np.abs(got - ref) / peak).max())


def _numeric_lines(path):
    """(text lines that hold no number, the numeric rows as an array): a
    Touchstone file's comment and option lines, then its data."""
    text, rows = [], []
    with open(path) as f:
        for line in f:
            try:
                rows.append([float(v) for v in line.split()])
            except ValueError:
                text.append(line)
    return text, np.asarray(rows)


def _raw_plots(path):
    """[(header lines, (points, variables) complex values)] of an ASCII
    rawfile (``io/rawfile.py``'s layout)."""
    with open(path) as f:
        lines = f.read().splitlines()
    plots, i = [], 0
    while i < len(lines):
        nvars = int(lines[i + 4].split(": ", 1)[1])
        npts = int(lines[i + 5].split(": ", 1)[1])
        head = lines[i:i + 8 + nvars]
        i += 8 + nvars
        vals = []
        for _ in range(npts * nvars):
            v = lines[i].split("\t")[-1].split(",")
            vals.append(complex(float(v[0]), float(v[1]) if len(v) > 1
                                else 0.0))
            i += 1
        plots.append((head, np.asarray(vals).reshape(npts, nvars)))
    return plots


# (deck, arguments, stdout golden, [(file written, its JAX-made golden,
# relative bar over each column's peak)]): the JAX CLI's small-signal runs
# from a directory holding examples/ (CHANGES.md has the commands)
SMALL_SIGNAL = {
    "bjt_amp": (["bjt_amp_tran.csv", "--no-tran", "--run-ac",
                 "bjt_amp_ac.csv",
                 "--run-noise", "bjt_amp_noise.csv", "--run-noise-figure",
                 "Rs", "--run-group-delay", "c", "--raw", "bjt_amp.raw"],
                "bjt_amp_smallsig_stdout_jax.txt",
                [("bjt_amp_ac.csv", "bjt_amp_smallsig_ac_jax.csv", 1e-9),
                 ("bjt_amp_noise.csv", "bjt_amp_noise_jax.csv", 1e-9),
                 ("nf.csv", "bjt_amp_nf_jax.csv", 1e-9),
                 ("groupdelay.csv", "bjt_amp_groupdelay_jax.csv", 1e-8),
                 ("bjt_amp.raw", "bjt_amp_smallsig_jax.raw", 1e-9)]),
    "cs_amp": (["cs_amp_tran.csv", "--run-ac", "cs_amp_ac.csv",
                "--connectivity", "--run-sparams", "d@50", "--sparams-out",
                "cs_amp.s1p"],
               "cs_amp_smallsig_stdout_jax.txt",
               [("cs_amp_ac.csv", "cs_amp_ac_jax.csv", 1e-9),
                ("cs_amp.s1p", "cs_amp_jax.s1p", 1e-9)]),
    "feedback_loop": (["feedback_loop_tran.csv", "--run-loop-gain", "E1",
                       "--run-group-delay", "out"],
                      "feedback_loop_smallsig_stdout_jax.txt",
                      [("loopgain.csv", "feedback_loop_loopgain_jax.csv",
                        1e-9),
                       ("groupdelay.csv", "feedback_loop_groupdelay_jax.csv",
                        1e-8)]),
}


@pytest.mark.parametrize("deck", list(SMALL_SIGNAL))
def test_small_signal_cli_matches_jax_goldens(deck, tmp_path, monkeypatch,
                                              capsys):
    """The .TF/.SENS blocks, --run-noise, --run-noise-figure,
    --run-group-delay, --raw, --connectivity, --run-sparams and
    --run-loop-gain: stdout byte-identical to the JAX CLI's, every CSV's
    and the Touchstone file's text lines equal and their numbers within
    the bar of each column's peak (1e-8 for the group delay, a
    derivative), the rawfile's headers equal and its values within 1e-9
    of each variable's peak."""
    args, stdout, files = SMALL_SIGNAL[deck]
    (tmp_path / "examples").mkdir()
    shutil.copy(os.path.join(REPO, "examples", f"{deck}.sp"),
                tmp_path / "examples")
    monkeypatch.chdir(tmp_path)
    assert main([f"examples/{deck}.sp", *args, "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert out.out == read_golden(stdout) and out.err == ""
    for got_name, gold, bar in files:
        ref_path = os.path.join(GOLDENS, gold)
        if got_name.endswith(".raw"):
            got, ref = _raw_plots(got_name), _raw_plots(ref_path)
            assert [h for h, _ in got] == [h for h, _ in ref]
            errs = [_peak_rel_err(g, r) for (_, g), (_, r) in zip(got, ref)]
        else:
            if got_name.endswith(".csv"):
                got_text = [open(got_name).readline()]
                ref_text = [open(ref_path).readline()]
                got = np.loadtxt(got_name, delimiter=",", skiprows=1,
                                 ndmin=2)
                ref = np.loadtxt(ref_path, delimiter=",", skiprows=1,
                                 ndmin=2)
            else:
                got_text, got = _numeric_lines(got_name)
                ref_text, ref = _numeric_lines(ref_path)
            assert got_text == ref_text and got.shape == ref.shape
            errs = [_peak_rel_err(got, ref)]
        assert max(errs) <= bar, (gold, errs)
