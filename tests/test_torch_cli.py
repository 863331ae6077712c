"""The port's CLI (``python -m circuitsimulator_tpu_torch``) on the CPU:
stdout byte-identical to the reference goldens, the CSV within 1e-9 V."""

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
