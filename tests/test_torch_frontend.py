"""The PyTorch port's own copy of the netlist frontend: it loads nothing from
the JAX package, and it parses every deck of the repo into the same
circuit and analysis cards as the JAX frontend."""

import dataclasses
import glob
import math
import os
import subprocess
import sys

import pytest
import torch

from circuitsimulator_tpu.netlist import parser as jax_parser
from circuitsimulator_tpu.netlist.funcs import expand_funcs
from circuitsimulator_tpu.netlist.include import expand_includes
from circuitsimulator_tpu.netlist.laplace import expand_laplace
from circuitsimulator_tpu.netlist.urc import expand_urc
from circuitsimulator_tpu_torch.netlist import (parse_netlist_text,
                                                read_netlist)

# one intra-op thread, as in every port test file (pytest-xdist shares
# the cores between workers)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = sorted(glob.glob(os.path.join(REPO, "tests", "netlists", "*.sp"))
               + glob.glob(os.path.join(REPO, "examples", "*.sp")))


def test_port_loads_nothing_from_the_jax_package():
    jax_dir = os.path.join(REPO, "circuitsimulator_tpu") + os.sep
    deck = os.path.join(REPO, "tests", "netlists", "dbmixer.sp")
    code = ("import sys\n"
            "from circuitsimulator_tpu_torch import Simulator, cli\n"
            "from circuitsimulator_tpu_torch.analysis import (\n"
            "    fourier, measure, measure_stream)\n"
            "from circuitsimulator_tpu_torch.io import csvout\n"
            "from circuitsimulator_tpu_torch.parallel import montecarlo\n"
            f"sim = Simulator.from_file({deck!r}, device='cpu')\n"
            "assert sim.topo.n_unknowns == 31\n"
            "assert 'jax' not in sys.modules\n"
            "assert '_circuitsimulator_tpu_frontend' not in sys.modules\n"
            "bad = [m for m, mod in list(sys.modules.items())\n"
            "       if (getattr(mod, '__file__', None) or '')"
            f".startswith({jax_dir!r})]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def canon(obj):
    """Plain nested data of a parse result, class names kept, so two copies
    of the frontend's classes compare by content."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: canon(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: canon(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [canon(v) for v in obj]
    if isinstance(obj, float) and math.isnan(obj):
        return "nan"
    if hasattr(obj, "__dict__"):
        return (type(obj).__name__, canon(vars(obj)))
    return obj


@pytest.mark.parametrize("path", DECKS, ids=os.path.basename)
def test_parse_matches_jax_frontend(path):
    with open(path, errors="replace") as f:
        text = f.read()
    jtext = expand_laplace(expand_urc(expand_funcs(expand_includes(
        text, os.path.dirname(os.path.abspath(path))))))
    ttext = read_netlist(path)
    assert ttext == jtext
    jckt, jsim = jax_parser.parse_netlist_text(jtext)
    tckt, tsim = parse_netlist_text(ttext)
    assert len(tckt.elements) == len(jckt.elements) > 0
    assert canon(tckt) == canon(jckt)
    assert canon(tsim) == canon(jsim)
