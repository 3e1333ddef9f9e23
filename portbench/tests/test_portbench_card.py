"""One short run of each cell on the card through the command line, as
the benchmark's driver runs it.  Needs a CUDA device:
``python -m pytest portbench/tests -q -m card`` on a machine with one."""

import json
import os
import subprocess
import sys

import pytest

from portbench.harness import common

CELLS = ["feedback16.render.b512", "chain10.render.b512",
         "feedback16.stream.b1", "chain10.fit.b512"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(common.HERE, "run.py"), "--workload",
         name, "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=common.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
