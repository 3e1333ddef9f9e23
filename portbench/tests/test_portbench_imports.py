"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference loads nothing of the
program."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.harness import common

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "dsp_stuff_tpu_torch"


def sources(sub=""):
    top = os.path.join(HERE, sub)
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


def test_whole_names_are_compared():
    assert common.forbidden_modules({"dsp_stuff_tpu_torch": 1,
                                     "dsp_stuff_tpu_torch.ops": 1,
                                     "jaxtyping": 1, "flaxen": 1}) == []
    assert common.forbidden_modules({"dsp_stuff_tpu.ops": 1, "jax": 1,
                                     "jaxlib.xla": 1, "flax": 1}) == [
        "dsp_stuff_tpu.ops", "flax", "jax", "jaxlib.xla"]


@pytest.mark.parametrize("path", sorted(sources()))
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = [m for m in imported(path) if m in common.FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(sources("reference")))
def test_reference_imports_nothing_of_the_program(path):
    bad = [m for m in imported(path)
           if m in (PORT, "tests", "bench", "chip_smoke", "oracle")]
    assert not bad, f"{path} imports {bad}"


def test_a_run_loads_no_forbidden_module():
    code = ("import sys, time; sys.path.insert(0, %r); "
            "sys.path.insert(0, %r); "
            "from small_cells import run_small; "
            "from portbench.harness import common; "
            "r = run_small('feedback16.render.b512'); "
            "print(r['correct'], common.forbidden_modules())"
            % (os.path.dirname(HERE), os.path.join(HERE, "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True []"
