"""The port's example scripts (dsp_stuff_tpu_torch/examples/) run end to
end on the CPU at small sizes, each in a subprocess, as
tests/test_examples.py runs the JAX package's: exit 0 and output printed.
On the card chip_smoke.py runs them at their default sizes."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "streaming": ["--seconds", "0.25"],
    "render_batch": ["--streams", "4", "--seconds", "0.1", "--shards", "2"],
    "fit_amp": ["--steps", "20", "--samples", "1024"],
}


@pytest.mark.parametrize("name", list(CASES))
def test_example_script(name):
    r = subprocess.run(
        [sys.executable, "-m", f"dsp_stuff_tpu_torch.examples.{name}",
         "--device", "cpu", *CASES[name]],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip(), "the example printed nothing"
    assert "cpu" in r.stdout


def test_examples_default_to_the_card():
    """Run without --device an example takes the card: without a CUDA
    device it raises the compiler's message naming device="cpu"."""
    import torch
    r = subprocess.run(
        [sys.executable, "-m", "dsp_stuff_tpu_torch.examples.streaming",
         "--seconds", "0.01"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"})
    if torch.cuda.is_available():
        assert r.returncode == 0 and "cuda" in r.stdout, r.stderr[-2000:]
    else:
        assert r.returncode != 0
        assert 'device="cpu"' in r.stderr
