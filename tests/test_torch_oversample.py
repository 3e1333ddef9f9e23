"""The port's polyphase oversampler (dsp_stuff_tpu_torch/ops/oversample.py)
against the JAX package's (dsp_stuff_tpu/ops/oversample.py), and the
oversampled shaper nodes of config3 as nodes.

Bounds (dBFS = 20 log10(max|err| / max|reference|)), each with the worst
the CPU measured:
  upsample / downsample vs JAX, R in {2, 4, 8}     <= -120 (-127.5): both
                                    are f32 matrix products, summed in
                                    another order
  oversampled(overdrive) with a modulated drive     <= -120 (-136.1)
  an oversampled shaper node vs JAX                 <= -120 (fast -127.1,
                                                    parity -129.6)
  oversampled distort in a feedback cycle vs JAX    <= -120 (fast -132.8,
                                                    parity -135.7)
  tap matrices and the low-pass kernel              bit for bit
"""

import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.ids import IdSpace as JIdSpace
from dsp_stuff_tpu.ops import oversample as jov
from dsp_stuff_tpu.ops import shaping as jsh
from dsp_stuff_tpu_torch.ids import IdSpace as TIdSpace
from dsp_stuff_tpu_torch.ops import oversample as tov
from dsp_stuff_tpu_torch.ops import shaping as tsh
from dsp_stuff_tpu_torch.utils import precision as tprec

CONV_DB = -120.0
SHAPER_DB = -120.0
CYCLE_DB = -120.0
RATES = [2, 4, 8]
POLICIES = ["fast", "parity"]


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _dbfs(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    return 20 * np.log10(max(err, 1e-30) / max(np.abs(want).max(), 1e-30))


def _sig(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5
            ).astype(np.float32)


@pytest.mark.parametrize("R", RATES)
def test_constants_equal_jax_bitwise(R):
    np.testing.assert_array_equal(tov._lowpass_kernel(R),
                                  jov._lowpass_kernel(R))
    np.testing.assert_array_equal(tov._up_matrix(R), jov._up_matrix(R))
    np.testing.assert_array_equal(tov._down_matrix(R), jov._down_matrix(R))
    dev = torch.device("cpu")
    up = tov._matrix_on("up", R, dev)
    assert up is tov._matrix_on("up", R, dev)          # copied once
    np.testing.assert_array_equal(up.numpy(), jov._up_matrix(R))
    np.testing.assert_array_equal(tov._matrix_on("down", R, dev).numpy(),
                                  jov._down_matrix(R))


@pytest.mark.parametrize("T", [1000, 2048 + 77])
@pytest.mark.parametrize("R", RATES)
def test_upsample_downsample_match_jax(R, T):
    """Ragged T (not a multiple of the 128-sample block), a batch of 3."""
    x = _sig((3, T), seed=R * 10 + T % 7)
    up_t = tov.upsample(torch.from_numpy(x), R)
    up_j = np.asarray(jov.upsample(x, R))
    assert tuple(up_t.shape) == up_j.shape == (3, R * T)
    assert _dbfs(up_t.numpy(), up_j) <= CONV_DB
    y = _sig((3, R * T + 3), seed=R + T)               # Tu not a multiple of R
    dn_t = tov.downsample(torch.from_numpy(y), R)
    dn_j = np.asarray(jov.downsample(y, R))
    assert tuple(dn_t.shape) == dn_j.shape
    assert _dbfs(dn_t.numpy(), dn_j) <= CONV_DB


@pytest.mark.parametrize("R", [1, 4])
def test_oversampled_overdrive_modulated_drive(R):
    """A per-sample drive is upsampled beside the signal; the scalars
    broadcast."""
    T = 1536
    x = _sig((2, T), seed=3)
    drive = (0.5 + 0.4 * np.sin(np.arange(T) / 97.0)).astype(np.float32)
    with dt.policy("fast"):
        got = tov.oversampled(tsh.overdrive, torch.from_numpy(x), R, 6.0,
                              torch.from_numpy(drive), 0.8)
    with dj.policy("fast"):
        want = np.asarray(jov.oversampled(jsh.overdrive, x, R, 6.0, drive,
                                          0.8))
    assert tuple(got.shape) == want.shape == (2, T)
    assert _dbfs(got.numpy(), want) <= SHAPER_DB


def _cycle_graph(pkg, ids):
    """input -> gain -> distort(Tanh, 4x) -> reverb -> output, the reverb
    back into the gain: an oversampled member inside a feedback cycle,
    which the cycle programs leave to the per-node block scan."""
    g = pkg.Graph(ids)
    inp = g.add("input")
    gn = g.add("gain", level=0.5)
    ds = g.add("distort", mode="Tanh", level=2.0, oversample="4")
    rv = g.add("reverb", seconds=0.01, decay=0.3)
    out = g.add("output")
    g.chain(inp, gn, ds, rv, out)
    g.connect(rv, "out", gn, "in")
    return g


@pytest.mark.parametrize("pol", POLICIES)
def test_oversampled_member_in_cycle_matches_jax(pol):
    gj = _cycle_graph(dj, JIdSpace())
    gt = _cycle_graph(dt, TIdSpace())
    assert dt.dumps_graph(gt) == dj.dumps_graph(gj)
    x = _sig((2, 1, 1024), seed=5)
    with dj.policy(pol):
        yj, _, _ = dj.compile_graph(gj).render(x, batch_shape=(2,))
    with dt.policy(pol):
        cg = dt.compile_graph(gt, device="cpu")
        comp = next(c for c in cg._sccs if len(c) > 1)
        assert cg._cycle_program(comp, None) is None    # the per-node scan
        yt, _, _ = cg.render(x, batch_shape=(2,))
    assert _dbfs(yt.numpy(), np.asarray(yj)) <= CYCLE_DB


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("node,params", [
    ("overdrive", {"boost": 8.0, "drive": 0.8, "level": 0.9}),
    ("distort", {"mode": "Tanh", "level": 6.0}),
    ("distort", {"mode": "Fuzz", "level": 3.0}),
])
@pytest.mark.parametrize("R", ["2", "8"])
def test_oversampled_node_matches_jax(node, params, R, pol):
    """An oversampled shaper alone between input and output; Fuzz stays at
    the base rate whatever the select says."""
    def build(pkg, ids):
        g = pkg.Graph(ids)
        inp = g.add("input")
        sh = g.add(node, oversample=R, **params)
        out = g.add("output")
        g.chain(inp, sh, out)
        return g
    gj, gt = build(dj, JIdSpace()), build(dt, TIdSpace())
    x = _sig((2, 1, 768), seed=int(R))
    with dj.policy(pol):
        yj, _, _ = dj.compile_graph(gj).render(x, batch_shape=(2,))
    with dt.policy(pol):
        yt, _, _ = dt.compile_graph(gt, device="cpu").render(
            x, batch_shape=(2,))
    assert _dbfs(yt.numpy(), np.asarray(yj)) <= SHAPER_DB
