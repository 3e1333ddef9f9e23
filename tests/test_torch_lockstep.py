"""The lockstep counters (dsp_stuff_tpu_torch/ops/lockstep.py): a Python
int, as a render holds one, and a 0-d int64 tensor, as a stream session's
block step holds one, give the same values in every op that takes them:
the reverb ring's order, the chorus's clock, the FIR's warm-up.  The FIR
over segments is also held against the JAX package's (which slices on a
Python int), at the bounds tests/test_torch_fir.py uses.
"""

import numpy as np
import pytest
import torch

import dsp_stuff_tpu as dj
import dsp_stuff_tpu_torch as dt
from dsp_stuff_tpu.ops import fir as jfir
from dsp_stuff_tpu_torch.ops import fir as tfir
from dsp_stuff_tpu_torch.ops import lockstep
from dsp_stuff_tpu_torch.ops.modfx import max_delay_samples, modulated_delay
from dsp_stuff_tpu_torch.utils import precision as tprec
from test_torch_fir import VS_JAX_DB, _dbfs

D = 300


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("pos", [0, 1, 137, D - 1])
def test_oldest_first_is_the_roll(pos):
    """The ring rolled back by ``pos``, from an int and from a 0-d
    tensor, bitwise np.roll (the JAX package's jnp.roll)."""
    ring = torch.from_numpy(np.random.default_rng(pos).standard_normal(
        (3, D)).astype(np.float32))
    want = np.roll(ring.numpy(), -pos, axis=-1)
    for c in (pos, np.int32(pos), lockstep.on_device(pos, "cpu")):
        np.testing.assert_array_equal(
            lockstep.oldest_first(ring, c).numpy(), want)


@pytest.mark.parametrize("limit", [None, 1000])
def test_advance_keeps_the_form(limit):
    """An int advances to an int, a tensor to a 0-d int64 tensor, to the
    same value, saturating at ``limit``."""
    for start in (0, 900, 999):
        a = lockstep.advance(np.int64(start), 128, limit)
        b = lockstep.advance(lockstep.on_device(start, "cpu"), 128, limit)
        assert type(a) is int and lockstep.is_counter(b)
        want = start + 128 if limit is None else min(start + 128, limit)
        assert a == int(b) == want


def _fir_segments(x, taps_rev, cuts, n_seen):
    """fir_apply over x [B, T] cut at ``cuts``, the counter started as
    ``n_seen`` (an int or a tensor): (y [B, T], final counter)."""
    st = tfir.init_fir_state(len(taps_rev))
    st = (st[0], st[1], n_seen)
    ys, a = [], 0
    for b in list(cuts) + [x.shape[-1]]:
        y, st = tfir.fir_apply(x[:, a:b], taps_rev, st)
        ys.append(y)
        a = b
    return torch.cat(ys, dim=-1).numpy(), st[2]


@pytest.mark.parametrize("pol", ["fast", "parity"])
@pytest.mark.parametrize("n_taps", [37, 300])
def test_fir_counter_forms_agree(n_taps, pol):
    """The FIR's warm-up over segments that start before, across and past
    its end: the tensor counter bitwise the int one, and both against
    the JAX package's fir_apply over the same cuts."""
    rng = np.random.default_rng(n_taps)
    x = (rng.standard_normal((2, 1024)) * 0.5).astype(np.float32)
    taps_rev = rng.standard_normal(n_taps) * 0.2
    cuts = (20, 128, 200, 640)
    xt = torch.from_numpy(x)
    with dt.policy(pol):
        y_int, n_int = _fir_segments(xt, taps_rev, cuts, 0)
        y_dev, n_dev = _fir_segments(xt, taps_rev, cuts,
                                     lockstep.on_device(0, "cpu"))
    np.testing.assert_array_equal(y_dev, y_int)
    assert type(n_int) is int and lockstep.is_counter(n_dev)
    assert n_int == int(n_dev) == x.shape[-1]
    with dj.policy(pol):
        st, ys, a = None, [], 0
        for b in list(cuts) + [x.shape[-1]]:
            y, st = jfir.fir_apply(x[:, a:b], taps_rev, st)
            ys.append(np.asarray(y))
            a = b
    assert _dbfs(y_int, np.concatenate(ys, axis=-1)) <= VS_JAX_DB[pol]


def test_chorus_counter_forms_agree():
    """A chorus over three segments: the tensor clock bitwise the int
    one, and advanced to the same sample."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((2, 640)) * 0.5)
                         .astype(np.float32))
    L = max_delay_samples(0.008, 0.003)
    outs = {}
    for form in ("int", "tensor"):
        hist = torch.zeros(L)
        t0 = 0 if form == "int" else lockstep.on_device(0, "cpu")
        ys = []
        for a, b in ((0, 128), (128, 384), (384, 640)):
            y, hist, t0 = modulated_delay(x[:, a:b], 1.2, 0.003, 0.008, 0.4,
                                          hist, t0)
            ys.append(y)
        outs[form] = (torch.cat(ys, -1).numpy(), t0)
    np.testing.assert_array_equal(outs["tensor"][0], outs["int"][0])
    assert type(outs["int"][1]) is int and outs["int"][1] == 640
    assert lockstep.is_counter(outs["tensor"][1])
    assert int(outs["tensor"][1]) == 640
