"""The port's envelope follower (dsp_stuff_tpu_torch/ops/envelope.py, node
Envelope) and the CPU-side half of its CUDA kernel
(ops/envelope_kernel.py) against the JAX package and the NumPy oracle.

The CUDA kernel itself runs only on a GPU (chip_smoke.py holds it against
``_seq_scan`` and ``_chunked_batched`` there).  Here the plain versions
are held against the JAX package's, including its Pallas kernels in
interpret mode, called as tests/test_pallas.py calls them.

Bounds: the port rounds d + g*(env - d) twice, as the oracle does, and is
held bitwise against the oracle; XLA on the CPU contracts it into one FMA,
so the JAX package's scans and interpret kernels are held at atol 1e-6
(measured 4.8e-7 at worst).  The chunked follower is within atol 2e-7 of
the sequential one once each chunk has forgotten its guessed start
(g^chunk << f32 rounding), as in tests/test_pallas.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from dsp_stuff_tpu.ops import envelope as je
from dsp_stuff_tpu.ops import pallas_envelope as jpe
from dsp_stuff_tpu_torch.nodes.filters import Envelope
from dsp_stuff_tpu_torch.ops import envelope as te
from dsp_stuff_tpu_torch.ops import envelope_kernel as tek
from dsp_stuff_tpu_torch.utils import precision as tprec

CHUNK_ATOL = 2e-7
VS_JAX_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _torch_env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tprec.get_policy()
    yield
    tprec.set_policy(prev)
    torch.set_num_threads(threads)


def _x(B, T, seed, scale=0.6):
    return (np.random.default_rng(seed).standard_normal((B, T)) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("frames", [0.0, 1.0, 4.0, 12.0, 50.0, 400.0,
                                    1000.0])
def test_gain_from_frames_matches_jax_host_gain(frames):
    """Host NumPy f32, as the JAX package computes a concrete frame count
    (and as the oracle does)."""
    assert np.float32(te.gain_from_frames(frames)) == \
        np.float32(je.gain_from_frames(frames))


def _near(got, want, atol=VS_JAX_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_seq_scan_matches_jax_and_pallas_interpret():
    """The sequential follower against the JAX lax.scan and the JAX
    sequential Pallas kernel (interpret mode)."""
    x = _x(3, 2100, 3, 0.7)
    atk, rel = te.gain_from_frames(5.0), te.gain_from_frames(40.0)
    e0 = np.float32([0.0, 0.4, 1.7])
    got, fin = te._seq_scan(torch.from_numpy(x), atk, rel,
                            torch.from_numpy(e0))
    want, wfin = je._seq_scan(jnp.asarray(x), np.float32(atk),
                              np.float32(rel), jnp.asarray(e0))
    _near(got.numpy(), want)
    _near(fin.numpy(), wfin)
    pk, pfin = jpe.peak_envelope_pallas(x, np.float32(atk), np.float32(rel),
                                        e0, interpret=True)
    _near(got.numpy(), pk)
    _near(fin.numpy(), pfin)


@pytest.mark.parametrize("chunk", [512, 1024])
def test_chunked_matches_jax_and_pallas_interpret(chunk):
    """The two-pass chunked follower with a small chunk against the JAX
    chunked scan, the JAX chunked Pallas kernel in interpret mode and the
    port's sequential follower."""
    T = 512 * 9 + 301                     # ragged tail, several chunks
    x = _x(2, T, 4)
    atk, rel = te.gain_from_frames(4.0), te.gain_from_frames(12.0)
    e0 = np.float32([0.3, 0.0])
    got, fin = te._chunked_batched(torch.from_numpy(x), atk, rel,
                                   torch.from_numpy(e0), chunk)
    want, wfin = jax.jit(lambda xx, ee: je._chunked_batched(
        xx, np.float32(atk), np.float32(rel), ee, chunk))(x, e0)
    _near(got.numpy(), want)
    _near(fin.numpy(), wfin)
    pk, pfin = jpe.peak_envelope_pallas_chunked(
        x, np.float32(atk), np.float32(rel), e0, chunk=chunk, interpret=True)
    _near(got.numpy(), pk)
    _near(fin.numpy(), pfin)
    seq, sfin = te._seq_scan(torch.from_numpy(x), atk, rel,
                             torch.from_numpy(e0))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=0,
                               atol=CHUNK_ATOL)


def test_peak_envelope_matches_oracle():
    x = _x(2, 3000, 5)
    for i in range(2):
        want, wfin = oracle.envelope(x[i], 50.0, 400.0, np.float32(0.1))
        with tprec.policy("parity"):
            got, fin = te.peak_envelope(torch.from_numpy(x[i]), 50.0, 400.0,
                                        0.1)
        np.testing.assert_array_equal(got.numpy(), want)
        assert float(fin) == float(wfin)


@pytest.mark.parametrize("pol,frames,chunked", [
    ("fast", 40.0, True), ("parity", 40.0, False), ("fast", 2000.0, False),
    ("fast", -1.0, False)])
def test_peak_envelope_dispatch(pol, frames, chunked, monkeypatch):
    """The chunked follower runs under ``fast`` for T > 2 chunks and frame
    counts inside its contraction bound; everything else runs the
    sequential one.  Leading batch dimensions flatten and come back."""
    monkeypatch.setattr(te, "_CHUNK", 256)
    seen = []
    real_chunked, real_seq = te._chunked_batched, te._seq_scan
    monkeypatch.setattr(te, "_chunked_batched", lambda *a: seen.append(
        "chunked") or real_chunked(*a))
    monkeypatch.setattr(te, "_seq_scan", lambda *a: seen.append("seq")
                        or real_seq(*a))
    x = torch.from_numpy(_x(6, 1024, 6).reshape(2, 3, 1024))
    with tprec.policy(pol):
        env, fin = te.peak_envelope(x, frames, 8.0, 0.0)
    assert seen == ["chunked" if chunked else "seq"]
    assert env.shape == (2, 3, 1024) and fin.shape == (2, 3)
    np.testing.assert_array_equal(fin.numpy(), env[..., -1].numpy())


def test_envelope_node_clamps_and_carries_state():
    """Frame counts clamp to the sliders' 0..1000 (a negative count would
    amplify); two chained renders equal one."""
    x = torch.from_numpy(_x(2, 2048, 7))
    st0 = Envelope.init_state({}, 128)
    with tprec.policy("fast"):
        lo, _ = Envelope.process_seq({"attack": -5.0, "release": 5000.0},
                                     st0, {"in": x})
        ref, _ = Envelope.process_seq({"attack": 0.0, "release": 1000.0},
                                      st0, {"in": x})
        np.testing.assert_array_equal(lo["out"].numpy(), ref["out"].numpy())
        p = {"attack": 50.0, "release": 400.0}
        full, _ = Envelope.process_seq(p, st0, {"in": x})
        a, st = Envelope.process_seq(p, st0, {"in": x[:, :700]})
        b, st = Envelope.process_seq(p, st, {"in": x[:, 700:]})
    np.testing.assert_array_equal(
        torch.cat([a["out"], b["out"]], -1).numpy(), full["out"].numpy())
    assert st["env"].shape == (2,)


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback inside the wrapper: a CPU tensor is refused, and the
    launch count does not move."""
    before = tek.LAUNCHES
    x = torch.zeros((2, 256))
    with pytest.raises(ValueError, match="CUDA"):
        tek.peak_envelope_cuda(x, torch.tensor([0.9, 0.99]), torch.zeros(2),
                               chunk=256)
    assert tek.LAUNCHES == before


def _one_launch_model(x, atk, rel, env0, chunk):
    """The envelope kernel's one-launch schedule (csrc/envelope_kernel.cu)
    in PyTorch: one lane per (row, chunk p) walking the window
    [(p - 1) * chunk, (p + 1) * chunk) of its row (zeros outside [0, T)),
    from a zero start (env0 for p = 1; chunk 0 restarts from env0 where
    its second half begins); one window of T from env0 when chunk >= T.
    Returns (env [B, T], final [B])."""
    B, T = x.shape
    length, P = tek.chunks(T, chunk)
    pre = length if P > 1 else 0
    S = pre + length
    lanes = torch.arange(B * P)
    row, p = lanes // P, lanes % P
    pos = p[:, None] * length - pre + torch.arange(S)[None, :]
    inside = (pos >= 0) & (pos < T)
    xw = torch.where(inside, x[row[:, None], pos.clamp(0, T - 1)],
                     torch.zeros(()))
    e0 = env0[row]
    env = e0 if pre == 0 else torch.where(p == 1, e0, torch.zeros(()))
    a = torch.tensor(atk, dtype=torch.float32)
    r = torch.tensor(rel, dtype=torch.float32)
    out = torch.empty((B * P, S))
    for s in range(S):
        if s == pre:
            env = torch.where(p == 0, e0, env)
        dt = torch.abs(xw[:, s])
        env = dt + torch.where(env < dt, a, r) * (env - dt)
        out[:, s] = env
    y = torch.full((B, T), float("inf"))
    keep = inside & (torch.arange(S)[None, :] >= pre)
    y[row[:, None].expand(-1, S)[keep], pos[keep]] = out[keep]
    return y, y[:, -1]


@pytest.mark.parametrize("B,chunk,nan", [(1, 1000, False), (3, 1000, True),
                                         (3, 1000, False),
                                         (3, 32768, False),
                                         (1, 32768, True)])
def test_one_launch_schedule_is_bitwise_chunked(B, chunk, nan):
    """The one-launch schedule computes _chunked_batched's very numbers
    (the same operations in the same order) at a ragged T of several
    chunks, NaN in x included, and every sample of y is written once."""
    T = 2 * chunk + 1234
    x = torch.from_numpy(_x(B, T, 20 + B, 0.7))
    if nan:
        x[0, chunk // 2] = float("nan")
        x[-1, T - 3] = float("nan")
    atk, rel = te.gain_from_frames(50.0), te.gain_from_frames(400.0)
    e0 = torch.from_numpy(np.float32([0.3, 0.0, 1.1][:B]))
    want, wfin = te._chunked_batched(x, atk, rel, e0, chunk)
    got, fin = _one_launch_model(x, atk, rel, e0, chunk)
    assert not torch.isinf(got).any()
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(fin.numpy(), wfin.numpy())


@pytest.mark.parametrize("T,chunk", [(3000, 3000), (3000, 5000), (1, 7)])
def test_one_launch_schedule_sequential(T, chunk):
    """With chunk >= T the schedule is one window from env0: _seq_scan's
    numbers, bitwise."""
    x = torch.from_numpy(_x(3, T, 30, 0.7))
    atk, rel = te.gain_from_frames(5.0), te.gain_from_frames(40.0)
    e0 = torch.from_numpy(np.float32([0.0, 0.4, 1.7]))
    want, wfin = te._seq_scan(x, atk, rel, e0)
    got, fin = _one_launch_model(x, atk, rel, e0, chunk)
    assert tek.chunks(T, chunk) == (T, 1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(fin.numpy(), wfin.numpy())
