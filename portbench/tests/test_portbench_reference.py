"""The reference's vectorised blocks against the frozen sequential oracle,
and the composed reference against the program on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import reference
from portbench.reference import blocks as b
from portbench.reference import oracle

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P64 = b.Prec("f64")


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def signal(T=4000, seed=3, amp=0.5):
    return (np.random.default_rng(seed).standard_normal(T) * amp
            ).astype(np.float32)


def t64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


@pytest.mark.parametrize("name", ["low_pass", "high_pass", "biquad",
                                  "biquad_resonant", "reverb"])
def test_linear_blocks_match_oracle(name):
    x = signal()
    if name == "low_pass":
        want, _ = oracle.low_pass(x, 0.6)
        got = b.low_pass(t64(x), 0.6, P64)
    elif name == "high_pass":
        want, _ = oracle.high_pass(x, 0.2)
        got = b.high_pass(t64(x), 0.2, P64)
    elif name == "biquad":
        want, _ = oracle.biquad_df1(x, 1.0, -0.24, 0.0, 0.758, 0.0, 0.0)
        got = b.biquad(t64(x), 1.0, -0.24, 0.0, 0.758, 0.0, 0.0, P64)
    elif name == "biquad_resonant":
        want, _ = oracle.biquad_df1(x, 1.2, -1.8, 0.81 * 1.2, 0.1, 0.2, 0.1)
        got = b.biquad(t64(x), 1.2, -1.8, 0.81 * 1.2, 0.1, 0.2, 0.1, P64)
    else:
        want, _ = oracle.reverb(x, 0.01, 0.4)
        got = b.comb(t64(x), b.reverb_delay(0.01), 0.4)
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("name", ["overdrive", "soft_clip", "tanh",
                                  "chebyshev", "mod_map"])
def test_shapers_match_oracle(name):
    x = signal(amp=0.8)
    fn = {"overdrive": (lambda v: oracle.overdrive(v, 4.0, 0.6, 0.9),
                        lambda v: b.overdrive(v, 4.0, 0.6, 0.9)),
          "soft_clip": (lambda v: oracle.soft_clip(v, 4.0),
                        lambda v: b.soft_clip(v, 4.0)),
          "tanh": (lambda v: oracle.tanh_clip(v, 3.0),
                   lambda v: b.tanh_clip(v, 3.0)),
          "chebyshev": (lambda v: oracle.chebyshev_asym(v, 2.0, 4.0),
                        lambda v: b.chebyshev(v, 2.0, 4.0)),
          "mod_map": (lambda v: oracle.mod_map(v, 0.0, 1.0),
                      lambda v: b.mod_map(v, 0.0, 1.0))}[name]
    assert rel(fn[1](t64(x)), fn[0](x)) < 1e-6


@pytest.mark.parametrize("attack,release", [(5.0, 20.0), (50.0, 400.0)])
def test_envelope_matches_oracle_across_chunks(attack, release):
    x = signal(T=6000, amp=0.7)
    want, _ = oracle.envelope(x, attack, release)
    got = b.envelope(t64(x)[None], attack, release, P64, chunk=512)[0]
    assert rel(got, want) < 1e-5


def test_lfo_and_chorus_match_oracle():
    T = 128 * 40
    want, _ = oracle.signal_gen("Sine", 0.6, 0.5, T)
    assert np.array_equal(b.lfo_sine(0.6, 0.5, T), want)
    x = signal(T=T)
    want, _, _ = oracle.chorus(x, 1.2, 0.003, 0.008, 0.4)
    got = b.chorus(t64(x), 1.2, 0.003, 0.008, 0.4, P64)
    assert rel(got, want) < 1e-6


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11 + 2.0 ** -12,
                      1.0 + 2.0 ** -12, -3.0])
    assert b.tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                                  -3.0]


def config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["chain10", "feedback16"])
@pytest.mark.parametrize("policy", ["fast", "parity"])
def test_reference_matches_the_program_on_the_cpu(name, policy):
    import dsp_stuff_tpu_torch as dst
    cfg = config(name)
    x = torch.randn((2, 128 * 40), generator=torch.Generator().manual_seed(5)
                    ) * 0.25
    with dst.policy(policy):
        cg = dst.compile_graph(dst.loads_graph(json.dumps(cfg["graph"])),
                               device="cpu")
        out, aux, state = cg.render({str(cfg["input"]): x},
                                    batch_shape=(2,))
    want = reference.composition(name).render(x, cfg, P64)
    assert rel(out[:, 0], want["out"]) < 1e-5
    from portbench.harness import render as kind
    got = [kind.end_state(state, r) for r in range(2)]
    for k, st in want["state"].items():
        for e, w in st.items():
            g = np.stack([row[k][e] for row in got])
            assert rel(g, w.detach().numpy()) < 1e-5, (k, e)
    if "spec" in want:
        cols = aux[f"spectrogram:{cfg['spectrogram']}"]["columns"]
        assert rel(cols, want["spec"]) < 1e-5


def test_composition_refuses_another_graph():
    cfg = config("chain10")
    cfg["graph"]["nodes"][2]["typename"] = "gain"
    with pytest.raises(ValueError):
        reference.composition("chain10").render(np.zeros((1, 256)), cfg, P64)
