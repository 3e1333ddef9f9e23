"""feedback16: BASELINE.json's 16-node graph with feedback edges
(models/presets.py config5_feedback_16node), composed as
chip_smoke.oracle_config5 and tests/test_presets.py compose it: the
feedback SCC (add -> reverb -> low_pass -> gain -> add) evaluated a
128-block at a time, its back edge reading the previous block; an LFO on
the overdrive's drive; the spectrogram tap on the biquad's output."""

from __future__ import annotations

import torch

from . import blocks as b
from . import sliders, typename

#: the program's key of the feedback SCC's carried blocks, by its lowest
#: node id.  Of them only the back edge's source (gain -> add) is read by
#: a later block, so the state compared holds that one alone.
CYCLE = "__cycle__5"
KINDS = {"1": "gain", "2": "signal_gen", "3": "overdrive", "4": "distort",
         "5": "add", "6": "reverb", "7": "low_pass", "8": "gain",
         "9": "high_pass", "10": "chorus", "11": "mix", "12": "envelope",
         "13": "biquad", "14": "spectrogram"}


def check_graph(cfg: dict) -> None:
    got = {n: typename(cfg, n) for n in KINDS}
    if got != KINDS:
        raise ValueError(f"feedback16's reference composes {KINDS}, the "
                         f"configuration holds {got}")


def _cycle(dist, s: dict, p: b.Prec):
    """The feedback SCC a block at a time: (the reverb's output [..., T],
    the SCC's end state: the reverb's line, the low pass's state, and the
    last block of the back edge's source, the gain, which the add reads
    in the next block)."""
    T = dist.shape[-1]
    D = b.reverb_delay(s["6"]["seconds"])
    decay = b.f32(s["6"]["decay"])
    r = b.f32(s["7"]["ratio"])
    g_in = b.f32(1.0 - r)
    fb = b.f32(s["8"]["level"])
    n = b.BUF
    i = torch.arange(n, device=p.device)
    lag = (i[:, None] - i[None, :]).to(p.dtype)
    H = torch.where(lag >= 0, r ** lag.clamp(min=0), 0.0).to(p.dtype)
    carry = p.t([r ** (k + 1) for k in range(n)])
    rv = torch.zeros_like(dist)
    prev_fb = torch.zeros_like(dist[..., :n])
    z = torch.zeros_like(dist[..., 0])
    for b0 in range(0, T, n):
        mixa = b.h(dist[..., b0:b0 + n]) + b.h(prev_fb)
        v = b.h(mixa)
        lo = b0 - D
        if lo + n > 0:
            past = rv[..., max(lo, 0):lo + n]
            v = v + decay * torch.nn.functional.pad(
                past, (n - past.shape[-1], 0))
        rv[..., b0:b0 + n] = v
        lp = p.mm(g_in * b.h(v), H.T) + z[..., None] * carry
        z = lp[..., -1]
        prev_fb = b.h(lp) * fb
    st = {"6": {"ring": b.last(rv, D)}, "7": {"z": z},
          CYCLE: {"8:out": prev_fb}}
    return rv, st


def render(x, cfg: dict, p: b.Prec) -> dict:
    """{"out": [..., T], "spec": [..., columns, K], "state": {node id:
    {entry: [...]}}} of input x [..., T] from a fresh state."""
    check_graph(cfg)
    s = sliders(cfg)
    x = p.t(x)
    T = x.shape[-1]
    if T % b.BUF:
        raise ValueError("feedback16's reference takes whole 128-blocks")
    pre = b.gain(b.h(x), s["1"]["level"])
    g = s["2"]
    if g["mode"] != "Sine":
        raise ValueError("feedback16's reference composes a Sine LFO")
    lfo = p.t(b.lfo_sine(g["amplitude"], g["frequency"], T))
    # the LFO's end clock is left out: 10 s of 0.5 Hz is five whole
    # cycles, so it ends at ~0, as a clock that never moved does, and the
    # fast policy's float64 clock lands 4e-5 of a cycle across the wrap
    st = {}
    drive = b.mod_map(b.h(lfo), 0.0, 1.0)
    q = s["3"]
    od = b.overdrive(b.h(pre), q["boost"], drive, q["level"])
    dist = b.soft_clip(b.h(od), s["4"]["level"])
    rv, cyc = _cycle(dist, s, p)
    st.update(cyc)
    u = b.h(rv)
    hp = b.high_pass(u, s["9"]["ratio"], p)
    st["9"] = {"z": u[..., -1] - hp[..., -1]}
    q = s["10"]
    u = b.h(hp)
    ch = b.chorus(u, q["rate"], q["depth"], q["base"], q["mix"], p)
    L = b.chorus_taps(q["rate"], q["depth"], q["base"], 0)[0]
    st["10"] = {"hist": b.last(u, L),
                "t0": p.t(float(T)).expand(x.shape[:-1])}
    mx = b.mix(b.h(pre), b.h(ch), s["11"]["ratio"])
    q = s["12"]
    env = b.envelope(b.h(mx).cpu(), q["attack"], q["release"],
                     p).to(p.device)
    st["12"] = {"env": env[..., -1]}
    q = s["13"]
    u = b.h(env)
    bq = b.biquad(u, q["a0"], q["a1"], q["a2"], q["b0"], q["b1"], q["b2"], p)
    st["13"] = b.df1_state(u, bq)
    q = s["14"]
    spec = b.spectrogram(b.h(bq), int(q["fft_size"]), float(q["lower_bound"]),
                         float(q["upper_bound"]), int(q["buffer_size"]), p)
    return {"out": b.h(bq), "spec": spec, "state": st}
