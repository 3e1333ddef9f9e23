"""chain10: input -> gain -> biquad -> overdrive -> low_pass -> high_pass
-> distort (Tanh) -> chebyshev -> reverb -> output, every hop through a
one-source fan-in (bench.py:100-114's chain, as bench.oracle_chain
composes it)."""

from __future__ import annotations

from . import blocks as b
from . import sliders, typename

#: the chain's nodes in order, by id in configs/chain10.json
ORDER = ("1", "2", "3", "4", "5", "6", "7", "8")
KINDS = ("gain", "biquad", "overdrive", "low_pass", "high_pass", "distort",
         "chebyshev", "reverb")


def check_graph(cfg: dict) -> None:
    got = tuple(typename(cfg, n) for n in ORDER)
    if got != KINDS:
        raise ValueError(f"chain10's reference composes {KINDS}, the "
                         f"configuration holds {got}")


def run(x, s: dict, p: b.Prec):
    """(the output [..., T], the end state {node id: {entry: [...]}}) of
    input ``x`` [..., T] from a fresh state under sliders ``s`` ({node id:
    {name: value}}, a value a float or a 0-d tensor)."""
    v = b.gain(b.h(x), s["1"]["level"])
    q = s["2"]
    u = b.h(v)
    v = b.biquad(u, q["a0"], q["a1"], q["a2"], q["b0"], q["b1"], q["b2"], p)
    st = {"2": b.df1_state(u, v)}
    q = s["3"]
    v = b.overdrive(b.h(v), q["boost"], q["drive"], q["level"])
    v = b.low_pass(b.h(v), s["4"]["ratio"], p)
    st["4"] = {"z": v[..., -1]}
    u = b.h(v)
    v = b.high_pass(u, s["5"]["ratio"], p)
    st["5"] = {"z": u[..., -1] - v[..., -1]}
    v = b.tanh_clip(b.h(v), s["6"]["level"])
    v = b.chebyshev(b.h(v), s["7"]["level_pos"], s["7"]["level_neg"])
    D = b.reverb_delay(s["8"]["seconds"])
    v = b.comb(b.h(v), D, s["8"]["decay"])
    st["8"] = {"ring": b.last(v, D)}
    return b.h(v), st


def forward(x, s: dict, p: b.Prec):
    """The output [..., T] of input ``x`` [..., T] under sliders ``s``."""
    return run(x, s, p)[0]


def render(x, cfg: dict, p: b.Prec) -> dict:
    """{"out": [..., T], "state": {node id: {entry: [...]}}} of input x
    [..., T] from a fresh state."""
    check_graph(cfg)
    out, st = run(p.t(x), sliders(cfg), p)
    return {"out": out, "state": st}
