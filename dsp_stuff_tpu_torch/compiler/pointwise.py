"""Pointwise groups: the stateless per-sample ops between the port's kernels
as one straight-line program, its lowering and its plain version.

The JAX package renders through ``jax.jit(self.fn)``
(dsp_stuff_tpu/compiler/compile.py:230), so XLA fuses every stateless
per-sample op between its kernels into loops: fan-in averages,
modulation maps, gains, mixes and shapers.  The port's planner gathers
each run of such nodes into a *group* (compiler/compile.py
``_plan_pointwise``); a group lowers here into a :class:`Program`, a
straight-line op list over values with a dtype each ("f32", "f64",
"bool"), and runs as one generated CUDA C++ kernel on the card
(ops/pointwise_kernel.py, csrc/pointwise_kernel.cu).  :func:`interpret`
runs the same list as PyTorch ops, one op at a time: the kernel's plain
version, and what the CPU runs.

The lowering keeps the eager node code's op order and policy choices
exactly (each form names the code it mirrors: compile._avg and _map_mod,
nodes/simple.py's Gain, Add and Mix, ops/shaping.py's overdrive,
chebyshev_asym and the Distort modes but Fuzz): each op of a program is
one eager op, rounded once, so the interpreter is bitwise the
eager ops on the CPU, and the kernel (each op the same single-rounded
CUDA operation) bitwise them on the card.  A divide is a true divide
wherever the node code means one (``precision.div_ieee``); a
transcendental is f32 under ``fast`` and f64 rounded once to f32 under
``parity`` and ``exact`` (``shaping._trans``).

Operands are read, never baked in: ``sig`` k is the k-th signal operand
([..., T] or [T]), ``scal`` k the k-th scalar operand (a 0-d f32 tensor
in device memory: a slider, a level, a fan-in divisor).  Literal
constants are only the node code's own (0.5 of a map, the shapers' 2/pi,
the bypass threshold), so two groups of one structure are one program
whatever their sliders hold.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import shaping
from dsp_stuff_tpu_torch.ops.shaping import BYPASS_EPS
from dsp_stuff_tpu_torch.utils.precision import div_ieee, scalar_on

#: every op of the IR: (operand count, result dtype or None for the
#: operands' dtype)
OPS = {
    "sig": (0, "f32"), "scal": (0, "f32"), "const": (0, None),
    "zero": (0, "f32"),
    "add": (2, None), "sub": (2, None), "mul": (2, None), "div": (2, None),
    "neg": (1, None), "abs": (1, None), "sign": (1, None),
    "lt": (2, "bool"), "le": (2, "bool"), "gt": (2, "bool"),
    "ge": (2, "bool"), "and": (2, "bool"), "or": (2, "bool"),
    "where": (3, None), "clamp": (1, None),
    "f64": (1, "f64"), "f32": (1, "f32"),
    "atan": (1, None), "tanh": (1, None), "sin": (1, None),
}
TRANSCENDENTALS = ("atan", "tanh", "sin")

_PI4 = float(np.float32(np.pi / 4.0))
_TWO_PI = float(np.float32(2.0 / np.pi))
_TWO3 = float(np.float32(2.0 / 3.0))


class Program(NamedTuple):
    """A group's straight-line program: ``ops`` as (op, dtype, args, imm)
    in order (value i is op i; ``imm`` the k of sig / scal, a const's
    value, a clamp's (lo, hi)), ``outs`` the values written, and the
    counts of signal and scalar operands.  Hashable: a build is keyed on
    it."""
    ops: tuple
    outs: tuple
    n_sig: int
    n_scal: int


class Builder:
    """Appends ops to a program; identical ops (pure) are one value."""

    def __init__(self):
        self.ops: list = []
        self._memo: dict = {}
        self.n_sig = 0
        self.n_scal = 0

    def _op(self, op: str, args: tuple = (), imm=None, dtype=None) -> int:
        n, res = OPS[op]
        assert len(args) == n, (op, args)
        dt = dtype or res or (self.ops[args[-1]][1] if op == "where"
                              else self.ops[args[0]][1])
        entry = (op, dt, tuple(args), imm)
        # a constant by its bits (0.0 and -0.0 are two constants)
        key = entry if op != "const" else (op, dt, float(imm).hex())
        got = self._memo.get(key)
        if got is None:
            got = self._memo[key] = len(self.ops)
            self.ops.append(entry)
        return got

    # operands and constants
    def sig(self) -> int:
        self.n_sig += 1
        return self._op("sig", imm=self.n_sig - 1)

    def scal(self) -> int:
        self.n_scal += 1
        return self._op("scal", imm=self.n_scal - 1)

    def const(self, v, dtype: str = "f32") -> int:
        return self._op("const", imm=float(v), dtype=dtype)

    def zero(self) -> int:
        """A [T] signal of zeros (an unconnected port's ``_avg``)."""
        return self._op("zero")

    # arithmetic, one eager op each
    def add(self, a, b): return self._op("add", (a, b))
    def sub(self, a, b): return self._op("sub", (a, b))
    def mul(self, a, b): return self._op("mul", (a, b))
    def div(self, a, b): return self._op("div", (a, b))
    def neg(self, a): return self._op("neg", (a,))
    def abs(self, a): return self._op("abs", (a,))
    def sign(self, a): return self._op("sign", (a,))
    def lt(self, a, b): return self._op("lt", (a, b))
    def le(self, a, b): return self._op("le", (a, b))
    def gt(self, a, b): return self._op("gt", (a, b))
    def ge(self, a, b): return self._op("ge", (a, b))
    def and_(self, a, b): return self._op("and", (a, b))
    def or_(self, a, b): return self._op("or", (a, b))
    def where(self, c, a, b): return self._op("where", (c, a, b))

    def clamp(self, a, lo: float, hi: float):
        """torch.clamp with constant bounds: NaN propagates."""
        return self._op("clamp", (a,), (float(lo), float(hi)))

    def trans(self, fn: str, v: int, policy: str) -> int:
        """``shaping._trans``: native f32 under ``fast``, else evaluated in
        f64 and rounded once."""
        if policy == "fast":
            return self._op(fn, (v,))
        return self._op("f32", (self._op(fn, (self._op("f64", (v,)),)),))

    def program(self, outs) -> Program:
        """The program writing ``outs``, dead ops dropped and the values
        renumbered in order (so equal structures give equal programs)."""
        live = set()
        stack = list(outs)
        while stack:
            v = stack.pop()
            if v not in live:
                live.add(v)
                stack.extend(self.ops[v][2])
        new = {}
        ops = []
        for i, (op, dt, args, imm) in enumerate(self.ops):
            if i in live or op in ("sig", "scal"):
                new[i] = len(ops)
                ops.append((op, dt, tuple(new[a] for a in args), imm))
        return Program(tuple(ops), tuple(new[v] for v in outs), self.n_sig,
                       self.n_scal)


# -- the fusable forms --------------------------------------------------------
# Each mirrors its eager code op for op (the comments quote it); ``x`` and
# the parameters are value ids, a parameter a signal or a scalar alike.

def avg(b: Builder, srcs: list, divisor) -> int:
    """compiler/compile.py ``_avg``: ``(s0 + s1) + s2 ...`` then one true
    divide by the fan-in divisor (a scalar operand); zeros [T] without a
    source."""
    if not srcs:
        return b.zero()
    acc = srcs[0]
    for s in srcs[1:]:
        acc = b.add(acc, s)
    return b.div(acc, divisor)


def map_mod(b: Builder, sig: int, lo: float, hi: float) -> int:
    """compiler/compile.py ``_map_mod``: y = (x + 1) / 2; z = clamp(y, 0,
    1); lo + (hi - lo) * z, in f32 (``/ 2.0`` is exact either as a true
    divide or as the card's multiply by 0.5)."""
    y = b.div(b.add(sig, b.const(1.0)), b.const(2.0))
    z = b.clamp(y, 0.0, 1.0)
    span = float(np.float32(np.float32(hi) - np.float32(lo)))
    return b.add(b.const(float(np.float32(lo))), b.mul(b.const(span), z))


def gain(b, x, level):
    """nodes/simple.Gain: x * level."""
    return b.mul(x, level)


def add(b, a, c):
    """nodes/simple.Add: a + b."""
    return b.add(a, c)


def mix(b, a, c, r):
    """nodes/simple.Mix: b * r + a * (1 - r)."""
    return b.add(b.mul(c, r), b.mul(a, b.sub(b.const(1.0), r)))


def _below(b, level):
    return b.lt(level, b.const(BYPASS_EPS))


def _bypass(b, level, shaped, x):
    """shaping._bypass: where(level < BYPASS_EPS, x, shaped)."""
    return b.where(_below(b, level), x, shaped)


def _safe_level(b, level):
    """shaping._safe_level: where(level < BYPASS_EPS, 1, level)."""
    return b.where(_below(b, level), b.const(1.0), level)


def _tanh(b, v, pol):
    """shaping._tanh: tanh of clamp(v, -20, 20)."""
    return b.trans("tanh", b.clamp(v, -20.0, 20.0), pol)


def hard_clip(b, x, level, pol):
    """clip(x * level) / safe(level), bypassed."""
    return _bypass(b, level, b.div(b.clamp(b.mul(x, level), -1.0, 1.0),
                                   _safe_level(b, level)), x)


def soft_clip(b, x, level, pol):
    """v - (v * v) * v / 3 inside [-1, 1], +-2/3 outside (NaN takes -2/3),
    clipped over safe(level), bypassed."""
    v = b.mul(x, level)
    inner = b.sub(v, b.div(b.mul(b.mul(v, v), v), b.const(3.0)))
    inside = b.and_(b.ge(v, b.const(-1.0)), b.le(v, b.const(1.0)))
    shaped = b.where(b.gt(v, b.const(1.0)), b.const(_TWO3),
                     b.where(inside, inner, b.const(-_TWO3)))
    return _bypass(b, level, b.div(b.clamp(shaped, -1.0, 1.0),
                                   _safe_level(b, level)), x)


def tanh_clip(b, x, level, pol):
    """tanh(x * level), bypassed."""
    return _bypass(b, level, _tanh(b, b.mul(x, level), pol), x)


def recip_soft_clip(b, x, level, pol):
    """sign(x) * (1 - 1 / (|x| * level + 1)), bypassed."""
    den = b.add(b.mul(b.abs(x), level), b.const(1.0))
    shaped = b.mul(b.sign(x), b.sub(b.const(1.0), b.div(b.const(1.0), den)))
    return _bypass(b, level, shaped, x)


def sin_shape(b, x, level, pol):
    """sin(x * level), bypassed."""
    return _bypass(b, level, b.trans("sin", b.mul(x, level), pol), x)


def atan_shape(b, x, level, pol):
    """atan(x * level), bypassed."""
    return _bypass(b, level, b.trans("atan", b.mul(x, level), pol), x)


def square_shape(b, x, level, pol):
    """v * v * sign(v), v = x * level, bypassed."""
    v = b.mul(x, level)
    return _bypass(b, level, b.mul(b.mul(v, v), b.sign(v)), x)


def chebyshev4(b, x, level, pol):
    """8 v^4 - 8 v^2 + 1, v^4 = (v * v) * (v * v), bypassed."""
    v = b.mul(x, level)
    v2 = b.mul(v, v)
    v4 = b.mul(v2, v2)
    return _bypass(b, level, b.add(b.sub(b.mul(v4, b.const(8.0)),
                                         b.mul(v2, b.const(8.0))),
                                   b.const(1.0)), x)


def overdrive(b, x, boost, drive, level, pol):
    """drive * (2/pi) * atan(pi/4 * (x * boost)) + (1 - drive) * x, times
    level, bypassed on the level."""
    a = b.mul(x, boost)
    d = b.mul(b.trans("atan", b.mul(a, b.const(_PI4)), pol),
              b.const(_TWO_PI))
    mixed = b.add(b.mul(drive, d), b.mul(b.sub(b.const(1.0), drive), x))
    return b.where(_below(b, level), x, b.mul(mixed, level))


def chebyshev_asym(b, x, level_pos, level_neg, pol):
    """tanh(x * l) / tanh(l), l the level of x's side (x >= 0 positive),
    per-side bypass."""
    pos_side = b.ge(x, b.const(0.0))
    lv = b.where(pos_side, level_pos, level_neg)
    den = b.where(pos_side, _tanh(b, _safe_level(b, level_pos), pol),
                  _tanh(b, _safe_level(b, level_neg), pol))
    return b.where(_below(b, lv), x, b.div(_tanh(b, b.mul(x, lv), pol), den))


#: Distort's modes that are per-sample (Fuzz normalizes per block)
DISTORT_FORMS = {"HardClip": hard_clip, "SoftClip": soft_clip,
                 "Tanh": tanh_clip, "RecipSoftClip": recip_soft_clip,
                 "Sin": sin_shape, "Atan": atan_shape,
                 "Square": square_shape, "Chebyshev4": chebyshev4}

def shaper_form(fn):
    """The lowering of an ops/shaping function (a Distort mode or
    overdrive) as ``lower(b, x, *params, pol)``, or None when it is not
    per-sample (Fuzz)."""
    if fn is shaping.overdrive:
        return overdrive
    for mode, f in shaping.DISTORT_MODES.items():
        if f is fn:
            return DISTORT_FORMS.get(mode)
    return None


def node_form(cfg_name: str, select: dict):
    """(input ports, param names, lower) of a node that a group takes, or
    None: ``lower(b, ins, ps, pol)`` returns {output port: value}."""
    if cfg_name == "gain":
        return ("in",), ("level",), lambda b, i, p, pol: {
            "out": gain(b, i["in"], p["level"])}
    if cfg_name == "add":
        return ("a", "b"), (), lambda b, i, p, pol: {
            "out": add(b, i["a"], i["b"])}
    if cfg_name == "mix":
        return ("a", "b"), ("ratio",), lambda b, i, p, pol: {
            "out": mix(b, i["a"], i["b"], p["ratio"])}
    if cfg_name in ("overdrive", "distort") and str(
            select.get("oversample", "1")) != "1":
        return None
    if cfg_name == "overdrive":
        return ("in",), ("boost", "drive", "level"), lambda b, i, p, pol: {
            "out": overdrive(b, i["in"], p["boost"], p["drive"], p["level"],
                             pol)}
    if cfg_name == "chebyshev":
        return ("in",), ("level_pos", "level_neg"), lambda b, i, p, pol: {
            "out": chebyshev_asym(b, i["in"], p["level_pos"],
                                  p["level_neg"], pol)}
    if cfg_name == "distort":
        form = DISTORT_FORMS.get(select.get("mode"))
        if form is None:
            return None
        return ("in",), ("level",), lambda b, i, p, pol: {
            "out": form(b, i["in"], p["level"], pol)}
    return None


# -- the plain version -----------------------------------------------------

_TORCH_DTYPES = {"f32": torch.float32, "f64": torch.float64,
                 "bool": torch.bool}


def interpret(prog: Program, sigs, scals, T: int, device) -> list:
    """Run ``prog`` as PyTorch ops, one op at a time, on the signal
    operands ``sigs`` ([..., T] or [T] f32 tensors) and the scalar
    operands ``scals`` (0-d f32 tensors); returns its outputs.  Each op is
    the eager op the lowering mirrors, so under autograd its vjp is the
    eager ops' (ops/pointwise_kernel.PointwiseGroup's backward)."""
    vals: list = []
    for op, dt, args, imm in prog.ops:
        a = [vals[i] for i in args]
        if op == "sig":
            v = sigs[imm]
        elif op == "scal":
            v = scals[imm]
        elif op == "const":
            v = imm
        elif op == "zero":
            v = torch.zeros((T,), dtype=torch.float32, device=device)
        elif op == "add":
            v = a[0] + a[1]
        elif op == "sub":
            v = a[0] - a[1]
        elif op == "mul":
            v = a[0] * a[1]
        elif op == "div":
            v = div_ieee(a[0], a[1])
        elif op == "neg":
            v = -a[0]
        elif op == "abs":
            v = torch.abs(a[0])
        elif op == "sign":
            v = torch.sign(a[0])
        elif op == "lt":
            v = a[0] < a[1]
        elif op == "le":
            v = a[0] <= a[1]
        elif op == "gt":
            v = a[0] > a[1]
        elif op == "ge":
            v = a[0] >= a[1]
        elif op == "and":
            v = a[0] & a[1]
        elif op == "or":
            v = a[0] | a[1]
        elif op == "where":
            # a constant arm as a cached 0-d tensor (as the eager shapers
            # pass theirs): no host data is made
            c, x, y = (scalar_on(t, device, _TORCH_DTYPES[dt])
                       if isinstance(t, float) else t for t in a)
            v = torch.where(c, x, y)
        elif op == "clamp":
            v = torch.clamp(a[0], imm[0], imm[1])
        elif op == "f64":
            v = a[0].to(torch.float64)
        elif op == "f32":
            v = a[0].to(torch.float32)
        elif op in TRANSCENDENTALS:
            v = getattr(torch, op)(a[0])
        else:
            raise ValueError(f"pointwise: unknown op {op!r}")
        vals.append(v)
    return [vals[i] for i in prog.outs]


def shapes(prog: Program, sig_shapes, scal_shapes, T: int) -> list:
    """The shape of each value of ``prog`` (a broadcast of its operands',
    as the eager ops give it), for operands of the given shapes."""
    out: list = []
    for op, _, args, imm in prog.ops:
        if op == "sig":
            s = tuple(sig_shapes[imm])
        elif op == "scal":
            s = tuple(scal_shapes[imm])
        elif op == "const":
            s = ()
        elif op == "zero":
            s = (T,)
        else:
            s = tuple(torch.broadcast_shapes(*(out[i] for i in args)))
        out.append(s)
    return out
