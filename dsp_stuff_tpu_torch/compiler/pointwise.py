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
chebyshev_asym and the Distort modes, Fuzz's block maxima included):
each op of a program is one eager op, rounded once, so the interpreter
is bitwise the eager ops on the CPU, and the kernel (each op the same
single-rounded CUDA operation) bitwise them on the card.  One op is not
per sample: ``bmax``, the max of a value over its 128-sample block
(Fuzz's normalization, ``shaping.fuzz``), uniform over the block; the
kernel takes it as a warp reduction, each warp one block of a row.  A
divide is a true divide wherever the node code means one
(``precision.div_ieee``); a transcendental is f32 under ``fast`` and f64
rounded once to f32 under ``parity`` and ``exact`` (``shaping._trans``).

Operands are read, never baked in: ``sig`` k is the k-th signal operand
([..., T] or [T]), ``scal`` k the k-th scalar operand (a 0-d f32 tensor
in device memory: a slider, a level, a fan-in divisor).  Literal
constants are only the node code's own (0.5 of a map, the shapers' 2/pi,
the bypass threshold), so two groups of one structure are one program
whatever their sliders hold.

A group's backward is another straight-line program over the same IR,
:func:`adjoint`: the forward's values recomputed from the operands, then
autograd's formula for each eager op's vjp in reverse order, with a
``red`` op wherever autograd sums a gradient to a narrower operand's
shape (a block max's vjp by two more block ops, ``bsum`` and ``bcnt``).
The values' shapes enter through their *class* (:data:`CLASSES`): which
axes of the launch's [rows, T] a value spans, so the uniform part of the
backward is computed once, not once a sample.
:func:`interpret_adjoint` is its plain version; the reverse kernel
(ops/pointwise_reverse_kernel.py, csrc/pointwise_reverse_kernel.cu) runs
it on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import shaping
from dsp_stuff_tpu_torch.ops.shaping import BYPASS_EPS
from dsp_stuff_tpu_torch.utils.precision import div_ieee, scalar_on
from dsp_stuff_tpu_torch.utils.sums64 import block_sums64

#: every op of the IR: (operand count, result dtype or None for the
#: operands' dtype)
OPS = {
    "sig": (0, "f32"), "scal": (0, "f32"), "const": (0, None),
    "zero": (0, "f32"),
    "add": (2, None), "sub": (2, None), "mul": (2, None), "div": (2, None),
    "neg": (1, None), "abs": (1, None), "sign": (1, None),
    "lt": (2, "bool"), "le": (2, "bool"), "gt": (2, "bool"),
    "ge": (2, "bool"), "eq": (2, "bool"), "and": (2, "bool"),
    "or": (2, "bool"),
    "where": (3, None), "clamp": (1, None),
    "f64": (1, "f64"), "f32": (1, "f32"),
    "atan": (1, None), "tanh": (1, None), "sin": (1, None),
    "cos": (1, None), "exp": (1, None),
    # the max over the value's 128-sample block (NaN propagates), uniform
    # over the block: Fuzz's block maxima
    "bmax": (1, None),
    # the adjoint's own: the k-th output's cotangent, and a sum to a
    # narrower class (imm: (target class, source class)); bmax's vjp: the
    # sum of a value over its 128-sample block and the count of the
    # block's samples where two values are equal, each uniform over the
    # block
    "ct": (0, "f32"), "red": (1, None),
    "bsum": (1, None), "bcnt": (2, "f32"),
}
#: the ops that are not per sample but per 128-sample block
BLOCK_OPS = ("bmax", "bsum", "bcnt")
TRANSCENDENTALS = ("atan", "tanh", "sin", "cos", "exp")
#: the block of ``bmax`` (the reference's frame, node.rs:257)
BLOCK = 128

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

    def bmax(self, v: int) -> int:
        """torch.amax of ``v`` over each 128-sample block, broadcast back
        over the block.  ``v`` must be an ``abs``: its values are >= +0 or
        NaN, so the max has one value whatever the order it is taken in
        (NaN wherever the block holds one; which NaN is not defined)."""
        if self.ops[v][0] != "abs":
            raise ValueError("pointwise: bmax takes an abs value")
        return self._op("bmax", (v,))

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


def fuzz(b, x, level, pol):
    """ops/shaping.fuzz (no bypass), op for op, mx = max |x| of the
    block: q = clip(x * level) / mx; z = -(1 - exp(-|q|)); y = clip(z *
    mx) / max |z|; (y * mx) / max |y|.  An all-zero block is NaN (0 / 0,
    the reference's quirk); T must be a multiple of 128."""
    mx = b.bmax(b.abs(x))
    q = b.div(b.clamp(b.mul(x, level), -1.0, 1.0), mx)
    z = b.neg(b.sub(b.const(1.0), b.trans("exp", b.neg(b.abs(q)), pol)))
    y = b.div(b.clamp(b.mul(z, mx), -1.0, 1.0), b.bmax(b.abs(z)))
    return b.div(b.mul(y, mx), b.bmax(b.abs(y)))


#: Distort's modes that are per-sample (Fuzz normalizes per block:
#: :func:`fuzz`)
DISTORT_FORMS = {"HardClip": hard_clip, "SoftClip": soft_clip,
                 "Tanh": tanh_clip, "RecipSoftClip": recip_soft_clip,
                 "Sin": sin_shape, "Atan": atan_shape,
                 "Square": square_shape, "Chebyshev4": chebyshev4}


def has_bmax(prog) -> bool:
    """Whether a program holds a ``bmax`` (a group with Fuzz)."""
    return any(op == "bmax" for op, *_ in prog.ops)


def shaper_form(fn):
    """The lowering of an ops/shaping function (a Distort mode or
    overdrive) as ``lower(b, x, *params, pol)``."""
    if fn is shaping.overdrive:
        return overdrive
    if fn is shaping.fuzz:
        return fuzz
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
    if cfg_name == "distort" and select.get("mode") == "Fuzz":
        # Fuzz runs at the base rate whatever ``oversample`` says
        # (nodes/shapers.Distort)
        return ("in",), ("level",), lambda b, i, p, pol: {
            "out": fuzz(b, i["in"], p["level"], pol)}
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
    eager ops' (ops/pointwise_kernel.group_vjp, the autograd reference of
    a group's backward)."""
    vals: list = []
    for op, dt, args, imm in prog.ops:
        if op == "sig":
            vals.append(sigs[imm])
        elif op == "scal":
            vals.append(scals[imm])
        else:
            vals.append(_eval(op, dt, [vals[i] for i in args], imm, T,
                              device))
    return [vals[i] for i in prog.outs]


def _eval(op, dt, a, imm, T: int, device):
    """One op of a program as its eager PyTorch op."""
    if op == "const":
        return imm
    if op == "zero":
        return torch.zeros((T,), dtype=torch.float32, device=device)
    if op == "add":
        return a[0] + a[1]
    if op == "sub":
        return a[0] - a[1]
    if op == "mul":
        return a[0] * a[1]
    if op == "div":
        return div_ieee(a[0], a[1])
    if op == "neg":
        return -a[0]
    if op == "abs":
        return torch.abs(a[0])
    if op == "sign":
        return torch.sign(a[0])
    if op == "lt":
        return a[0] < a[1]
    if op == "le":
        return a[0] <= a[1]
    if op == "gt":
        return a[0] > a[1]
    if op == "ge":
        return a[0] >= a[1]
    if op == "eq":
        return a[0] == a[1]
    if op == "and":
        return a[0] & a[1]
    if op == "or":
        return a[0] | a[1]
    if op == "where":
        # a constant arm as a cached 0-d tensor (as the eager shapers
        # pass theirs): no host data is made
        c, x, y = (scalar_on(t, device, _TORCH_DTYPES[dt])
                   if isinstance(t, float) else t for t in a)
        return torch.where(c, x, y)
    if op == "clamp":
        return torch.clamp(a[0], imm[0], imm[1])
    if op == "f64":
        return a[0].to(torch.float64)
    if op == "f32":
        return a[0].to(torch.float32)
    if op in TRANSCENDENTALS:
        return getattr(torch, op)(a[0])
    if op == "bmax":
        # shaping.fuzz's torch.amax over [..., nb, 128], keepdim, spread
        # back over the block
        v = a[0]
        if v.dim() == 0 or v.shape[-1] != T or T % BLOCK:
            raise ValueError(f"pointwise: bmax of shape {tuple(v.shape)} "
                             f"needs [..., T] with T % {BLOCK} == 0, T={T}")
        vb = v.reshape(*v.shape[:-1], T // BLOCK, BLOCK)
        return torch.amax(vb, dim=-1, keepdim=True).expand(
            vb.shape).reshape(v.shape)
    if op == "bcnt":
        # amax's backward: the count of its ties, mask.sum(dim, keepdim)
        eq = _blocks(a[0] == a[1], T)
        return eq.sum(-1, keepdim=True).to(torch.float32).expand(
            eq.shape).reshape(eq.shape[:-2] + (T,))
    raise ValueError(f"pointwise: unknown op {op!r}")


def _blocks(v, T: int):
    """``v`` [..., T] as [..., T / 128, 128]."""
    if v.dim() == 0 or v.shape[-1] != T or T % BLOCK:
        raise ValueError(f"pointwise: a block op of shape {tuple(v.shape)} "
                         f"needs [..., T] with T % {BLOCK} == 0, T={T}")
    return v.reshape(*v.shape[:-1], T // BLOCK, BLOCK)


def _bsum(v, T: int, sums64: bool):
    """The sum of ``v`` over each 128-sample block, spread back over it
    (the expand's backward of bmax's vjp): autograd's f32 sum, or with
    ``sums64`` the reverse kernel's (pointwise_ops.cuh pw_bsum,
    utils/sums64.block_sums64), rounded once."""
    vb = _blocks(v, T)
    if not sums64:
        return vb.sum(-1, keepdim=True).expand(vb.shape).reshape(v.shape)
    s = block_sums64(v, BLOCK).to(vb.dtype)
    return s.unsqueeze(-1).expand(vb.shape).reshape(v.shape)


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


# -- the adjoint --------------------------------------------------------------
# A value's class says which axes of the launch's iteration shape [rows, T]
# it spans: "U" neither (a slider, a constant), "R" the rows alone (a
# [..., 1] operand), "C" the time alone (an unbatched [T] signal: an LFO, a
# map of one), "F" both.  A class is the union of its operands' (the
# broadcast), and autograd sums a gradient wherever a consumer's class is
# wider than its operand's.

#: the classes, by their bits (1: the rows, 2: the time)
CLASSES = ("U", "R", "C", "F")


def join(*classes) -> str:
    """The class of a broadcast of values of ``classes``."""
    bits = 0
    for c in classes:
        bits |= CLASSES.index(c)
    return CLASSES[bits]


def class_shape(c: str, rows: int, T: int) -> tuple:
    """The 2-D shape of a value of class ``c`` in a [rows, T] launch."""
    bits = CLASSES.index(c)
    return (rows if bits & 1 else 1, T if bits & 2 else 1)


class Adjoint(NamedTuple):
    """A group's backward as one straight-line program (:func:`adjoint`):
    ``ops`` as in :class:`Program`, with ``ct`` (imm k: the k-th output's
    cotangent), ``cos`` and ``red`` (imm (target, source): the sum of its
    operand, broadcast to the source class, over the axes the target
    class lacks, as autograd sums a consumer's gradient to its operand's
    shape); ``cls`` each value's class; ``grads`` each operand's gradient
    (signals, then scalars) as a value id, or None where it gets none
    (not needed, or no cotangent reaches it); the operand counts, and the
    classes the operands were given (``classes``).  Hashable: a build is
    keyed on it."""
    ops: tuple
    cls: tuple
    grads: tuple
    n_sig: int
    n_scal: int
    n_ct: int
    classes: tuple


class _AdjointBuilder(Builder):
    """A Builder that tracks each value's class."""

    def __init__(self, classes, ct_classes):
        super().__init__()
        self.cls: list = []
        self._classes = classes
        self._ct_classes = ct_classes

    def _op(self, op: str, args: tuple = (), imm=None, dtype=None) -> int:
        n = len(self.ops)
        got = super()._op(op, args, imm, dtype)
        if got == n:
            if op == "sig":
                c = self._classes[imm]
            elif op == "ct":
                c = self._ct_classes[imm]
            elif op == "red":
                c = imm[0]
            elif op == "zero":
                c = "C"
            else:
                c = join("U", *(self.cls[a] for a in args))
            self.cls.append(c)
        return got


#: ops whose results carry no gradient
_NO_GRAD = ("lt", "le", "gt", "ge", "and", "or", "const", "zero")


def adjoint(prog: Program, need: tuple, has_ct: tuple,
            classes: tuple) -> Adjoint:
    """The backward of ``prog``: the gradients of the operands that
    ``need`` one (a bool each, signals then scalars) from the cotangents of
    the outputs that ``has_ct`` (a missing cotangent is zero and adds no
    op), the operands of ``classes`` (each signal's class; scalars are
    "U").

    It recomputes every forward value it uses from the operands (nothing
    else is saved), then walks the ops backwards; each op's vjp is
    autograd's formula for its eager op, in the op's dtype: mul g*b, g*a;
    add g, g; sub g, -g; div g / b and -g * ((a / b) / b), but 1 / b (the
    eager ``c / b``, reciprocal(b) * c) -(g * c) * (r * r); abs g *
    sgn(x); sign +0; where where(c, g, 0), where(c, 0, g); clamp
    where(lo <= x <= hi, g, 0); tanh g * (1 - y * y) from its output; atan
    g / (x * x + 1); sin g * cos(x); a cast the cast back.  A value with
    several uses adds its contributions in the order autograd's engine
    does: the cotangents first (in output order), then the latest consumer
    first.  Adjoints flow only into values that depend on a needed
    operand (as autograd builds no node for the rest), so no 0 * inf
    appears where autograd computes nothing.  A consumer whose class is
    wider than its operand's sums its contribution with a ``red`` op;
    above it the chain runs at the operand's class.  Values no needed
    gradient depends on are dropped.  A block max m = bmax(v) (Fuzz)
    takes autograd's ``amax(keepdim).expand`` backward: the expand's sum
    of g over the block, S = bsum(g), then amax's (S / count) * mask with
    mask = (v == m) and count = bcnt(v, m) its ties (a multiply by the
    mask, not a where: a NaN or inf S, or a NaN block's count of 0, makes
    every sample of the block NaN)."""
    n_sig, n_scal = prog.n_sig, prog.n_scal
    classes = tuple(classes[:n_sig]) + ("U",) * n_scal
    fc: list = []               # the forward values' classes
    rg: list = []               # ... and whether they carry a gradient
    for op, dt, args, imm in prog.ops:
        if op == "sig":
            fc.append(classes[imm])
            rg.append(bool(need[imm]))
        elif op == "scal":
            fc.append("U")
            rg.append(bool(need[n_sig + imm]))
        else:
            fc.append("C" if op == "zero" else
                      join("U", *(fc[a] for a in args)))
            rg.append(op not in _NO_GRAD and dt != "bool"
                      and any(rg[a] for a in args))
    b = _AdjointBuilder(classes, tuple(fc[o] for o in prog.outs))
    fwd: dict = {}

    def val(i):
        """Forward value i, recomputed in the adjoint program."""
        if i not in fwd:
            op, dt, args, imm = prog.ops[i]
            fwd[i] = b._op(op, tuple(val(a) for a in args), imm, dt)
        return fwd[i]

    # every operand, in order (so the ids of sig k and scal k are fixed)
    for i, (op, _, _, _) in enumerate(prog.ops):
        if op in ("sig", "scal"):
            val(i)
    adj: list = [None] * len(prog.ops)

    def give(v, c, consumer):
        """Add contribution ``c`` (of the consumer's class) to value v's
        adjoint, summed to v's class first where the consumer's is
        wider."""
        src = fc[consumer] if consumer is not None else fc[v]
        if src != fc[v]:
            c = b._op("red", (c,), (fc[v], src), prog.ops[v][1])
        adj[v] = c if adj[v] is None else b.add(adj[v], c)

    for k, o in enumerate(prog.outs):
        if has_ct[k] and rg[o]:
            give(o, b._op("ct", imm=k), None)
    for i in range(len(prog.ops) - 1, -1, -1):
        op, dt, args, imm = prog.ops[i]
        g = adj[i]
        if g is None or not rg[i] or op in ("sig", "scal"):
            continue
        for pos, c in _vjp(b, val, prog, i, g):
            if rg[args[pos]]:
                give(args[pos], c(), i)
    grads = []
    for i, (op, _, _, imm) in enumerate(prog.ops):
        if op == "sig":
            grads.append((imm, adj[i]))
        elif op == "scal":
            grads.append((n_sig + imm, adj[i]))
    grads = tuple(g if need[k] else None for k, g in sorted(grads))
    return _live(b, grads, n_sig, n_scal, len(prog.outs), classes)


def _vjp(b, val, prog, i, g):
    """[(operand position, contribution thunk)] of op i's vjp with
    adjoint ``g``: autograd's formula of the eager op (a thunk, so that a
    position that carries no gradient adds no op)."""
    op, dt, args, imm = prog.ops[i]
    ops = prog.ops
    zero = lambda: b.const(0.0, dt)                      # noqa: E731
    one = lambda: b.const(1.0, dt)                       # noqa: E731
    x = lambda k: val(args[k])                           # noqa: E731
    if op == "add":
        return [(0, lambda: g), (1, lambda: g)]
    if op == "sub":
        return [(0, lambda: g), (1, lambda: b.neg(g))]
    if op == "mul":
        return [(0, lambda: b.mul(g, x(1))), (1, lambda: b.mul(g, x(0)))]
    if op == "div":
        if ops[args[0]][0] == "const":
            # ``c / b`` is reciprocal(b) * c: MulBackward by c (exact at 1),
            # then ReciprocalBackward -grad * (r * r)
            def recip():
                c = ops[args[0]][3]
                gr = g if c == 1.0 else b.mul(g, x(0))
                r = val(i) if c == 1.0 else b.div(one(), x(1))
                return b.mul(b.neg(gr), b.mul(r, r))
            return [(1, recip)]
        return [(0, lambda: b.div(g, x(1))),
                (1, lambda: b.mul(b.neg(g), b.div(val(i), x(1))))]
    if op == "neg":
        return [(0, lambda: b.neg(g))]
    if op == "abs":
        return [(0, lambda: b.mul(g, b.sign(x(0))))]
    if op == "sign":
        return [(0, zero)]
    if op == "where":
        return [(1, lambda: b.where(x(0), g, zero())),
                (2, lambda: b.where(x(0), zero(), g))]
    if op == "clamp":
        lo, hi = imm
        return [(0, lambda: b.where(b.and_(b.ge(x(0), b.const(lo, dt)),
                                           b.le(x(0), b.const(hi, dt))),
                                    g, zero()))]
    if op == "tanh":
        return [(0, lambda: b.mul(g, b.sub(one(), b.mul(val(i), val(i)))))]
    if op == "atan":
        return [(0, lambda: b.div(g, b.add(b.mul(x(0), x(0)), one())))]
    if op == "sin":
        return [(0, lambda: b.mul(g, b._op("cos", (x(0),))))]
    if op == "exp":
        return [(0, lambda: b.mul(g, val(i)))]
    if op == "f64":
        return [(0, lambda: b._op("f32", (g,)))]
    if op == "f32":
        return [(0, lambda: b._op("f64", (g,)))]
    if op == "bmax":
        def amax_vjp():
            v, m = x(0), val(i)
            mask = b.where(b._op("eq", (v, m)), one(), zero())
            return b.mul(b.div(b._op("bsum", (g,)),
                               b._op("bcnt", (v, m))), mask)
        return [(0, amax_vjp)]
    raise ValueError(f"pointwise adjoint: no vjp for op {op!r}")


def _live(b, grads, n_sig, n_scal, n_ct, classes) -> Adjoint:
    """The adjoint program of builder ``b`` computing ``grads``: dead ops
    dropped (the operands and cotangents kept, so their indices hold) and
    the values renumbered in order."""
    live = set()
    stack = [g for g in grads if g is not None]
    while stack:
        v = stack.pop()
        if v not in live:
            live.add(v)
            stack.extend(b.ops[v][2])
    new: dict = {}
    ops, cls = [], []
    for i, (op, dt, args, imm) in enumerate(b.ops):
        if i in live or op in ("sig", "scal"):
            new[i] = len(ops)
            ops.append((op, dt, tuple(new[a] for a in args), imm))
            cls.append(b.cls[i])
    return Adjoint(tuple(ops), tuple(cls),
                   tuple(None if g is None else new[g] for g in grads),
                   n_sig, n_scal, n_ct, tuple(classes))


def class_of(shape, F) -> str:
    """The class of an operand of ``shape`` in the iteration shape ``F``
    (its last axis T): it spans the rows where its batch is F's (so every
    operand does in a one-row launch), and the time where its last axis is
    T; one that spans part of the batch is taken as spanning all of it
    (the wrapper expands it)."""
    lead = (1,) * (len(F) - len(shape)) + tuple(shape)
    n = int(np.prod(lead[:-1], dtype=np.int64))
    rows = n > 1 or int(np.prod(F[:-1], dtype=np.int64)) == 1
    return CLASSES[int(rows) | int(lead[-1] == F[-1]) << 1]


def interpret_adjoint(adj: Adjoint, sigs, scals, cts, rows: int, T: int,
                      device, sums64: bool = False) -> list:
    """Run the adjoint program ``adj`` as PyTorch ops on the operands laid
    out as 2-D tensors of their classes' shapes (``class_shape``: each
    signal [rows or 1, T or 1], each scalar 0-d or [1, 1]) and the
    cotangents likewise (None where ``adj`` reads none): the per-element
    ops as the eager ops, each ``red`` as ``sum_to_size`` of its operand
    broadcast to its source class (autograd's sum of a consumer's
    gradient), and the reduced tail after it; the block ops over [...,
    T / 128, 128]; with ``sums64`` each sum in float64, rounded once to
    its dtype, as the reverse kernel takes it.
    Returns each operand's gradient at its class's 2-D shape, or None.
    The reverse kernel's plain version (ops/pointwise_kernel.
    group_adjoint)."""
    keep = {g for g in adj.grads if g is not None}
    last: dict = {}                 # each value's last use, to free it
    for i, (_, _, args, _) in enumerate(adj.ops):
        for a in args:
            last[a] = i
    vals: list = []
    for i, (op, dt, args, imm) in enumerate(adj.ops):
        a = [vals[j] for j in args]
        if op == "sig":
            v = sigs[imm]
        elif op == "scal":
            v = scals[imm]
        elif op == "ct":
            v = cts[imm]
        elif op == "red":
            t = (scalar_on(a[0], device, _TORCH_DTYPES[dt])
                 if isinstance(a[0], float) else a[0])
            t = t.expand(class_shape(imm[1], rows, T))
            v = (t.double().sum_to_size(class_shape(imm[0], rows, T)).to(
                t.dtype) if sums64 else t.sum_to_size(
                    class_shape(imm[0], rows, T)))
        elif op == "bsum":
            v = _bsum(a[0].expand(class_shape(adj.cls[i], rows, T)), T,
                      sums64)
        elif op in ("bmax", "bcnt"):
            v = _eval(op, dt, [t.expand(class_shape(adj.cls[i], rows, T))
                               for t in a], imm, T, device)
        else:
            v = _eval(op, dt, a, imm, T, device)
        vals.append(v)
        for j in args:
            if last[j] == i and j not in keep:
                vals[j] = None
    out = []
    for k, g in enumerate(adj.grads):
        if g is None:
            out.append(None)
            continue
        v = vals[g]
        if isinstance(v, float):
            v = scalar_on(v, device, _TORCH_DTYPES[adj.ops[g][1]])
        out.append(v.expand(class_shape(adj.classes[k], rows, T)))
    return out
