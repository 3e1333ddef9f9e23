"""Wrapper of the pointwise kernel (csrc/pointwise_kernel.cu): generate,
build, bind, launch, and the dispatch of a pointwise group.

A group is a :class:`compiler.pointwise.Program` over signal operands
([..., T] or [T] f32) and scalar operands (0-d f32 tensors).  On the card
:func:`source` writes the program as straight-line CUDA (a header the
kernel includes), ops/cuda_build.py builds it once per program with
``nvcc`` at first use, and :func:`_kernel_group` launches it on the current
stream; on the CPU :func:`group_call` runs the plain version,
``pointwise.interpret``, and only because the operands lie on the CPU.  A
CUDA operand goes to the kernel or raises: there is no fallback.  Nothing
is imported, built or loaded when this module is imported.

The source names operands by index and never holds their values (the
build is keyed on the program, its structure), so a moved slider, a fit
step or another group of one structure builds nothing.  Every scalar
operand is read from device memory by its pointer; the tensors a launch
reads come from device caches (``precision.scalar_on``, a slider's
``Data.on``) that hold them for a capture underway (utils/capture.hold),
and the outputs are allocated on the current stream's pool, so the launch
records into a captured stream step as it is.

Under autograd (an operand that requires grad) the launch runs inside
:class:`PointwiseGroup`: the kernel forward, and on the card the reverse
kernel backward (ops/pointwise_reverse_kernel.py: the group's adjoint
program, compiler/pointwise.adjoint, recomputed from the saved operands in
registers).  Its plain version is :func:`group_adjoint`;
:func:`group_vjp`, autograd through the plain interpreter, is the
reference of the route it replaced (as ``segment_vjp`` is the chain
segment's) and the Function's backward where none is given.  A group
with Fuzz (a program with ``bmax``) takes the reverse kernel's staged
build, every signal operand spanning the launch's rows and time (one of
a narrower class is expanded and its gradient summed back).
``LAUNCHES`` counts the kernel's launches.

A program with ``bmax`` is generated in stages (:func:`source`): the
values up to a block max for a thread's four samples, the max as a warp
reduction (the warp's 32 lanes x 4 samples are one 128-sample block of a
row when T % 128 == 0), then the rest.  It launches only the float4
build, with T % 128 == 0 (anything else raises); a signal operand whose
row starts are not 16-byte aligned is copied to an aligned buffer first.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dsp_stuff_tpu_torch.compiler import pointwise
from dsp_stuff_tpu_torch.ops import cuda_build
from dsp_stuff_tpu_torch.ops.chain_segment import fresh, grads_of
from dsp_stuff_tpu_torch.ops.scan import needs_grad
from dsp_stuff_tpu_torch.utils.precision import get_policy, on_device
from dsp_stuff_tpu_torch.utils.sums64 import sum_to64

#: launches of the kernel in this process (a test or a smoke run resets it)
LAUNCHES = 0

# Launch geometry, mirrored by csrc/pointwise_kernel.cu (PW_THREADS, PW_V)
THREADS = 256
V = 4
#: the grid's limits (CUDA's): x over a row's units, y over the rows; the
#: kernel's grid-stride loops cover what they leave
MAX_GRID_X = 2**31 - 1
MAX_GRID_Y = 65535

_CT = {"f32": "float", "f64": "double", "bool": "bool"}
_BIN = {"add": "add", "sub": "sub", "mul": "mul", "div": "div"}
_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
        "and": "&&", "or": "||"}


def _lit(v: float, dt: str) -> str:
    """``v`` as an exact CUDA literal of dtype ``dt``."""
    if dt == "f64":
        f = float(v)
        return f"__longlong_as_double({int(np.float64(f).view(np.int64))}LL)" \
            if not np.isfinite(f) else f.hex()
    f = np.float32(v)
    if not np.isfinite(f):
        return f"__int_as_float({int(f.view(np.int32))})"
    return f"{float(f).hex()}f"


def c_expr(op: str, dt: str, a: list, imm) -> str:
    """The CUDA expression of one op of a program (not an operand) on the
    expressions ``a`` of its operands: each f32 (f64) arithmetic op its
    ``__f*_rn`` (``__d*_rn``) intrinsic, rounded once as the eager op."""
    if op == "const":
        return _lit(imm, dt)
    if op == "zero":
        return "0.0f"
    if op in _BIN:
        return f"__{'f' if dt == 'f32' else 'd'}{_BIN[op]}_rn({a[0]}, {a[1]})"
    if op in _CMP:
        return f"({a[0]} {_CMP[op]} {a[1]})"
    if op == "neg":
        return f"(-{a[0]})"
    if op == "abs":
        return f"fabs{'f' if dt == 'f32' else ''}({a[0]})"
    if op == "sign":
        return f"pw_sign({a[0]})"
    if op == "where":
        return f"({a[0]} ? {a[1]} : {a[2]})"
    if op == "clamp":
        return f"pw_clamp({a[0]}, {_lit(imm[0], dt)}, {_lit(imm[1], dt)})"
    if op == "f64":
        return f"(double){a[0]}"
    if op == "f32":
        return f"__double2float_rn({a[0]})"
    if op in pointwise.TRANSCENDENTALS:
        return f"{op}{'f' if dt == 'f32' else ''}({a[0]})"
    raise ValueError(f"pointwise kernel: unknown op {op!r}")


@functools.lru_cache(maxsize=256)
def source(prog: pointwise.Program) -> str:
    """The generated header of the kernel for ``prog``: the operand counts,
    ``PwUniform`` and ``pw_uniform`` (the values of scalar operands and
    constants alone, once a thread) and ``pw_point`` (one element: signal
    operand k in x[k], output k to y[k]), one statement per op in the
    program's order, each f32 operation one __f*_rn intrinsic.  No operand
    value appears in it.  A program with ``bmax`` gets ``pw_block`` in
    place of ``pw_point`` (:func:`_staged`)."""
    uniform: list[bool] = []
    for op, _, args, _ in prog.ops:
        uniform.append(op in ("scal", "const") or (
            bool(args) and all(uniform[a] for a in args)))
    staged = pointwise.has_bmax(prog)
    ref = [f"U.v{i}" if u else (f"v{i}[i]" if staged else f"v{i}")
           for i, u in enumerate(uniform)]

    def expr(op, dt, args, imm) -> str:
        a = [ref[i] for i in args]
        if op == "sig":
            return f"x[i][{imm}]" if staged else f"x[{imm}]"
        if op == "scal":
            return f"*s[{imm}]"
        if op == "div" and uniform[args[1]] and not uniform[args[0]]:
            # a divisor of scalars alone stays at its use (pw_fresh)
            a[1] = f"pw_fresh({a[1]})"
        return c_expr(op, dt, a, imm)

    fields = [f"  {_CT[dt]} v{i};" for i, (_, dt, _, _) in enumerate(prog.ops)
              if uniform[i]]
    pre = [f"  U.v{i} = {expr(*o)};" for i, o in enumerate(prog.ops)
           if uniform[i]]
    if staged:
        point = _staged(prog, uniform, ref, expr)
    else:
        body = [f"  const {_CT[o[1]]} v{i} = {expr(*o)};"
                for i, o in enumerate(prog.ops) if not uniform[i]]
        body += [f"  y[{k}] = {ref[v]};" for k, v in enumerate(prog.outs)]
        point = ["__device__ __forceinline__ void pw_point("
                 "const PwUniform& U,", "    const float* x, float* y) {",
                 *body, "}"]
    return "\n".join([
        "// generated by ops/pointwise_kernel.py:source",
        f"#define PW_NSIG {prog.n_sig}",
        f"#define PW_NSCAL {prog.n_scal}",
        f"#define PW_NOUT {len(prog.outs)}",
        *(["#define PW_STAGED 1"] if staged else []),
        "struct PwUniform {", *(fields or ["  int none;"]), "};",
        "__device__ __forceinline__ PwUniform pw_uniform(",
        "    const float* const* s) {",
        "  PwUniform U;", *pre, "  return U;", "}", *point, ""])


def _staged(prog, uniform, ref, expr) -> list:
    """``pw_block`` of a program with ``bmax``: a thread's V samples at
    once, each per-sample value an array of V (value j of sample i is
    vj[i]), the program's ops in order in stages, each stage one loop over
    the samples, and between two stages a ``bmax`` as ``pw_bmax`` (the
    max over the thread's samples, then over the warp by shuffles: the
    warp's block), its operand's stage finished for every sample first;
    the outputs from the last stage."""
    decl = [f"  {_CT[dt]} v{i}[{V}];" for i, (_, dt, _, _) in
            enumerate(prog.ops) if not uniform[i]]
    loop = ["#pragma unroll", f"  for (int i = 0; i < {V}; ++i) {{"]
    body = list(loop)
    for i, o in enumerate(prog.ops):
        if uniform[i]:
            continue
        if o[0] == "bmax":
            if uniform[o[2][0]]:
                raise ValueError("pointwise kernel: bmax of a uniform value")
            body += ["  }", f"  pw_bmax(v{i}, v{o[2][0]});", *loop]
            continue
        body.append(f"    v{i}[i] = {expr(*o)};")
    body += [f"    y[i][{k}] = {ref[v]};" for k, v in enumerate(prog.outs)]
    body.append("  }")
    return ["template <int NS, int NO>",
            "__device__ __forceinline__ void pw_block(const PwUniform& U,",
            f"    const float (&x)[{V}][NS], float (&y)[{V}][NO]) {{", *decl,
            *body, "}"]


@functools.lru_cache(maxsize=64)
def _lib(src: str, counts: int) -> ctypes.CDLL:
    """The kernel library for the generated ``src``, bound, its operand
    counts checked against ``counts``."""
    lib = cuda_build.load("pointwise_kernel", (), src)
    lib.pointwise_kernel_counts.argtypes = []
    lib.pointwise_kernel_counts.restype = ctypes.c_int
    p = ctypes.c_void_p
    lib.pointwise_kernel_launch.argtypes = [
        p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    lib.pointwise_kernel_launch.restype = ctypes.c_int
    if lib.pointwise_kernel_counts() != counts:
        raise RuntimeError(f"pointwise kernel built for operand counts "
                           f"{lib.pointwise_kernel_counts():#x}, the "
                           f"program's {counts:#x}")
    return lib


def _counts(prog) -> int:
    return prog.n_sig | prog.n_scal << 10 | len(prog.outs) << 20


@functools.lru_cache(maxsize=1024)
def layout(prog: pointwise.Program, sig_shapes: tuple, scal_shapes: tuple,
           T: int):
    """(F, rows, out_shapes) of a launch: the iteration shape F (the
    outputs' broadcast, last dim T) as [rows, T], and each output's shape
    as the eager ops would give it."""
    vals = pointwise.shapes(prog, sig_shapes, scal_shapes, T)
    out_shapes = tuple(vals[v] for v in prog.outs)
    F = tuple(torch.broadcast_shapes(*out_shapes, (T,)))
    if F[-1] != T:
        raise ValueError(f"pointwise kernel: outputs {out_shapes} do not "
                         f"end in T={T}")
    return F, int(np.prod(F[:-1], dtype=np.int64)), out_shapes


def _batch(shape, F) -> str:
    """How an operand of ``shape`` spans the batch of F: "full", "none"
    (one row for all) or "part" (it must be expanded)."""
    lead = (1,) * (len(F) - len(shape)) + tuple(shape)
    n = math.prod(lead[:-1])
    if n == 1:
        return "none"
    return "full" if tuple(lead[:-1]) == tuple(F[:-1]) else "part"


class Launch(NamedTuple):
    """What a launch reads and writes: each signal operand as a [rows or
    1, T or 1] tensor with its batch and time strides (``sb``, ``st``),
    the scalar operands, the output buffers with their batch strides
    (``osb``: T, or 0 when row 0 alone writes it) and the views of them
    that are the outputs, the rows, T, the float4 build's choice and the
    grid (x over a row's units, y over the rows)."""
    sigs: list
    sb: list
    st: list
    scals: list
    bufs: list
    osb: list
    outs: list
    rows: int
    T: int
    vec: bool
    grid: tuple


def plan_launch(prog: pointwise.Program, sigs, scals, T: int,
                device) -> Launch:
    """Lay out a launch of ``prog`` on its operands (f32 tensors on
    ``device``; the tests run it on the CPU): the iteration shape [rows,
    T], each operand's strides in it (an operand whose batch is neither
    the whole nor none of it is expanded), the outputs allocated,
    whether every row start of a signal read in float4 pieces and of an
    output is 16-byte aligned (the float4 build), and the grid: y the
    row, x the row's units, one unit a thread."""
    for t in (*sigs, *scals):
        if (not isinstance(t, torch.Tensor) or t.device != device
                or t.dtype != torch.float32):
            got = (f"{t.dtype} on {t.device}" if isinstance(t, torch.Tensor)
                   else type(t).__name__)
            raise ValueError(f"pointwise kernel: operands must be float32 "
                             f"tensors on {device}, got {got}")
    for t in scals:
        if t.numel() != 1:
            raise ValueError(f"pointwise kernel: a scalar operand has shape "
                             f"{tuple(t.shape)}")
    for s in sigs:
        if s.dim() == 0 or s.shape[-1] not in (T, 1):
            raise ValueError(f"pointwise kernel: signal operand of shape "
                             f"{tuple(s.shape)} for T={T}")
    F, rows, out_shapes = layout(prog, tuple(s.shape for s in sigs),
                                 tuple(s.shape for s in scals), T)
    sig2, sbs, sts = [], [], []
    for s in sigs:
        span = _batch(s.shape, F)
        if span == "none":
            s2 = s.reshape(1, s.shape[-1])
        elif span == "full":
            s2 = s.reshape(rows, s.shape[-1])
        else:
            s2 = s.expand(F).reshape(rows, T)
        if s2.shape[-1] == T and s2.stride(-1) != 1:
            s2 = s2.contiguous()
        sig2.append(s2)
        sbs.append(s2.stride(0) if span != "none" else 0)
        sts.append(1 if s2.shape[-1] == T else 0)
    bufs, outs, osbs = [], [], []
    for shp in out_shapes:
        span = _batch(shp, F)
        if span == "part":
            full = torch.empty(F, dtype=torch.float32, device=device)
            lead = (1,) * (len(F) - len(shp)) + tuple(shp)
            idx = tuple(slice(0, 1) if a == 1 and f != 1 else slice(None)
                        for a, f in zip(lead, F))
            bufs.append(full)
            outs.append(full[idx].reshape(shp))
        else:
            y = torch.empty(shp, dtype=torch.float32, device=device)
            bufs.append(y)
            outs.append(y)
        osbs.append(0 if span == "none" else T)
    staged = pointwise.has_bmax(prog)
    if staged and T % pointwise.BLOCK:
        raise ValueError(f"pointwise kernel: a program with bmax (Fuzz) "
                         f"needs T % {pointwise.BLOCK} == 0, got T={T}")
    if staged:
        # the float4 build alone takes the block max: an operand whose row
        # starts are not 16-byte aligned is copied to a fresh buffer
        for k, (s, sb, st) in enumerate(zip(sig2, sbs, sts)):
            if st and (s.data_ptr() % 16 or sb % V):
                sig2[k] = s.clone(memory_format=torch.contiguous_format)
                sbs[k] = sig2[k].stride(0) if sb else 0
    vec = (all(s.data_ptr() % 16 == 0 and sb % V == 0
               for s, sb, st in zip(sig2, sbs, sts) if st)
           and all(y.data_ptr() % 16 == 0 and sb % V == 0
                   for y, sb in zip(bufs, osbs)))
    if staged and not vec:
        raise ValueError("pointwise kernel: a program with bmax (Fuzz) runs "
                         "only the float4 build, and a row start is not "
                         "16-byte aligned")
    upr = -(-T // V) if vec else T
    gx = max(1, min(-(-upr // THREADS), MAX_GRID_X))
    gy = min(rows, MAX_GRID_Y)
    return Launch(sig2, sbs, sts, list(scals), bufs, osbs, outs, rows, T,
                  vec, (gx, gy))


def _kernel_group(prog: pointwise.Program, sigs, scals, T: int, device):
    """Launch the kernel of ``prog`` on the operands (every one a CUDA f32
    tensor on ``device``); returns its outputs, each of the shape the
    eager ops give it."""
    global LAUNCHES
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"pointwise kernel: no kernel for device {device}")
    if not prog.outs:
        return []
    ln = plan_launch(prog, sigs, scals, T, device)

    def arr(ty, xs):
        return ctypes.cast((ty * max(1, len(xs)))(*xs), ctypes.c_void_p)

    u64, i64 = ctypes.c_ulonglong, ctypes.c_longlong
    rc = _lib(source(prog), _counts(prog)).pointwise_kernel_launch(
        arr(u64, [s.data_ptr() for s in ln.sigs]), arr(i64, ln.sb),
        arr(ctypes.c_int, ln.st), arr(u64, [t.data_ptr() for t in ln.scals]),
        arr(u64, [y.data_ptr() for y in ln.bufs]), arr(i64, ln.osb),
        ln.rows, ln.T, int(ln.vec), *ln.grid, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pointwise kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return ln.outs


class AdjointPlan(NamedTuple):
    """A group's backward laid out (:func:`plan_adjoint`): its adjoint
    program, the iteration shape F as [rows, T], each operand and
    cotangent as a 2-D tensor of its class's shape (``pointwise.
    class_shape``; a cotangent the program reads no None) and each
    operand's shape and class, to shape its gradient back."""
    adj: pointwise.Adjoint
    F: tuple
    rows: int
    T: int
    sigs: list
    scals: list
    cts: list
    shapes: tuple
    classes: tuple


def _batch_of(c: str, F: tuple) -> tuple:
    """The batch axes of a value of class ``c`` in the iteration shape F."""
    return (tuple(F[:-1]) if pointwise.CLASSES.index(c) & 1
            else (1,) * (len(F) - 1))


def _to_class(t, c: str, F: tuple, rows: int, T: int) -> torch.Tensor:
    """``t`` (broadcastable to F) as the 2-D tensor of class ``c``: a
    view where its layout allows, expanded over F's batch where it spans
    part of it."""
    lead = (1,) * (len(F) - t.dim()) + tuple(t.shape)
    return t.reshape(lead).expand(*_batch_of(c, F), lead[-1]).reshape(
        pointwise.class_shape(c, rows, T))


def _from_class(g, shape, c: str, F: tuple) -> torch.Tensor:
    """A 2-D gradient of class ``c`` as its operand's ``shape``: summed
    (in float64, rounded once) over the batch or the time an operand that
    spans part of it was expanded to."""
    return sum_to64(g.reshape(*_batch_of(c, F), g.shape[-1]), shape)


@functools.lru_cache(maxsize=1024)
def adjoint_of(prog: pointwise.Program, need: tuple, has_ct: tuple,
               classes: tuple) -> pointwise.Adjoint:
    """``pointwise.adjoint``, once per (program, need, cotangents,
    classes)."""
    return pointwise.adjoint(prog, need, has_ct, classes)


def plan_adjoint(prog: pointwise.Program, sigs, scals, cts, need,
                 T: int) -> AdjointPlan:
    """Lay out the backward of ``prog`` on its operands and the cotangents
    of its outputs (None: no cotangent) for the operands that ``need`` a
    gradient: the forward's iteration shape, each signal's class, the
    adjoint program and the 2-D tensors it reads.  A program with ``bmax``
    takes every signal as spanning the rows and the time (class "F"), so
    that its block ops run in the reverse kernel's full world."""
    F, rows, out_shapes = layout(prog, tuple(s.shape for s in sigs),
                                 tuple(s.shape for s in scals), T)
    classes = tuple("F" if pointwise.has_bmax(prog)
                    else pointwise.class_of(s.shape, F) for s in sigs)
    adj = adjoint_of(prog, tuple(bool(n) for n in need),
                     tuple(c is not None for c in cts), classes)
    read = {imm for op, _, _, imm in adj.ops if op == "ct"}
    ct2 = [_to_class(c, pointwise.class_of(out_shapes[k], F), F, rows, T)
           if k in read else None for k, c in enumerate(cts)]
    sig2 = [_to_class(s, c, F, rows, T) for s, c in zip(sigs, classes)]
    return AdjointPlan(adj, F, rows, T, sig2, list(scals), ct2,
                       tuple(tuple(t.shape) for t in (*sigs, *scals)),
                       classes + ("U",) * len(scals))


def shaped_grads(pl: AdjointPlan, grads) -> list:
    """The 2-D gradients of a plan as its operands' shapes (None stays)."""
    return [None if g is None else _from_class(g, shape, c, pl.F)
            for g, shape, c in zip(grads, pl.shapes, pl.classes)]


def group_adjoint(prog: pointwise.Program, sigs, scals, cts, need,
                  T: int, device, sums64: bool = False) -> list:
    """The reverse kernel's plain version: the gradients of the operands
    that ``need`` one (None for the rest, and where no cotangent reaches
    one), ``pointwise.interpret_adjoint`` of the group's adjoint program:
    its per-element ops, ``sum_to_size`` at each reduction (in float64,
    rounded once, with ``sums64``, as the kernel sums) and the reduced
    tail, in PyTorch ops.  Nothing on the card's path calls it."""
    pl = plan_adjoint(prog, sigs, scals, cts, need, T)
    return shaped_grads(pl, pointwise.interpret_adjoint(
        pl.adj, pl.sigs, pl.scals, pl.cts, pl.rows, T, device, sums64))


def group_vjp(prog: pointwise.Program, sigs, scals, cts, need, T: int,
              device) -> list:
    """The vjp of ``pointwise.interpret`` by autograd, recomputed from the
    operands: the eager ops' backward, each gradient summed to its
    operand's shape by autograd (a needed operand no cotangent reaches
    gets zeros).  The reference the reverse kernel is held to, the route
    it replaced, and PointwiseGroup's backward where none is given."""
    ops = [t.detach().requires_grad_(True) if n else t.detach()
           for t, n in zip((*sigs, *scals), need)]
    n_sig = len(sigs)
    with torch.enable_grad():
        outs = pointwise.interpret(prog, ops[:n_sig], ops[n_sig:], T,
                                   device)
        return grads_of(outs, cts, [t if n else None
                                    for t, n in zip(ops, need)])


class PointwiseGroup(torch.autograd.Function):
    """A group on the card under autograd: ``apply(forward, backward,
    prog, T, device, n_sig, *sigs, *scals)`` runs ``forward(prog, sigs,
    scals, T, device)`` once (the kernel, ``_kernel_group``; a test passes
    ``pointwise.interpret``) and saves the operands; the backward runs
    ``backward(prog, sigs, scals, cts, need, T, device)`` on them (the
    reverse kernel on the card, ops/pointwise_reverse_kernel.
    reverse_group; a test passes :func:`group_adjoint`), :func:`group_vjp`
    where it is None.  A missing cotangent stays None."""

    @staticmethod
    def forward(ctx, forward, backward, prog, T, device, n_sig, *operands):
        ctx.set_materialize_grads(False)
        ctx.prog, ctx.T, ctx.dev, ctx.n_sig = prog, T, device, n_sig
        ctx.backward_fn = backward or group_vjp
        ctx.save_for_backward(*operands)
        with torch.no_grad():
            outs = forward(prog, list(operands[:n_sig]),
                           list(operands[n_sig:]), T, device)
        return fresh(tuple(outs), operands)

    @staticmethod
    def backward(ctx, *cts):
        need = ctx.needs_input_grad[6:]
        ops = ctx.saved_tensors
        grads = ctx.backward_fn(ctx.prog, list(ops[:ctx.n_sig]),
                                list(ops[ctx.n_sig:]), list(cts), need,
                                ctx.T, ctx.dev)
        return (None,) * 6 + tuple(grads)


def run(forward, prog, sigs, scals, T: int, device, backward=None) -> list:
    """``forward(prog, sigs, scals, T, device)``, through
    ``PointwiseGroup`` when autograd must see it (the card's dispatch; a
    test passes ``pointwise.interpret``) with ``backward`` as its backward
    (:func:`group_vjp` where None)."""
    if not needs_grad((*sigs, *scals)):
        return list(forward(prog, list(sigs), list(scals), T, device))
    return list(PointwiseGroup.apply(forward, backward, prog, T, device,
                                     len(sigs), *sigs, *scals))


def group_call(prog: pointwise.Program, sigs, scals, T: int,
               device) -> list:
    """The outputs of the group ``prog``: the kernel on the card (its
    backward the reverse kernel), the plain ``pointwise.interpret`` on
    the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return pointwise.interpret(prog, list(sigs), list(scals), T, device)
    if device.type != "cuda":
        raise ValueError(f"pointwise group: no kernel for device {device}")
    from dsp_stuff_tpu_torch.ops import pointwise_reverse_kernel
    return run(_kernel_group, prog, sigs, scals, T, device,
               pointwise_reverse_kernel.reverse_group)


@functools.lru_cache(maxsize=256)
def _shaper_program(lower, kinds: tuple, policy: str) -> pointwise.Program:
    b = pointwise.Builder()
    x = b.sig()
    ps = [b.sig() if k == "sig" else b.scal() for k in kinds]
    return b.program([lower(b, x, *ps, policy)])


def shaper_call(fn, x: torch.Tensor, *params) -> torch.Tensor:
    """The shaper ``fn`` of ops/shaping.py (a Distort mode, Fuzz at its
    block of 128, or overdrive) over ``x`` as a one-node group: its parameters
    (floats, sliders as data, tensors) are operands.  ops/oversample.py
    runs the shaper pass at R > 1 through it."""
    lower = pointwise.shaper_form(fn)
    if lower is None:
        raise ValueError(f"pointwise group: {fn!r} is not a shaper")
    ops = [on_device(p, x.device) for p in params]
    kinds = tuple("scal" if t.dim() == 0 else "sig" for t in ops)
    prog = _shaper_program(lower, kinds, get_policy().name)
    return group_call(prog, [x, *(t for t in ops if t.dim())],
                      [t for t in ops if not t.dim()], x.shape[-1],
                      x.device)[0]
