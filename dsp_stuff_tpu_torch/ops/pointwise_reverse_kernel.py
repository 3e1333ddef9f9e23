"""Wrapper of the reverse pointwise kernel (csrc/pointwise_reverse_kernel.cu):
generate, build, bind, launch.

The kernel is a pointwise group's backward: the counterpart of the fused
vjp that XLA compiles for ``jax.grad`` through the JAX package's
``jax.jit(self.fn)`` (dsp_stuff_tpu/compiler/compile.py:230), as the
forward (ops/pointwise_kernel.py) is of the fusion itself.  The group's
adjoint program (compiler/pointwise.adjoint: the forward recomputed from
the operands, autograd's vjp of each op in reverse order, a ``red`` op
wherever autograd sums a gradient to a narrower operand) is written as
straight-line CUDA by :func:`reverse_source` and built by
ops/cuda_build.py once per adjoint program at first use, bound with
``ctypes``.  Nothing is imported, built or loaded when this module is
imported.

The program's values split by class (``pointwise.CLASSES``) into four
worlds.  Pass 1 walks [rows, T] with the forward's layout: it reads the
operands and the cotangents, recomputes the forward in registers, writes
the gradient of each full ("F") operand, and leaves per-CTA partial sums
(float64) of each sum out of the full world in a workspace from the
stream's pool: one a CTA for a scalar, one a row and CTA for a [..., 1]
operand, one a sample and row chunk for a [T] one.  Pass 2, one CTA,
adds the partials in a fixed order, runs the per-row ("R") and per-time
("C") tails, sums those to the scalars, and runs the uniform ("U") tail,
each sum rounded once.  A group's backward is at most these two
launches, the second only where a reduced gradient is needed; no atomics,
so ten calls are bitwise equal.

``reverse_group`` takes only CUDA tensors (the saved operands and the
cotangents) and raises on anything else; there is no fallback.  Its plain
PyTorch version is ops/pointwise_kernel.group_adjoint.  ``LAUNCHES``
counts its calls that launch the kernel (``SUM_LAUNCHES`` those that also
launch pass 2).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dsp_stuff_tpu_torch.compiler import pointwise
from dsp_stuff_tpu_torch.ops import cuda_build
from dsp_stuff_tpu_torch.ops.pointwise_kernel import (_CT, MAX_GRID_Y, V,
                                                      c_expr, plan_adjoint,
                                                      shaped_grads)

#: calls that launched the kernel in this process (a test or a smoke run
#: resets it), and those of them that launched pass 2 as well
LAUNCHES = 0
SUM_LAUNCHES = 0

# Launch geometry, mirrored by csrc/pointwise_reverse_kernel.cu
THREADS = 256           # pass 1 (PR_THREADS); V samples a thread (PR_V)
THREADS2 = 1024         # pass 2's one CTA (PR2_THREADS)
#: rows a pass-1 CTA walks where a gradient is summed over the rows (a
#: [T] operand's), so its partials are one a sample and chunk; else 1
ROW_CHUNK = 32
#: the sums' kinds by (source world, target class), in the workspace's
#: and the pass-2 tail's order
RED_KINDS = (("F", "U"), ("F", "R"), ("F", "C"), ("R", "U"), ("C", "U"))


class Worlds(NamedTuple):
    """How an adjoint program splits between the passes: each world's
    statements ("F" pass 1; "R", "C" and "U" pass 2) and the sums it takes
    from an earlier one, the uniform forward values (once a thread), the
    streams (signals and cotangents read per element, per row or per
    sample: pass 1's first), the pointers (uniform operands), the
    gradients written (pass 1's first, each with its operand and class)
    and the sums by kind."""
    stmts: dict
    inputs: dict
    struct: tuple
    streams: tuple
    n_in1: int
    ptrs: tuple
    outs: tuple
    n_out1: int
    reds: dict


@functools.lru_cache(maxsize=256)
def worlds(adj: pointwise.Adjoint) -> Worlds:
    """Split ``adj`` between the passes (:class:`Worlds`)."""
    ops, cls = adj.ops, adj.cls
    dep: list = []                  # depends on a cotangent or a sum
    for op, _, args, _ in ops:
        dep.append(op in ("ct", "red") or any(dep[a] for a in args))
    pure_u = [c == "U" and not d for c, d in zip(cls, dep)]
    reds = {k: tuple(i for i, (op, _, _, imm) in enumerate(ops)
                     if op == "red" and (imm[1], imm[0]) == k)
            for k in RED_KINDS}
    outs = []
    for world in ("F", "R", "C", "U"):
        outs += [(k, g) for k, g in enumerate(adj.grads)
                 if g is not None and adj.classes[k] == world]
    stmts, inputs, struct = {}, {}, set()
    for world in ("F", "R", "C", "U"):
        roots = [i for i, (op, _, _, imm) in enumerate(ops)
                 if op == "red" and imm[1] == world]
        roots += [g for k, g in outs if adj.classes[k] == world]
        seen, st, inp = set(), set(), set()
        while roots:
            v = roots.pop()
            if v in seen:
                continue
            seen.add(v)
            op, _, args, imm = ops[v]
            if pure_u[v]:
                struct.add(v)
            elif op == "red" and imm[1] != world:
                if (imm[1], world) not in (("F", "R"), ("F", "C")) and \
                        world != "U":
                    raise ValueError(f"pointwise reverse: a sum {imm} read "
                                     f"in the {world} world")
                inp.add(v)
            else:
                st.add(v)
                roots.extend(args)
        stmts[world], inputs[world] = tuple(sorted(st)), tuple(sorted(inp))
    # the uniform values' own operands
    stack = list(struct)
    while stack:
        for a in ops[stack.pop()][2]:
            if a not in struct:
                struct.add(a)
                stack.append(a)
    streams, ptrs = [], []
    for world in ("F", "R", "C", "U"):
        for v in stmts[world]:
            op, _, _, imm = ops[v]
            key = (op, imm)
            if op in ("sig", "ct") and cls[v] != "U" and key not in streams:
                streams.append(key)
            if op == "ct" and cls[v] == "U" and key not in ptrs:
                ptrs.append(key)
        if world == "F":
            n_in1 = len(streams)
    for v in sorted(struct):
        op, _, _, imm = ops[v]
        if op in ("sig", "scal") and (op, imm) not in ptrs:
            ptrs.append((op, imm))
    n_out1 = sum(adj.classes[k] == "F" for k, _ in outs)
    return Worlds(stmts, inputs, tuple(sorted(struct)), tuple(streams),
                  n_in1, tuple(ptrs), tuple(outs), n_out1, reds)


@functools.lru_cache(maxsize=256)
def reverse_source(adj: pointwise.Adjoint) -> str:
    """The generated header of the reverse kernel for ``adj``: the counts,
    ``PrUniform`` and ``pr_uniform`` (the uniform forward values, once a
    thread), ``pr_point`` (pass 1, one element: stream k in x[k], gradient
    k to g[k], each sum out of the full world added to its float64
    accumulator), ``pr_row`` and ``pr_time`` (pass 2's per-row and
    per-sample tails, their sums from pass 1 in rr / rc) and ``pr_tail``
    (the uniform tail, its sums in ru): one statement an op in the
    program's order, each f32 operation one __f*_rn intrinsic, each sum
    rounded once to its dtype.  No operand value appears in it."""
    w = worlds(adj)
    ops = adj.ops
    struct = set(w.struct)
    red_slot = {v: (kind, j) for kind, vs in w.reds.items()
                for j, v in enumerate(vs)}
    tail_base = {("F", "U"): 0, ("R", "U"): len(w.reds[("F", "U")]),
                 ("C", "U"): len(w.reds[("F", "U")]) + len(w.reds[("R", "U")])}
    stream_of = {key: j for j, key in enumerate(w.streams)}
    ptr_of = {key: j for j, key in enumerate(w.ptrs)}

    def ref(v):
        return f"U.v{v}" if v in struct else f"v{v}"

    def load(op, imm, world):
        key = (op, imm)
        if key in ptr_of:
            return f"*p[{ptr_of[key]}]"
        j = stream_of[key]
        if world == "F":
            return f"x[{j}]"
        return (f"in[{j}][row * in_sb[{j}]]" if world == "R"
                else f"in[{j}][t * in_st[{j}]]")

    def expr(v, world):
        op, dt, args, imm = ops[v]
        if op in ("sig", "scal", "ct"):
            return load(op, imm, world)
        a = [ref(i) for i in args]
        if op == "div" and args[1] in struct and args[0] not in struct:
            a[1] = f"pw_fresh({a[1]})"      # as the forward's source
        return c_expr(op, dt, a, imm)

    def dbl(v):
        return ref(v) if ops[v][1] == "f64" else f"(double){ref(v)}"

    def body(world):
        lines = []
        acc = {"F": {"U": "aU", "R": "aR", "C": "aC"}, "R": {"U": "aU"},
               "C": {"U": "aU"}}.get(world, {})
        for v in sorted(w.stmts[world] + w.inputs[world]):
            op, dt, args, imm = ops[v]
            if v in w.inputs[world]:
                kind, j = red_slot[v]
                src = ({"R": "rr", "C": "rc"}[world] + f"[{j}]"
                       if world != "U" else f"ru[{tail_base[kind] + j}]")
                val = src if dt == "f64" else f"__double2float_rn({src})"
                lines.append(f"  const {_CT[dt]} v{v} = {val};")
            elif op == "red":
                lines.append(f"  {acc[imm[0]]}[{red_slot[v][1]}] += "
                             f"{dbl(args[0])};")
            else:
                lines.append(f"  const {_CT[dt]} v{v} = {expr(v, world)};")
        for j, (k, g) in enumerate(w.outs):
            if adj.classes[k] != world:
                continue
            if world == "F":
                lines.append(f"  g[{j}] = {ref(g)};")
            else:
                at = {"R": "row", "C": "t", "U": "0"}[world]
                lines.append(f"  out[{j}][{at}] = {ref(g)};")
        return lines

    fields = [f"  {_CT[ops[v][1]]} v{v};" for v in w.struct]
    pre = [f"  U.v{v} = {expr(v, 'U')};" for v in w.struct]
    n_red = {k: len(v) for k, v in w.reds.items()}
    pass2 = w.n_out1 < len(w.outs)
    pass1 = bool(w.stmts["F"] or w.n_out1)
    rest = ("const float* const* in, const long long* in_sb, "
            "const int* in_st, const float* const* p, float* const* out")
    return "\n".join([
        "// generated by ops/pointwise_reverse_kernel.py:reverse_source",
        f"#define PR_NIN {len(w.streams)}",
        f"#define PR_NIN1 {w.n_in1}",
        f"#define PR_NPTR {len(w.ptrs)}",
        f"#define PR_NOUT {len(w.outs)}",
        f"#define PR_NOUT1 {w.n_out1}",
        f"#define PR_NFU {n_red[('F', 'U')]}",
        f"#define PR_NFR {n_red[('F', 'R')]}",
        f"#define PR_NFC {n_red[('F', 'C')]}",
        f"#define PR_NRU {n_red[('R', 'U')]}",
        f"#define PR_NCU {n_red[('C', 'U')]}",
        f"#define PR_PASS1 {int(pass1)}",
        f"#define PR_PASS2 {int(pass2)}",
        f"#define PR_ROWS {int(bool(w.stmts['R'] or w.inputs['R']))}",
        f"#define PR_TIMES {int(bool(w.stmts['C'] or w.inputs['C']))}",
        "struct PrUniform {", *(fields or ["  int none;"]), "};",
        "__device__ __forceinline__ PrUniform pr_uniform(",
        "    const float* const* p) {",
        "  PrUniform U;", *pre, "  return U;", "}",
        "__device__ __forceinline__ void pr_point(const PrUniform& U,",
        "    const float* x, float* g, double* aU, double* aR, double* aC) {",
        *body("F"), "}",
        "__device__ __forceinline__ void pr_row(const PrUniform& U,",
        f"    {rest},", "    long long row, const double* rr, double* aU) {",
        *body("R"), "}",
        "__device__ __forceinline__ void pr_time(const PrUniform& U,",
        f"    {rest},", "    long long t, const double* rc, double* aU) {",
        *body("C"), "}",
        "__device__ __forceinline__ void pr_tail(const PrUniform& U,",
        f"    {rest},", "    const double* ru) {",
        *body("U"), "}", ""])


def _counts(w: Worlds) -> int:
    return len(w.streams) | len(w.ptrs) << 10 | len(w.outs) << 20


@functools.lru_cache(maxsize=64)
def _lib(src: str, counts: int) -> ctypes.CDLL:
    """The kernel library for the generated ``src``, bound, its operand
    counts checked against ``counts``."""
    lib = cuda_build.load("pointwise_reverse_kernel", (), src)
    lib.pointwise_reverse_counts.argtypes = []
    lib.pointwise_reverse_counts.restype = ctypes.c_int
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.pointwise_reverse_launch.argtypes = [
        p, p, p, p, p, p, i64, i64, i64, i32, i32, i32, i32, i32, p]
    lib.pointwise_reverse_launch.restype = ctypes.c_int
    if lib.pointwise_reverse_counts() != counts:
        raise RuntimeError(f"pointwise reverse kernel built for operand "
                           f"counts {lib.pointwise_reverse_counts():#x}, the "
                           f"program's {counts:#x}")
    return lib


class ReverseLaunch(NamedTuple):
    """What a launch reads and writes: the streams as 2-D tensors with
    their batch and time strides, the pointer operands, the gradient
    buffers (each at its class's 2-D shape), the workspace (float64, None
    where no sum is taken), the rows, T, the row chunk, the float4
    build's choice, pass 1's grid and whether each pass runs."""
    ins: list
    sb: list
    st: list
    ptrs: list
    outs: list
    part: object
    rows: int
    T: int
    rch: int
    vec: bool
    grid: tuple
    pass1: bool
    pass2: bool


def workspace_size(w: Worlds, rows: int, T: int, gx: int, gy: int) -> int:
    """Doubles of the partial sums: one a CTA a scalar sum, one a row and
    CTA column a per-row sum, one a sample and row chunk a per-time sum."""
    return (len(w.reds[("F", "U")]) * gx * gy
            + len(w.reds[("F", "R")]) * rows * gx
            + len(w.reds[("F", "C")]) * gy * T)


def plan_reverse(pl, device) -> ReverseLaunch:
    """Lay out a launch of the backward planned by ``pl``
    (ops/pointwise_kernel.plan_adjoint; the tests run it on the CPU): the
    streams and pointers the generated text reads, in its order, the
    gradient buffers and the workspace allocated, the row chunk (ROW_CHUNK
    where a sum runs over the rows, so that pass 1's grid stays within its
    y limit too) and pass 1's grid: x a row's units (one a thread), y the
    row chunks."""
    adj, rows, T = pl.adj, pl.rows, pl.T
    w = worlds(adj)
    ins, sbs, sts, ptrs = [], [], [], []
    for op, k in w.streams:
        t = pl.sigs[k] if op == "sig" else pl.cts[k]
        if t.shape[1] > 1 and t.stride(1) != 1:
            t = t.contiguous()
        ins.append(t)
        sbs.append(t.stride(0) if t.shape[0] > 1 else 0)
        sts.append(1 if t.shape[1] > 1 else 0)
    for op, k in w.ptrs:
        t = (pl.sigs[k] if op == "sig" else pl.scals[k] if op == "scal"
             else pl.cts[k])
        if t.numel() != 1:
            raise ValueError(f"pointwise reverse kernel: a uniform operand "
                             f"of shape {tuple(t.shape)}")
        ptrs.append(t)
    for t in (*ins, *ptrs):
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"pointwise reverse kernel: operands must be "
                             f"float32 tensors on {device}, got {t.dtype} "
                             f"on {t.device}")
    outs = [torch.empty(pointwise.class_shape(adj.classes[k], rows, T),
                        dtype=torch.float32, device=device)
            for k, _ in w.outs]
    rch = ROW_CHUNK if w.reds[("F", "C")] else 1
    rch = max(rch, -(-rows // MAX_GRID_Y))
    vec = ((T % V == 0 or rows == 1 or not w.n_out1)
           and all(t.data_ptr() % 16 == 0 and sb % V == 0
                   for t, sb, st in zip(ins[:w.n_in1], sbs, sts) if st))
    upr = -(-T // V) if vec else T
    grid = (-(-upr // THREADS), -(-rows // rch))
    n = workspace_size(w, rows, T, *grid)
    part = (torch.empty(n, dtype=torch.float64, device=device) if n
            else None)
    return ReverseLaunch(ins, sbs, sts, ptrs, outs, part, rows, T, rch, vec,
                         grid, bool(w.stmts["F"] or w.n_out1),
                         w.n_out1 < len(w.outs))


def reverse_group(prog: pointwise.Program, sigs, scals, cts, need, T: int,
                  device) -> list:
    """The gradients of the operands of the group ``prog`` that ``need``
    one, from the cotangents ``cts`` of its outputs (None: no cotangent),
    by the reverse kernel (one launch, two where a reduced gradient is
    needed) on the current stream; None where an operand needs none or no
    cotangent reaches it.  Every operand and cotangent is a CUDA f32
    tensor on ``device``; PointwiseGroup's backward on the card."""
    global LAUNCHES, SUM_LAUNCHES
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"pointwise reverse kernel: no kernel for device "
                         f"{device}")
    pl = plan_adjoint(prog, sigs, scals, cts, need, T)
    w = worlds(pl.adj)
    if not w.outs:
        return [None] * len(need)
    ln = plan_reverse(pl, device)

    def arr(ty, xs):
        return ctypes.cast((ty * max(1, len(xs)))(*xs), ctypes.c_void_p)

    u64, i64 = ctypes.c_ulonglong, ctypes.c_longlong
    rc = _lib(reverse_source(pl.adj), _counts(w)).pointwise_reverse_launch(
        arr(u64, [t.data_ptr() for t in ln.ins]), arr(i64, ln.sb),
        arr(ctypes.c_int, ln.st), arr(u64, [t.data_ptr() for t in ln.ptrs]),
        arr(u64, [t.data_ptr() for t in ln.outs]),
        None if ln.part is None else ln.part.data_ptr(), ln.rows, ln.T,
        ln.rch, int(ln.vec), *ln.grid, int(ln.pass1) | int(ln.pass2) << 1,
        device.index, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pointwise reverse kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    SUM_LAUNCHES += int(ln.pass2)
    grads = [None] * len(need)
    for (k, _), g in zip(w.outs, ln.outs):
        grads[k] = g
    return shaped_grads(pl, grads)
