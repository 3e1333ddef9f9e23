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
worlds.  Pass 1 walks [rows, T] with the forward's layout, a thread a
unit of 4 samples over rch rows (:func:`launch_shape`): it computes its
samples' per-sample ("C") values once (``pr_col``), then for each row
reads the operands and the cotangents, recomputes the forward in
registers, writes the gradient of each full ("F") operand, and leaves
per-CTA partial sums (float64) of each sum out of the full world in a
workspace from the stream's pool: one a CTA for a scalar, one a row and
CTA for a [..., 1] operand, one a sample and row chunk for a [T] one;
where one chunk holds every row, a [T] operand's sums are complete in
the thread, which runs the per-time tail itself.  Pass 2, one CTA, adds
the partials in a fixed order, runs the per-row ("R") and (rows chunked)
per-time tails, sums those to the scalars, and runs the uniform ("U")
tail, each sum rounded once.  A divide by a uniform value goes through
its reciprocal, computed once a thread (``pw_div``, bitwise the IEEE
divide).  A group's backward is at most these two launches, the second
only where a reduced gradient is left to it; no atomics, so ten calls are
bitwise equal.

A program with block ops (a Fuzz group: its forward's ``bmax`` and the
vjp's ``bsum`` and ``bcnt``) is generated in stages (:func:`staged`,
``pr_block``): a thread's four samples at once, each block op a warp
reduction between two stages, a warp one 128-sample block of a row.  It
launches only the float4 build with T % 128 == 0 (anything else raises);
a stream whose row starts are not 16-byte aligned is copied first.

``reverse_group`` takes only CUDA tensors (the saved operands and the
cotangents) and raises on anything else; there is no fallback.  Its plain
PyTorch version is ops/pointwise_kernel.group_adjoint.  ``LAUNCHES``
counts its calls that launch the kernel (``SUM_LAUNCHES`` those that also
launch pass 2).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from dsp_stuff_tpu_torch.compiler import pointwise
from dsp_stuff_tpu_torch.ops import cuda_build
from dsp_stuff_tpu_torch.ops.pointwise_kernel import (_CT, MAX_GRID_Y, V,
                                                      _lit, c_expr,
                                                      plan_adjoint,
                                                      shaped_grads)

#: calls that launched the kernel in this process (a test or a smoke run
#: resets it), and those of them that launched pass 2 as well
LAUNCHES = 0
SUM_LAUNCHES = 0

# Launch geometry, mirrored by csrc/pointwise_reverse_kernel.cu
THREADS = 256           # pass 1 (PR_THREADS); V samples a thread (PR_V)
THREADS2 = 1024         # pass 2's one CTA (PR2_THREADS)
#: rows a pass-1 CTA walks where a gradient is summed over the rows (a
#: [T] operand's) and T is too short to fill the card: its partials are
#: one a sample and chunk, pass 2 adds them and runs the per-sample tail
ROW_CHUNK = 32
#: pass-1 CTAs along a row (gx, T / (V * THREADS)) from which such a
#: launch takes every row in one chunk (gy = 1): each thread completes its
#: samples' sums over the rows and runs the per-sample tail itself
TAIL_MIN_GX = 192
#: rows a thread walks where the program has per-sample values
#: (``pr_col``) and no sum over the rows, where that grid keeps
#: HOIST_MIN_CTAS CTAs; else one row, as a short launch is bound by a
#: thread's latency (measured: PERF.md section 6, row 7r)
HOIST_ROWS = 8
HOIST_MIN_CTAS = 2048
#: pass 1's CTAs an SM (its launch bound, so a thread's registers) by the
#: registers its float64 accumulators take: (at most this many, CTAs),
#: then MIN_CTAS_MANY (measured on config5's programs, PERF.md section 6)
MIN_CTAS = ((4, 6), (16, 5))
MIN_CTAS_MANY = 4
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


def _pow2_inverse(op, dt, imm):
    """2^-k where a constant divisor is a power of two 2^k whose inverse
    is normal (a divide by it is the product by 2^-k, bitwise), else
    None."""
    if op != "const":
        return None
    m, e = math.frexp(float(imm))
    lim = 126 if dt == "f32" else 1022
    if abs(m) != 0.5 or abs(e - 1) >= lim:
        return None
    return math.copysign(math.ldexp(1.0, 1 - e), m)


def min_ctas(w: Worlds) -> int:
    """Pass 1's launch bound in CTAs an SM (MIN_CTAS): the fewer registers
    its float64 accumulators take (two a sum out of the full world, a
    per-sample one for each of its V samples), the more CTAs."""
    acc = 2 * (len(w.reds[("F", "U")]) + len(w.reds[("F", "R")])
               + V * len(w.reds[("F", "C")]))
    return next((n for most, n in MIN_CTAS if acc <= most), MIN_CTAS_MANY)


def stream_classes(adj: pointwise.Adjoint) -> tuple:
    """Each stream's class (:class:`Worlds` ``streams``): one of "F" and
    "C" spans the time (time stride 1), "R" does not (stride 0)."""
    cls = {(op, imm): adj.cls[v] for v, (op, _, _, imm) in enumerate(adj.ops)
           if op in ("sig", "ct")}
    return tuple(cls[key] for key in worlds(adj).streams)


def staged(adj: pointwise.Adjoint) -> bool:
    """Whether ``adj`` holds a block op (a Fuzz group's: bmax, bsum,
    bcnt), which the staged build takes."""
    return any(op in pointwise.BLOCK_OPS for op, *_ in adj.ops)


@functools.lru_cache(maxsize=256)
def hoisted(adj: pointwise.Adjoint) -> tuple:
    """The full world's statements of class C (a value of the samples
    alone: its operands of class C or U), which pass 1 computes once for
    its samples before its row loop (``pr_col``); its sums stay per
    element.  None in a staged build."""
    if staged(adj):
        return ()
    w = worlds(adj)
    struct, out = set(w.struct), []
    for v in w.stmts["F"]:
        op, _, args, _ = adj.ops[v]
        if adj.cls[v] == "C" and op != "red" and all(
                a in struct or a in out for a in args):
            out.append(v)
    return tuple(out)


@functools.lru_cache(maxsize=256)
def reverse_source(adj: pointwise.Adjoint) -> str:
    """The generated header of the reverse kernel for ``adj``: the counts,
    ``PrUniform`` and ``pr_uniform`` (the uniform forward values and the
    reciprocal of each uniform divisor, once a thread), ``PrCol`` and
    ``pr_col`` (the full world's per-sample values, once a sample for a
    thread's rows: :func:`hoisted`), ``pr_point`` (pass 1, one element:
    stream k in x[k], gradient k to g[k], each sum out of the full world
    added to its float64 accumulator), ``pr_row`` and ``pr_time`` (the
    per-row and per-sample tails, their sums from pass 1 in rr / rc) and
    ``pr_tail`` (the uniform tail, its sums in ru): one statement an op in
    the program's order, each f32 operation one __f*_rn intrinsic, a
    divide by a uniform value ``pw_div`` through its reciprocal (or
    ``pw_div_pow2``, the product by 2^-k, where it is a constant 2^k), each
    sum rounded once to its dtype.  No operand value appears in it."""
    w = worlds(adj)
    ops = adj.ops
    struct = set(w.struct)
    col = set(hoisted(adj))
    red_slot = {v: (kind, j) for kind, vs in w.reds.items()
                for j, v in enumerate(vs)}
    tail_base = {("F", "U"): 0, ("R", "U"): len(w.reds[("F", "U")]),
                 ("C", "U"): len(w.reds[("F", "U")]) + len(w.reds[("R", "U")])}
    stream_of = {key: j for j, key in enumerate(w.streams)}
    ptr_of = {key: j for j, key in enumerate(w.ptrs)}
    recips = []                     # uniform divisors taken by pw_div

    def ref(v, fn=None):
        if v in struct:
            return f"U.v{v}"
        if fn == "pr_block":
            return f"v{v}[i]"
        return f"C.v{v}" if fn == "pr_point" and v in col else f"v{v}"

    def load(op, imm, world, fn=None):
        key = (op, imm)
        if key in ptr_of:
            return f"*p[{ptr_of[key]}]"
        j = stream_of[key]
        if world == "F":
            return f"x[i][{j}]" if fn == "pr_block" else f"x[{j}]"
        return (f"in[{j}][row * in_sb[{j}]]" if world == "R"
                else f"in[{j}][t * in_st[{j}]]")

    def expr(v, world, fn=None):
        op, dt, args, imm = ops[v]
        if op in ("sig", "scal", "ct"):
            return load(op, imm, world, fn)
        a = [ref(i, fn) for i in args]
        if op == "div" and args[1] in struct and args[0] not in struct:
            inv = _pow2_inverse(*[ops[args[1]][k] for k in (0, 1, 3)])
            if inv is not None:
                return f"pw_div_pow2({a[0]}, {_lit(inv, dt)})"
            if args[1] not in recips:
                recips.append(args[1])
            return f"pw_div({a[0]}, U.r{args[1]})"
        return c_expr(op, dt, a, imm)

    def dbl(v, fn):
        return ref(v, fn) if ops[v][1] == "f64" else f"(double){ref(v, fn)}"

    def body(world, fn):
        lines = []
        acc = {"F": {"U": "aU", "R": "aR", "C": "aC"}, "R": {"U": "aU"},
               "C": {"U": "aU"}}.get(world, {})
        for v in sorted(w.stmts[world] + w.inputs[world]):
            if world == "F" and (v in col) != (fn == "pr_col"):
                continue        # the hoisted in pr_col, the rest in pr_point
            op, dt, args, imm = ops[v]
            if v in w.inputs[world]:
                kind, j = red_slot[v]
                src = ({"R": "rr", "C": "rc"}[world] + f"[{j}]"
                       if world != "U" else f"ru[{tail_base[kind] + j}]")
                val = src if dt == "f64" else f"__double2float_rn({src})"
                lines.append(f"  const {_CT[dt]} v{v} = {val};")
            elif op == "red":
                lines.append(f"  {acc[imm[0]]}[{red_slot[v][1]}] += "
                             f"{dbl(args[0], fn)};")
            else:
                lines.append(f"  const {_CT[dt]} v{v} = "
                             f"{expr(v, world, fn)};")
        if fn == "pr_col":
            return lines
        for j, (k, g) in enumerate(w.outs):
            if adj.classes[k] != world:
                continue
            if world == "F":
                lines.append(f"  g[{j}] = {ref(g, fn)};")
            else:
                at = {"R": "row", "C": "t", "U": "0"}[world]
                lines.append(f"  out[{j}][{at}] = {ref(g, fn)};")
        return lines

    def block():
        """pr_block: the full world for a thread's V samples at once (a
        staged build), each value an array of V, the statements in order
        in stages, each stage one loop over the samples, a block op
        between two (pw_bmax, pw_bsum, pw_bcnt: a warp is one block of a
        row), its operands finished for every sample first."""
        loop = ["#pragma unroll", f"  for (int i = 0; i < {V}; ++i) {{"]
        decl, lines = [], list(loop)
        for v in w.stmts["F"]:
            op, dt, args, imm = ops[v]
            if op == "red":
                lines.append(f"    {'aU' if imm[0] == 'U' else 'aR'}"
                             f"[{red_slot[v][1]}] += "
                             f"{dbl(args[0], 'pr_block')};")
                continue
            decl.append(f"  {_CT[dt]} v{v}[{V}];")
            if op in pointwise.BLOCK_OPS:
                if any(a in struct for a in args):
                    raise ValueError(f"pointwise reverse: {op} of a uniform "
                                     f"value")
                lines += ["  }", f"  pw_{op}(v{v}, "
                          + ", ".join(f"v{a}" for a in args) + ");", *loop]
            else:
                lines.append(f"    v{v}[i] = {expr(v, 'F', 'pr_block')};")
        lines += [f"    g[i][{j}] = {ref(g, 'pr_block')};"
                  for j, (k, g) in enumerate(w.outs)
                  if adj.classes[k] == "F"]
        lines.append("  }")
        return ["template <int NS, int NO>",
                "__device__ __forceinline__ void pr_block(const PrUniform& U,",
                f"    const float (&x)[{V}][NS], float (&g)[{V}][NO], "
                "double* aU,", "    double* aR) {", *decl, *lines, "}"]

    # the hoisted values pr_point reads (or stores as a gradient)
    used = {a for v in w.stmts["F"] if v not in col for a in ops[v][2]}
    used |= {g for k, g in w.outs if adj.classes[k] == "F"}
    col_out = sorted(v for v in col if v in used)
    stage = staged(adj)
    if stage and (w.reds[("F", "C")] or w.reds[("F", "R")]):
        raise ValueError("pointwise reverse: a staged build sums only to "
                         "uniform values (every signal spans the launch)")
    point = block() if stage else [
        "__device__ __forceinline__ void pr_point(const PrUniform& U,",
        "    const PrCol& C, const float* x, float* g, double* aU, "
        "double* aR,", "    double* aC) {", *body("F", "pr_point"), "}"]
    colb = body("F", "pr_col")
    rows, times, tail = body("R", "pr_row"), body("C", "pr_time"), \
        body("U", "pr_tail")
    fields = [f"  {_CT[ops[v][1]]} v{v};" for v in w.struct]
    fields += [f"  PwRecip{'64' if ops[v][1] == 'f64' else ''} r{v};"
               for v in recips]
    pre = [f"  U.v{v} = {expr(v, 'U')};" for v in w.struct]
    pre += [f"  U.r{v} = pw_recip(U.v{v});" for v in recips]
    n_red = {k: len(v) for k, v in w.reds.items()}
    strided = [j for j, c in enumerate(stream_classes(adj)[:w.n_in1])
               if c in ("F", "C")]
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
        f"#define PR_MIN_CTAS {min_ctas(w)}",
        *(["#define PR_STAGED 1"] if stage else []),
        "#define PR_STRIDED(k) (" + (" || ".join(
            f"(k) == {j}" for j in strided) or "0") + ")",
        "struct PrUniform {", *(fields or ["  int none;"]), "};",
        "__device__ __forceinline__ PrUniform pr_uniform(",
        "    const float* const* p) {",
        "  PrUniform U;", *pre, "  return U;", "}",
        "struct PrCol {",
        *([f"  {_CT[ops[v][1]]} v{v};" for v in col_out] or ["  int none;"]),
        "};",
        "__device__ __forceinline__ PrCol pr_col(const PrUniform& U,",
        "    const float* x) {",
        "  PrCol C;", *colb, *[f"  C.v{v} = v{v};" for v in col_out],
        "  return C;", "}",
        *point,
        "__device__ __forceinline__ void pr_row(const PrUniform& U,",
        f"    {rest},", "    long long row, const double* rr, double* aU) {",
        *rows, "}",
        "__device__ __forceinline__ void pr_time(const PrUniform& U,",
        f"    {rest},", "    long long t, const double* rc, double* aU) {",
        *times, "}",
        "__device__ __forceinline__ void pr_tail(const PrUniform& U,",
        f"    {rest},", "    const double* ru) {",
        *tail, "}", ""])


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


def launch_shape(adj: pointwise.Adjoint, rows: int, T: int,
                 vec: bool) -> tuple:
    """(rch, gx, gy) of pass 1: gx a row's units over THREADS, gy the
    row chunks of rch rows each; a function of the program, rows, T and
    the float4 build's choice alone.  Where a gradient is summed over the
    rows (a [T] operand's): every row in one chunk once gx >= TAIL_MIN_GX,
    else ROW_CHUNK rows; where per-sample values are hoisted, HOIST_ROWS
    rows where that keeps HOIST_MIN_CTAS CTAs; else one row (and enough
    rows a chunk for the grid's y limit)."""
    w = worlds(adj)
    gx = -(-(-(-T // V) if vec else T) // THREADS)
    if w.reds[("F", "C")]:
        rch = rows if gx >= TAIL_MIN_GX else ROW_CHUNK
    else:
        rch = 1
        if hoisted(adj) and gx * -(-rows // HOIST_ROWS) >= HOIST_MIN_CTAS:
            rch = min(HOIST_ROWS, rows)
    rch = max(rch, -(-rows // MAX_GRID_Y))
    return rch, gx, -(-rows // rch)


def tail_in_pass1(w: Worlds, gy: int) -> bool:
    """Whether pass 1 runs the per-sample tail: where a gradient is summed
    over the rows and one chunk holds every row."""
    return bool(w.reds[("F", "C")]) and gy == 1


def workspace_size(w: Worlds, rows: int, T: int, gx: int, gy: int) -> int:
    """Doubles of the partial sums: one a CTA a scalar sum, one a row and
    CTA column a per-row sum, and one a sample and row chunk a per-time
    sum, or, where pass 1 runs the per-sample tail, one a CTA column of
    each of that tail's sums to the scalars."""
    n = (len(w.reds[("F", "U")]) * gx * gy
         + len(w.reds[("F", "R")]) * rows * gx)
    if tail_in_pass1(w, gy):
        return n + len(w.reds[("C", "U")]) * gx
    return n + len(w.reds[("F", "C")]) * gy * T


def plan_reverse(pl, device) -> ReverseLaunch:
    """Lay out a launch of the backward planned by ``pl``
    (ops/pointwise_kernel.plan_adjoint; the tests run it on the CPU): the
    streams and pointers the generated text reads, in its order, the
    gradient buffers and the workspace allocated, pass 1's row chunk and
    grid (:func:`launch_shape`: x a row's units, one a thread, y the row
    chunks) and which passes run (pass 2 where a per-row or uniform
    gradient is needed, or a per-sample one that pass 1 does not finish)."""
    adj, rows, T = pl.adj, pl.rows, pl.T
    w = worlds(adj)
    ins, sbs, sts, ptrs = [], [], [], []
    for (op, k), c in zip(w.streams, stream_classes(adj)):
        t = pl.sigs[k] if op == "sig" else pl.cts[k]
        if t.shape[1] > 1 and t.stride(1) != 1:
            t = t.contiguous()
        ins.append(t)
        sbs.append(t.stride(0) if t.shape[0] > 1 else 0)
        sts.append(int(c in ("F", "C")))
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
    stage = staged(adj)
    if stage:
        # the float4 build alone takes the block ops, a warp one block of
        # a row: T % 128 == 0, and a stream whose row starts are not
        # 16-byte aligned copied to a fresh buffer
        if T % pointwise.BLOCK:
            raise ValueError(f"pointwise reverse kernel: a program with "
                             f"bmax (Fuzz) needs T % {pointwise.BLOCK} == "
                             f"0, got T={T}")
        for j, (t, sb, st) in enumerate(zip(ins[:w.n_in1], sbs, sts)):
            if st and (t.data_ptr() % 16 or sb % V):
                ins[j] = t.clone(memory_format=torch.contiguous_format)
                sbs[j] = ins[j].stride(0) if sb else 0
    vec = T % V == 0 and all(t.data_ptr() % 16 == 0 and sb % V == 0
                             for t, sb, st in zip(ins[:w.n_in1], sbs, sts)
                             if st)
    if stage and not vec:
        raise ValueError("pointwise reverse kernel: a program with bmax "
                         "(Fuzz) runs only the float4 build")
    rch, gx, gy = launch_shape(adj, rows, T, vec)
    n = workspace_size(w, rows, T, gx, gy)
    part = (torch.empty(n, dtype=torch.float64, device=device) if n
            else None)
    late = {adj.classes[k] for k, _ in w.outs[w.n_out1:]}
    if tail_in_pass1(w, gy):
        late.discard("C")
    return ReverseLaunch(ins, sbs, sts, ptrs, outs, part, rows, T, rch, vec,
                         (gx, gy), bool(w.stmts["F"] or w.n_out1),
                         bool(late))


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

