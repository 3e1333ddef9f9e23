"""Fused cascades of adjacent LINEAR nodes (Gain / LowPass / HighPass /
BiQuad).

A maximal run of linear nodes fuses into ONE blocked solve.  Every
section is a linear state-space system in the DELAYED-state convention
(state s[t] is the value carried INTO sample t):

    s[t] = A s[t-1] + B u[t-1],      y[t] = C s[t] + D u[t]

    gain(level):  no state,                    D = level
    lp(r):        A = r,  B = 1-r,  C = r,     D = 1-r     (low_pass.rs:36-41)
    hp(r):        A = r,  B = 1-r,  C = -r,    D = r       (high_pass.rs:36-41)
    bq(a, b):     transposed direct form II:                (biquad.rs:79-89)
                  A = [[-a1, 1], [-a2, 0]],
                  B = (b1 - a1 b0, b2 - a2 b0), C = (1, 0), D = b0

Series composition is exact in this convention, so a whole run collapses
to ONE composite (A, B, C, D) with state dim n = sum of section dims
(capped at MAX_RUN_DIM = 8), solved like one first-order op: a
combined-taps triangular-Toeplitz product (g[0] = D, g[d] = C A^(d-1) B),
one [C_blk, N] chunk-end product, and the vecN carry chain
(ops/scan._vecn_recurrence).

Per-node states survive exactly: the composite states entering samples
T-1 and T-2 forward-substitute through the sections, yielding each
one-pole's z and each biquad's own input/output history.

The NumPy constant builders below are the JAX package's, unchanged: an
f64 chain cast once to f32.  The solve itself runs in float32 under
every policy (the compiler fuses runs under ``fast`` only).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dsp_stuff_tpu_torch.ops.scan import _BLOCK_C, _const, _vecn_recurrence

#: state dimension per section kind
SECTION_DIMS = {"gain": 0, "lp": 1, "hp": 1, "bq": 2}

#: composite state-dimension cap for fused runs (the vecN carry chain;
#: odd dims embed into the next power of two).  8 admits a 4-biquad EQ
#: stack as ONE solve; the planner splits longer runs at this cap, so
#: the port keeps the JAX package's value to plan the same stages.
MAX_RUN_DIM = 8


def _section_ss(kind: str, p):
    """f64 delayed-state (A [d,d], B [d], C [d], D) for one section."""
    if kind == "gain":
        z = np.zeros((0,), np.float64)
        return np.zeros((0, 0), np.float64), z, z, float(p)
    if kind in ("lp", "hp"):
        r = float(np.float32(p))
        A = np.array([[r]], np.float64)
        B = np.array([1.0 - r], np.float64)
        if kind == "lp":
            return A, B, np.array([r], np.float64), 1.0 - r
        return A, B, np.array([-r], np.float64), r
    if kind == "bq":
        a1, a2, b0, b1, b2 = (float(np.float32(c)) for c in p)
        A = np.array([[-a1, 1.0], [-a2, 0.0]], np.float64)
        B = np.array([b1 - a1 * b0, b2 - a2 * b0], np.float64)
        return A, B, np.array([1.0, 0.0], np.float64), b0
    raise ValueError(f"unknown linear section kind {kind!r}")


def compose_sections(sections):
    """Composite f64 (A, B, C, D) for a series run of sections.

    ``sections`` is a tuple of (kind, param) pairs, in signal order; the
    compiler interleaves the link fan-in scales as ("gain", h) entries.
    """
    A1 = np.zeros((0, 0), np.float64)
    B1 = np.zeros((0,), np.float64)
    C1 = np.zeros((0,), np.float64)
    D1 = 1.0
    for kind, p in sections:
        A2, B2, C2, D2 = _section_ss(kind, p)
        n1, n2 = A1.shape[0], A2.shape[0]
        A = np.zeros((n1 + n2, n1 + n2), np.float64)
        A[:n1, :n1] = A1
        A[n1:, n1:] = A2
        A[n1:, :n1] = np.outer(B2, C1)
        B = np.concatenate([B1, B2 * D1])
        C = np.concatenate([D2 * C1, C2])
        D = D2 * D1
        A1, B1, C1, D1 = A, B, C, D
    return A1, B1, C1, D1


def composite_dim(sections) -> int:
    return sum(SECTION_DIMS[k] for k, _ in sections)


def _embed_dim(n: int) -> int:
    """Carry-machinery dimension: 2 (ops/scan._vec2_recurrence fast
    path), 4, or 8 (_vecn_recurrence is generic in n)."""
    if n > MAX_RUN_DIM:
        raise ValueError(f"composite state dim {n} > {MAX_RUN_DIM}")
    if n <= 2:
        return 2
    return 4 if n <= 4 else 8


def _embedN(A, B, C, N: int):
    """Pad a composite to the N-dim carry machinery (zeros decay)."""
    n = A.shape[0]
    if n == N:
        return A, B, C
    A2 = np.zeros((N, N), np.float64)
    B2 = np.zeros((N,), np.float64)
    C2 = np.zeros((N,), np.float64)
    A2[:n, :n] = A
    B2[:n] = B
    C2[:n] = C
    return A2, B2, C2


def _output_taps(Cv, D, P, B, C: int):
    """(Ltg [C, C], E [C, N], l1) output constants for a readout (C, D)
    over the shared state powers P: Ltg from g[0] = D, g[d] = C A^(d-1) B;
    E[d] = C A^d maps the chunk-entry carry to sample d's output; l1 is
    the tap-row bound for the bf16x3 GEMM eligibility
    (utils.precision.gemm_precision)."""
    g = np.empty(C, np.float64)
    g[0] = D
    g[1:] = np.einsum("i,dij,j->d", Cv, P[: C - 1], B)
    i = np.arange(C)
    diff = i[None, :] - i[:, None]
    Ltg = np.where(diff >= 0, g[np.clip(diff, 0, C - 1)], 0.0)  # [C, C]
    E = np.einsum("i,dij->dj", Cv, P[:C])              # carry->y    [C, N]
    return Ltg, E, float(np.abs(g).sum())


@functools.lru_cache(maxsize=128)
def _cascade_constants(sections: tuple, C: int, emits: tuple = ()):
    """Trace-time NumPy constants for a fused run (f64 chain, cast once
    to f32 -- same constant-precision contract as the biquad's folded
    impulse response, ops/scan.py _biquad_blocked).

    ``emits`` lists extra readout points: section indices i such that the
    signal AFTER section i (the output of the prefix system
    sections[:i+1]) must also be produced -- the compiler uses this to
    fuse THROUGH an intermediate node that has other consumers (a
    wave_view tap, a second output), at the cost of one extra taps GEMM
    per point instead of breaking the run.  The prefix readout against
    the FULL composite state is exact: the composite A is block
    lower-triangular in section order, so [C_pre, 0] A^k = [C_pre
    A_pre^k, 0]."""
    A, B, Cv, D = compose_sections(sections)
    N = _embed_dim(A.shape[0])
    A, B, Cv = _embedN(A, B, Cv, N)

    P = np.empty((C + 1, N, N), np.float64)
    P[0] = np.eye(N)
    for t in range(1, C + 1):
        P[t] = A @ P[t - 1]

    Ltg, E, l1 = _output_taps(Cv, D, P, B, C)

    f32 = np.float32
    emit_consts = []
    for i in emits:
        Ae, Be, Ce, De = compose_sections(sections[: i + 1])
        Ce_ext = np.zeros((N,), np.float64)
        Ce_ext[: Ce.shape[0]] = Ce
        Lte, Ee, l1e = _output_taps(Ce_ext, De, P, B, C)
        emit_consts.append((Lte.astype(f32), Ee.astype(f32), l1e))

    return (Ltg.astype(f32), W_ends(P, B, C), E.astype(f32), P, N, B, l1,
            tuple(emit_consts))


def W_ends(P, B, C: int):
    """Chunk-end input taps [C, N]: W[d] = A^(C-1-d) B."""
    return np.einsum("dij,j->di", P[C - 1::-1], B).astype(np.float32)


def linear_cascade(x, sections: tuple, s_init, emits: tuple = ()):
    """Fused run of linear sections over ``x`` [..., T].

    ``s_init`` is the composite delayed state entering sample 0 (shape
    [..., N], N = the embedded carry dim; assemble with
    :func:`cascade_state_in`).  Returns ``(y, s_tm1, s_tm2)`` where
    s_tm1/s_tm2 are the composite states ENTERING samples T-1 and T-2
    (s_tm2 is None when T == 1); decompose into per-node states with
    :func:`cascade_state_out`.

    ``emits`` lists section indices whose prefix output must also be
    produced (see :func:`_cascade_constants`); when non-empty the return
    gains a fourth element: a tuple of [..., T] signals, one per emit
    point, in ``emits`` order."""
    f32 = torch.float32
    C = _BLOCK_C
    x = torch.as_tensor(x, dtype=f32)
    T = x.shape[-1]
    batch = x.shape[:-1]

    Ltg, W, E, P, N, B, _l1, emit_consts = _cascade_constants(
        tuple(sections), C, tuple(emits))
    s_init = torch.as_tensor(s_init, dtype=f32,
                             device=x.device).expand(*batch, N)

    K = -(-T // C)
    pad = K * C - T
    X = (F.pad(x, (0, pad)) if pad else x).reshape(*batch, K, C)

    # chunk-end states: one [C, N] side product over x, seeding the carry
    # chain
    AC = P[C].astype(np.float32)
    ends = X @ _const(W, x)                                    # [..., K, N]
    ends[..., 0, :] += torch.einsum("ij,...j->...i", _const(AC, x), s_init)
    S = _vecn_recurrence(AC, ends)
    carry_in = torch.cat([s_init[..., None, :], S[..., :-1, :]],
                         dim=-2)                               # [..., K, N]

    def readout(Lt, Ev):
        o = X @ _const(Lt, x) + carry_in @ _const(
            np.ascontiguousarray(Ev.T), x)
        return o.reshape(*batch, K * C)[..., :T]

    y = readout(Ltg, E)
    emit_sigs = tuple(readout(Lte, Ee) for Lte, Ee, _ in emit_consts)

    # composite states entering samples T-1 and T-2, for the per-node
    # state rebuild: one masked [C, N] product each over the owning chunk
    def s_at(kb: int, m: int):
        taps = np.zeros((C, N), np.float64)
        if m > 0:
            taps[:m] = np.einsum("dij,j->di", P[m - 1::-1], B)
        zs = X[..., kb, :] @ _const(taps.astype(np.float32), x)
        return torch.einsum("ij,...j->...i",
                            _const(P[m].astype(np.float32), x),
                            carry_in[..., kb, :]) + zs

    i_last = (T - 1) % C
    s_tm1 = s_at(K - 1, i_last)
    if T == 1:
        s_tm2 = None
    elif i_last >= 1:
        s_tm2 = s_at(K - 1, i_last - 1)
    else:
        s_tm2 = s_at(K - 2, C - 1)
    if emits:
        return y, s_tm1, s_tm2, emit_sigs
    return y, s_tm1, s_tm2


@functools.lru_cache(maxsize=128)
def _tail_state_constants(sections: tuple, C: int):
    """Constants for :func:`cascade_tail_states`: (P[m], taps_m) pairs
    for m = C-1 and C-2 (f32), over the embedded composite."""
    A, B, Cv, D = compose_sections(sections)
    N = _embed_dim(A.shape[0])
    A, B, Cv = _embedN(A, B, Cv, N)
    P = np.empty((C, N, N), np.float64)
    P[0] = np.eye(N)
    for t in range(1, C):
        P[t] = A @ P[t - 1]

    def taps(m):
        t = np.zeros((C, N), np.float64)
        if m > 0:
            t[:m] = np.einsum("dij,j->di", P[m - 1::-1], B)
        return t.astype(np.float32)

    f32 = np.float32
    return ((P[C - 1].astype(f32), taps(C - 1)),
            (P[C - 2].astype(f32), taps(C - 2)), N)



def cascade_tail_states(sections, x_last, carry_last, C: int = 128):
    """(s_tm1, s_tm2) composite states entering samples T-1 and T-2 of a
    run whose LAST full chunk input is ``x_last`` [..., C] and whose
    composite state entering that chunk is ``carry_last`` [..., >= N]
    (requires T % C == 0, so both samples live in the last chunk).

    The chain kernel (ops/chain_kernel.py) emits (carry_last, x_last) per
    cascade stage; this reproduces linear_cascade's ``s_at`` readout so
    per-node states rebuild identically."""
    f32 = torch.float32
    (P1, T1), (P2, T2), N = _tail_state_constants(tuple(sections), C)
    x_last = torch.as_tensor(x_last, dtype=f32)
    carry = torch.as_tensor(carry_last, dtype=f32,
                            device=x_last.device)[..., :N]

    def s_at(Pm, Tm):
        zs = x_last @ _const(Tm, x_last)
        return torch.einsum("ij,...j->...i", _const(Pm, x_last), carry) + zs

    return s_at(P1, T1), s_at(P2, T2)


def _section_values(sections, s_t, x_t):
    """Forward substitution through the run at ONE time step: given the
    composite state s[t] [..., N] and the run input x[t], return per
    section (kind, params, u_i[t], y_i[t], s_i[t])."""
    u = torch.as_tensor(x_t, dtype=torch.float32)
    off = 0
    out = []
    for kind, p in sections:
        A, B, Cv, D = _section_ss(kind, p)
        d = A.shape[0]
        s_i = s_t[..., off:off + d]
        y = float(np.float32(D)) * u
        for k in range(d):
            y = y + float(np.float32(Cv[k])) * s_i[..., k]
        out.append((kind, p, u, y, s_i))
        u = y
        off += d
    return out


def cascade_state_in(sections, node_states):
    """Assemble the composite delayed state [..., N] from per-node
    states.  ``node_states`` lists, in signal order, one dict per
    STATEFUL section: {"z": ...} for lp/hp, the DirectForm1
    {"x1","x2","y1","y2"} for bq (mapped to transposed-DF2 internals:
    w1 = b1 x1 + b2 x2 - a1 y1 - a2 y2,  w2 = b2 x1 - a2 y1)."""
    f32 = torch.float32
    N = _embed_dim(composite_dim(sections))
    comps = []
    si = 0
    for kind, p in sections:
        if SECTION_DIMS[kind] == 0:
            continue
        st = node_states[si]
        si += 1
        if kind in ("lp", "hp"):
            comps.append(torch.as_tensor(st["z"], dtype=f32))
        else:
            a1, a2, b0, b1, b2 = (float(np.float32(c)) for c in p)
            x1, x2, y1, y2 = (torch.as_tensor(st[k], dtype=f32)
                              for k in ("x1", "x2", "y1", "y2"))
            comps.append(b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2)
            comps.append(b2 * x1 - a2 * y1)
    dev = comps[0].device if comps else None
    while len(comps) < N:
        comps.append(torch.zeros_like(comps[0]) if comps
                     else torch.zeros((), dtype=f32, device=dev))
    return torch.stack(torch.broadcast_tensors(*comps), dim=-1)


def cascade_state_out(sections, s_tm1, s_tm2, x_tm1, x_tm2):
    """Per-node state dicts (in signal order, one per stateful section)
    from the composite states entering samples T-1/T-2 and the run
    inputs at those samples.

    One-pole z is the section state AFTER consuming sample T-1
    (A_i s_i + B_i u_i); a biquad's DirectForm1 state is its own
    input/output history, reproduced exactly by forward substitution."""
    vals1 = _section_values(sections, s_tm1, x_tm1)
    vals2 = None
    if s_tm2 is not None:
        vals2 = _section_values(sections, s_tm2, x_tm2)
    out = []
    for idx, (kind, p, u1, y1, s_i) in enumerate(vals1):
        if SECTION_DIMS[kind] == 0:
            continue
        if kind in ("lp", "hp"):
            r = float(np.float32(p))
            out.append({"z": r * s_i[..., 0]
                        + float(np.float32(1.0) - np.float32(r)) * u1})
        else:
            if vals2 is None:
                raise ValueError(
                    "fused biquad sections need T >= 2 to rebuild the "
                    "DirectForm1 history")
            _, _, u2, y2, _ = vals2[idx]
            out.append({"x1": u1, "x2": u2, "y1": y1, "y2": y2})
    return out


def one_pole_pair(x, kind1: str, r1: float, kind2: str, r2: float,
                  h: float, z1, z2):
    """Fused ``sec1 -> (scale h) -> sec2`` one-pole cascade: the
    two-section :func:`linear_cascade` (the compiler calls linear_cascade
    itself).  Returns ``(y, z1_new, z2_new)``."""
    sections = ((kind1, float(r1)), ("gain", float(h)), (kind2, float(r2)))
    x = torch.as_tensor(x, dtype=torch.float32)
    batch = x.shape[:-1]
    zs = [{"z": torch.as_tensor(z, dtype=torch.float32,
                                device=x.device).expand(batch)}
          for z in (z1, z2)]
    y, s_tm1, s_tm2 = linear_cascade(x, sections,
                                     cascade_state_in(sections, zs))
    x_tm2 = x[..., -2] if x.shape[-1] >= 2 else torch.zeros_like(x[..., -1])
    st1, st2 = cascade_state_out(sections, s_tm1, s_tm2, x[..., -1], x_tm2)
    return y, st1["z"], st2["z"]
