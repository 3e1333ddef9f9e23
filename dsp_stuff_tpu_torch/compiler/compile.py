"""Graph compiler of the port: effect graph -> render program.

This replaces the reference's runtime layer (task-per-node + SPSC pipes +
emergent dataflow scheduling, runtime.rs:614-752, node.rs:267-352) with a
plan made once per graph:

* links dissolve into values (fan-out = value reuse);
* fan-in becomes the reference's averaging mix ``sum / (n + 1e-4)``
  (node.rs:162-194, divisor quirk SURVEY.md 2.4 #1);
* modulation (`as_input`) ports apply the [-1,1] -> slider-range mapping
  of the derive macro (dsp-stuff-derive/src/lib.rs:135-153);
* acyclic nodes evaluate one *full sequence* at a time in topological
  order; under the ``fast`` policy maximal chains of linear + shaper +
  comb + chorus nodes run as ONE ops/chain_segment (the chain kernel on a
  CUDA device) and the remaining linear runs as one ops/cascade solve
  each;
* the other stateless per-sample nodes (gains, adds, mixes, the shapers at
  base rate, and the Output nodes' fan-in averages) gather into pointwise
  groups, each one straight-line program (compiler/pointwise.py) that
  runs as one generated kernel on a CUDA device (ops/pointwise_kernel.py),
  its backward one generated reverse kernel (ops/pointwise_reverse_
  kernel.py), what XLA's loop fusion gives the JAX package inside
  ``jax.jit`` and ``jax.grad`` through it;
* the fan-ins read outside the groups (a run head's, a node's that runs
  on its own, an analysis sink's) go with them (``_plan_fanins``): an
  average that a group's Output member already writes is taken from it;
  one whose sources one group writes, mapped where a modulation port
  reads it, is an output of that group; an input port's of several
  sources, or a modulation port's, that no group writes is a one-form
  group; a single source that no group computes stays the eager divide
  (one launch either way, and a group call's host work outweighs the
  eager op's); the knob writeback averages one sample;
* each feedback SCC evaluates over 128-sample blocks, an intra-cycle edge
  from a not-yet-run member carrying exactly one block of delay (the
  defined semantic of the reference's emergent pipe latency): under
  ``fast``, when every member lowers, as ONE ops/cycle_segment block
  program (the cycle kernel on a CUDA device), otherwise as a per-node
  scan over the blocks (on a CUDA device its block loop captured in CUDA
  graphs and replayed, compiler/cycle_loop.py), whose block gathers its
  stateless members into pointwise groups as well;
* Input nodes bind external source columns, Output nodes produce rendered
  channels, analysis sinks produce aux arrays.

Streams batch as leading dimensions of every signal; node states
broadcast against them.
"""

from __future__ import annotations

import functools
import heapq
from typing import Any, NamedTuple

import numpy as np
import torch

from dsp_stuff_tpu_torch.compiler import pointwise
from dsp_stuff_tpu_torch.compiler.cycle_loop import CycleLoops
from dsp_stuff_tpu_torch.compiler.scc import condensation_topo_order
from dsp_stuff_tpu_torch.graph import Graph, GraphNode
from dsp_stuff_tpu_torch.ops import cascade
from dsp_stuff_tpu_torch.ops import chain_segment as _cs
from dsp_stuff_tpu_torch.ops.cycle_segment import cycle_segment
from dsp_stuff_tpu_torch.ops.delay_line import delay_samples
from dsp_stuff_tpu_torch.ops.lockstep import advance, oldest_first
from dsp_stuff_tpu_torch.ops.modfx import (max_delay_samples, mtap_shared,
                                           mtap_static)
from dsp_stuff_tpu_torch.ops.pointwise_kernel import group_call
from dsp_stuff_tpu_torch.registry import ParamSpec
from dsp_stuff_tpu_torch.utils import precision
from dsp_stuff_tpu_torch.utils.sliders import Data

EXTERNAL = "__external__"

# Optional per-node instrumentation hook: when set to a callable
# (node_id, cfg_name, outs_dict) it is invoked after every node evaluation
# (utils/obs.debug_render uses it for per-node stats; the reference's
# analog is #[tracing::instrument] on process(), e.g. gain.rs:26).  While
# it is set the fused paths (chain segments, linear runs, cycle programs)
# stand down, so every node reports; in a feedback SCC it fires once per
# node and block, with the block's values.  None (the default) costs
# nothing.
NODE_HOOK = None

#: structural switch of the feedback-cycle block program, read at every
#: render: False sends every feedback SCC to the per-node scan (tests flip
#: it to pin the fused cycle against that scan, as the JAX package's do)
CYCLE_FUSION = True

#: structural switch of the pointwise groups, read at every render: False
#: runs every stateless node as its eager ops (tests and chip_smoke.py
#: flip it to hold the groups against those ops)
POINTWISE_FUSION = True

#: structural switch of the fan-ins the pointwise groups take
#: (``_plan_fanins``), read at every render: False averages every fan-in
#: outside the groups with its eager ops where it is read, the route
#: before them (tests and chip_smoke.py flip it to hold the two against
#: each other)
FANIN_GROUPS = True

#: operands a pointwise group takes at most (the kernel's parameters hold
#: their pointers): a group stops growing before its estimate passes it
GROUP_OPERANDS = 96

_F32 = torch.float32


def apply_knob_writeback(graph: Graph, aux) -> Graph:
    """Fold ``aux["__knobs__"]`` back into the graph's slider settings (on
    the host): each knob's last value as a Python float, so that a save
    after a render shows the knob positions the reference's UI would
    (quirk SURVEY.md 2.4 #9).  Returns ``graph``."""
    for key, val in (aux.get("__knobs__") or {}).items():
        nid_s, pname = key.split(":", 1)
        flat = (val.detach().reshape(-1) if isinstance(val, torch.Tensor)
                else np.asarray(val).ravel())
        graph.nodes[int(nid_s)].params[pname] = float(flat[-1])
    return graph


def _fanin_divisor(n: int) -> np.float32:
    """num_frames starts at 0.0001 and gains 1.0 per connected pipe, in f32
    (node.rs:166,179,190-192)."""
    d = np.float32(0.0001)
    for _ in range(n):
        d = np.float32(d + np.float32(1.0))
    return d


def _divisor_on(n: int, device: torch.device) -> torch.Tensor:
    """The fan-in divisor of n sources as a 0-d f32 tensor on ``device``
    (a true f32 divide on the card, precision.scalar_on)."""
    return precision.scalar_on(float(_fanin_divisor(n)), device)


def _avg(sources: list, T: int, device=None):
    """Fan-in average; returns (signal [..., T], n_connected).

    Sources sum in ``graph.links`` insertion order (== ascending LinkId in
    the reference, runtime.rs:118-120) as the f32 chain ``(s0+s1)+s2``,
    then one true f32 divide (node.rs:190-192) under every policy, on the
    CPU and the card alike."""
    n = len(sources)
    if n == 0:
        return torch.zeros((T,), dtype=_F32, device=device), 0
    acc = sources[0]
    for s in sources[1:]:
        acc = acc + s
    return acc / _divisor_on(n, acc.device), n


def _fanin_key(graph: Graph, nid: int, port: str, p=None) -> tuple:
    """What a port's fan-in computes, whoever reads it: ("avg", sources)
    for an input port, ("mod", (sources, lo, hi)) for a modulation port
    ``p`` (the average mapped, ``_map_mod``), the sources (nid, port) in
    link order.  Two ports with one key read one tensor."""
    srcs = tuple((l.src, l.src_port) for l in graph.in_links(nid, port))
    return ("avg", srcs) if p is None else ("mod", (srcs, p.lo, p.hi))


def _on_batch(tree, batch):
    """Every tensor in ``tree`` broadcast to leading dims ``batch``."""
    if isinstance(tree, dict):
        return {k: _on_batch(v, batch) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_on_batch(v, batch) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.expand(*batch, *tree.shape)
    return tree


def _map_mod(sig, p: ParamSpec):
    """Modulation-signal -> slider-range mapping (lib.rs:140-148):
    y=(x+1)/2; z=clamp(y,0,1); lo + (hi-lo)*z, all f32."""
    y = (sig + 1.0) / 2.0
    z = torch.clamp(y, 0.0, 1.0)
    span = float(np.float32(np.float32(p.hi) - np.float32(p.lo)))
    return float(np.float32(p.lo)) + span * z


def _mod_params(node: GraphNode) -> list:
    """The ParamSpecs of a node's modulation ports (``as_input``)."""
    return [p for p in node.spec.params
            if isinstance(p, ParamSpec) and p.as_input]


def _fanin_sites(node: GraphNode) -> list:
    """A node's ports that read a fan-in, as ``_plan_fanins`` sites:
    (nid, port, None) for an input port, (nid, name, its ParamSpec) for
    a modulation port."""
    return ([(node.id, port, None) for port in node.spec.inputs]
            + [(node.id, p.name, p) for p in _mod_params(node)])


def _call(impl, params, state, inputs, T: int, block_size: int):
    """A node's full-sequence evaluation; a source that needs the render
    length (``needs_length``) gets T and the block size."""
    if getattr(impl, "needs_length", False):
        return impl.process_seq(params, state, inputs, T=T,
                                block_size=block_size)
    return impl.process_seq(params, state, inputs)


def _call_block(impl, params, state, inputs, block_size: int):
    """A node's evaluation of one block inside the per-node cycle scan
    (``process_block`` where the node has one)."""
    fn = getattr(impl, "process_block", impl.process_seq)
    if getattr(impl, "needs_length", False):
        return fn(params, state, inputs, T=block_size, block_size=block_size)
    return fn(params, state, inputs)


def _cycle_key(comp) -> str:
    """State key of a feedback SCC's carried previous-block outputs."""
    return f"__cycle__{min(comp)}"


def _is_cycle(graph: Graph, comp) -> bool:
    return len(comp) > 1 or any(l.src == l.dst == comp[0]
                                for l in graph.links)


def _active_nodes(graph: Graph) -> set[int]:
    """Nodes with at least one connected link (the reference never starts a
    node with zero connections, runtime.rs:661-668)."""
    act = set()
    for l in graph.links:
        act.add(l.src)
        act.add(l.dst)
    return act


#: graph node types that are linear systems fusable into one blocked
#: solve (ops/cascade.py), and their section kinds
_LINEAR_KINDS = {"gain": "gain", "low_pass": "lp", "high_pass": "hp",
                 "biquad": "bq"}

#: stateful node types that keep a chain segment worthwhile
_MEGA_STATEFUL = ("low_pass", "high_pass", "biquad", "reverb", "chorus")

#: stateless shapers a cycle block program takes
_CYCLE_EW = ("distort", "overdrive", "chebyshev")


def _concrete(v) -> bool:
    return isinstance(v, (int, float, np.floating))


def _chorus_mega_geo(node):
    """(L, NH, EV, RS) of a chorus node's mtap stage, or None when its LFO
    geometry does not lower (non-concrete params, too fast or deep an LFO,
    too small a minimum delay: ops/modfx.mtap_static)."""
    ps = [node.params.get(k) for k in ("rate", "depth", "base", "mix")]
    if not all(_concrete(v) for v in ps):
        return None
    L = max_delay_samples(float(ps[2]), float(ps[1]))
    geo = mtap_static(float(ps[0]), float(ps[1]), float(ps[2]), L)
    return None if geo is None else (L, *geo)


def _cyclic(graph: Graph, sccs) -> set[int]:
    return {n for comp in sccs if _is_cycle(graph, comp) for n in comp}


def _out_links(graph: Graph):
    out: dict[int, list] = {}
    modded = set()
    for l in graph.links:
        out.setdefault(l.src, []).append(l)
        if l.dst_port != "in":
            modded.add(l.dst)
    return out, modded


def _sole_joint(graph: Graph, out_links, nid, ok) -> int | None:
    """The downstream node id when nid's output has exactly one chain-joint
    candidate: a link into an ``ok`` node's "in" port that is that port's
    sole source.  Other outgoing links are allowed (they become taps); two
    candidates make the chain ambiguous, so none is taken."""
    joints = [l.dst for l in out_links.get(nid, [])
              if l.dst_port == "in" and l.dst != nid
              and len(graph.in_links(l.dst, "in")) == 1 and ok(l.dst)]
    return joints[0] if len(joints) == 1 else None


def _chains(nxt: dict) -> list[list[int]]:
    """Maximal chains of the successor map ``nxt``, by ascending head id."""
    targets = set(nxt.values())
    chains = []
    for nid in sorted(nxt):
        if nid in targets:
            continue
        chain = [nid]
        while chain[-1] in nxt:
            chain.append(nxt[chain[-1]])
        chains.append(chain)
    return chains


def _plan_mega_fusion(graph: Graph, nodes: dict, sccs) -> list:
    """Maximal ACYCLIC chains of mega-fusable nodes (the linear kinds +
    distort/overdrive/chebyshev at base rate + reverb + a chorus whose LFO
    lowers) joined by chain links, evaluated as ONE ops/chain_segment.
    Members of a feedback SCC never join a run.

    Extra consumers of a member's output do not end the chain: the
    segment emits that intermediate with a ("tap", ti) stage.  A run must
    have >= 2 nodes, >= 1 stateful member and >= 1 non-linear member
    (pure-linear runs belong to _plan_linear_fusion)."""
    out_links, modded = _out_links(graph)
    cyclic = _cyclic(graph, sccs)

    def mega_ok(nid) -> bool:
        node = nodes.get(nid)
        if node is None or nid in modded or nid in cyclic:
            return False
        cn = node.cfg_name
        if cn in _LINEAR_KINDS or cn in ("chebyshev", "reverb"):
            return True
        if cn in ("distort", "overdrive"):
            return str(node.params.get("oversample", "1")) == "1"
        if cn == "chorus":
            return _chorus_mega_geo(node) is not None
        return False

    nxt = {}
    for nid in nodes:
        if mega_ok(nid):
            dst = _sole_joint(graph, out_links, nid, mega_ok)
            if dst is not None:
                nxt[nid] = dst
    return [chain for chain in _chains(nxt) if _mega_worthy(nodes, chain)]


def _mega_worthy(nodes: dict, run) -> bool:
    """A mega run needs >= 2 nodes, >= 1 stateful member and >= 1
    non-linear member (pure-linear runs belong to _plan_linear_fusion)."""
    kinds = [nodes[n].cfg_name for n in run]
    return (len(run) >= 2 and any(k in _MEGA_STATEFUL for k in kinds)
            and any(k not in _LINEAR_KINDS for k in kinds))


def _plan_linear_fusion(graph: Graph, nodes: dict, sccs,
                        exclude: frozenset = frozenset()) -> list:
    """Maximal runs of adjacent linear nodes fusable into one
    ops/cascade.linear_cascade solve, as lists of node ids in signal order:
    acyclic runs and in-cycle runs alike (the eval sites tell them apart
    by membership).

    Consecutive nodes are joined by a chain link (the downstream "in" has
    exactly that one source); no member receives links on any other port;
    the composite state dimension is capped at cascade.MAX_RUN_DIM (longer
    chains split greedily); a run keeps >= 2 nodes and >= 1 stateful
    section.  Other consumers of an intermediate become emitted taps, so
    runs evaluate at their HEAD node's position.

    A run inside a feedback SCC must also occupy CONSECUTIVE positions of
    the cycle's execution order (ascending ids): then every link inside
    the run is a same-block forward edge and every edge in or out of it
    reads the current or the previous block exactly as unfused.  Runs
    never span SCC boundaries."""
    out_links, modded = _out_links(graph)
    cyclic = _cyclic(graph, sccs)

    def linear(nid) -> bool:
        node = nodes.get(nid)
        return (node is not None and node.cfg_name in _LINEAR_KINDS
                and nid not in modded and nid not in exclude)

    def dim(nid) -> int:
        return cascade.SECTION_DIMS[_LINEAR_KINDS[nodes[nid].cfg_name]]

    def segments(nxt) -> list:
        runs = []
        for chain in _chains(nxt):
            seg: list = []
            d = 0
            for n in chain + [None]:
                if n is None or d + dim(n) > cascade.MAX_RUN_DIM:
                    if len(seg) >= 2 and d >= 1:
                        runs.append(seg)
                    seg, d = [], 0
                if n is not None:
                    seg.append(n)
                    d += dim(n)
        return runs

    def acyclic_linear(nid) -> bool:
        return linear(nid) and nid not in cyclic

    nxt = {}
    for nid in nodes:
        if acyclic_linear(nid):
            dst = _sole_joint(graph, out_links, nid, acyclic_linear)
            if dst is not None:
                nxt[nid] = dst
    runs = segments(nxt)

    for comp in sccs:
        if not _is_cycle(graph, comp):
            continue
        pos = {nid: i for i, nid in enumerate(sorted(comp))}
        cnxt = {}
        for nid in comp:
            if not linear(nid):
                continue
            dst = _sole_joint(graph, out_links, nid,
                              lambda d: linear(d) and d in pos)
            if dst is not None and pos[dst] == pos[nid] + 1:
                cnxt[nid] = dst
        runs.extend(segments(cnxt))
    return runs


def _pointwise_ok(node: GraphNode) -> bool:
    """Whether a node is stateless per-sample ops that a pointwise group
    takes (compiler/pointwise.node_form), or an Output, whose fan-in
    average the group computes."""
    return (node.cfg_name == "output"
            or pointwise.node_form(node.cfg_name, node.params) is not None)


def _group_cost(graph: Graph, nodes: dict, members, fanins=()) -> int:
    """An upper bound on a group's operands: per member its in-links (each
    a signal operand at most), a divisor per input port, its sliders and
    its out-links (each an output at most); per fan-in it writes for a
    reader outside it (``fanins``) an output and a divisor."""
    n = 2 * len(fanins)
    for nid in members:
        spec = nodes[nid].spec
        n += sum(1 for l in graph.links if l.dst == nid or l.src == nid)
        n += len(spec.all_inputs) + len(spec.params)
    return n


def _plan_pointwise(graph: Graph, nodes: dict, sccs,
                    claimed: frozenset = frozenset()) -> tuple:
    """The pointwise groups: maximal sets of acyclic nodes that a group
    takes (``_pointwise_ok``) and nothing else claims (``claimed``: the
    members of this render's mega runs and linear runs and the Outputs a
    mega run folds), as tuples of node ids in SCC order.

    A node joins the group of a node it reads from (the first, by SCC
    order, that takes it), and groups it reads from merge, while the
    group stays CONVEX (no node outside it lies on a path between two
    members, so it can run at one point of the order, ``_unit_order``)
    and its operands stay within GROUP_OPERANDS."""
    cyclic = _cyclic(graph, sccs)
    pos = {n: i for i, comp in enumerate(sccs) for n in comp}
    succ: dict[int, set] = {n: set() for n in nodes}
    pred: dict[int, set] = {n: set() for n in nodes}
    for l in graph.links:
        if l.src in nodes and l.dst in nodes:
            succ[l.src].add(l.dst)
            pred[l.dst].add(l.src)

    def reach(start, nbrs) -> set:
        seen: set = set()
        stack = [m for s in start for m in nbrs[s]]
        while stack:
            m = stack.pop()
            if m not in seen:
                seen.add(m)
                stack.extend(nbrs[m])
        return seen

    def fits(members) -> bool:
        s = set(members)
        return (not (reach(s, succ) & reach(s, pred)) - s
                and _group_cost(graph, nodes, s) <= GROUP_OPERANDS)

    groups: list[list[int]] = []
    gid: dict[int, int] = {}
    for n in sorted(nodes, key=pos.get):
        if n in cyclic or n in claimed or not _pointwise_ok(nodes[n]):
            continue
        home = None
        for g in sorted({gid[p] for p in pred[n] if p in gid},
                        key=lambda g: pos[groups[g][0]]):
            if home is None:
                if fits(groups[g] + [n]):
                    home = g
                    groups[g].append(n)
            elif fits(groups[home] + groups[g]):
                for m in groups[g]:
                    gid[m] = home
                groups[home] += groups[g]
                groups[g] = []
        if home is None:
            home = len(groups)
            groups.append([n])
        gid[n] = home
    return tuple(tuple(sorted(g, key=pos.get)) for g in groups if g)


def _plan_cycle_groups(graph: Graph, nodes: dict, order,
                       claimed: frozenset = frozenset(),
                       skipped: frozenset = frozenset()) -> tuple:
    """The pointwise groups of a feedback SCC's per-node scan
    (``_CycleScan``), as tuples of member ids in the block's order
    (``order``, ascending ids).

    A group is a run of members that a group takes (``_pointwise_ok``)
    and no in-cycle fused run claims (``claimed``), standing next to each
    other in that order once the members ``skipped`` (a fused run's
    interior, evaluated at its head) are left out, each after the first
    reading an earlier one, within GROUP_OPERANDS.  It runs at its first
    member's position: no other member runs between its members, so no
    edge changes between the current and the previous block (a member
    reads an earlier member's current block, its own and a later one's
    previous block, as member by member)."""
    groups: list = []
    run: list = []
    for nid in order:
        if nid in skipped:
            continue
        if nid in claimed or not _pointwise_ok(nodes[nid]):
            if run:
                groups.append(tuple(run))
            run = []
            continue
        if run and any(l.dst == nid and l.src in run for l in graph.links) \
                and _group_cost(graph, nodes, run + [nid]) <= GROUP_OPERANDS:
            run.append(nid)
            continue
        if run:
            groups.append(tuple(run))
        run = [nid]
    if run:
        groups.append(tuple(run))
    return tuple(groups)


def _plan_fanins(graph: Graph, nodes: dict, groups, sites, runs_before,
                 one_form: bool = True) -> tuple:
    """The fan-ins read outside the pointwise ``groups`` that a group
    computes: (writes, taken, solo).  ``sites`` lists the ports that read
    them, (nid, port, the ParamSpec of a modulation port or None), and
    ``runs_before(g, nid)`` whether group g runs before nid reads.  A
    site's fan-in (``_fanin_key``), by the first rule that holds:

    * the average that an Output member of a group writes, of the same
      sources in the same link order, where that group runs first;
    * an output of the group whose members write all its sources, where
      it runs first and its operands stay within GROUP_OPERANDS: the
      member outputs that only such fan-ins read are no longer written
      (``CompiledGraph._lower``);
    * with ``one_form``, a one-form group (``pointwise.avg``, and
      ``pointwise.map_mod`` for a modulation port: one launch in place of
      n adds, a divide and the map's five ops) for an input port of two
      or more sources or a modulation port;
    * else its eager ops: a single source that no group computes is one
      divide, and a one-form group, one launch too, would add a group
      call's host work, which outweighs the eager op's where the host
      launches each block (the per-node scan's Python loop, PERF.md
      section 6).

    ``writes[g]`` lists group g's fan-in outputs as (key, the ports that
    read it), ``taken`` maps each site a group or a one-form group serves
    to its key, ``solo`` holds the one-form groups' keys."""
    gid = {n: i for i, g in enumerate(groups) for n in g}
    averaged: dict = {}
    for i, g in enumerate(groups):
        for n in g:
            if nodes[n].cfg_name == "output":
                averaged.setdefault(_fanin_key(graph, n, "in"), i)
    writes: list = [{} for _ in groups]
    taken: dict = {}
    solo: set = set()
    for nid, port, p in sites:
        ls = graph.in_links(nid, port)
        if not ls:
            continue
        key = _fanin_key(graph, nid, port, p)
        i = averaged.get(key)
        if i is not None and runs_before(i, nid):
            taken[(nid, port)] = key
            continue
        owners = {gid.get(l.src) for l in ls}
        if len(owners) == 1 and None not in owners:
            i = owners.pop()
            w = writes[i]
            if runs_before(i, nid) and (key in w or _group_cost(
                    graph, nodes, groups[i], (*w, key)) <= GROUP_OPERANDS):
                w.setdefault(key, []).append((nid, port))
                taken[(nid, port)] = key
                continue
        if one_form and (len(ls) > 1 or p is not None):
            solo.add(key)
            taken[(nid, port)] = key
    return (tuple(tuple((k, tuple(v)) for k, v in w.items()) for w in writes),
            taken, frozenset(solo))


class _FaninPlan(NamedTuple):
    """A render's fan-ins outside its groups (``_plan_fanins``): each
    group's fan-in outputs by its members, the sites served and the
    one-form groups' keys."""
    writes: dict
    taken: dict
    solo: frozenset


def _unit_order(graph: Graph, sccs, groups) -> tuple:
    """The render's units in evaluation order: each pointwise group as one
    unit ("group", members) and every other SCC as ("scc", comp), each
    after every unit it reads from (the members' SCCs stand down); among
    units ready together the one whose first node comes first in SCC
    order."""
    units: list = [("group", g) for g in groups]
    unit_of = {n: i for i, g in enumerate(groups) for n in g}
    for comp in sccs:
        if comp[0] not in unit_of:
            for n in comp:
                unit_of[n] = len(units)
            units.append(("scc", tuple(comp)))
    pos = {n: i for i, comp in enumerate(sccs) for n in comp}
    first = [min(pos[n] for n in u[1]) for u in units]
    deps: list[set] = [set() for _ in units]
    for l in graph.links:
        a, b = unit_of.get(l.src), unit_of.get(l.dst)
        if a is not None and b is not None and a != b:
            deps[b].add(a)
    users: list[list] = [[] for _ in units]
    for b, ds in enumerate(deps):
        for a in ds:
            users[a].append(b)
    left = [len(ds) for ds in deps]
    ready = [(first[i], i) for i in range(len(units)) if not left[i]]
    heapq.heapify(ready)
    order = []
    while ready:
        _, i = heapq.heappop(ready)
        order.append(units[i])
        for j in users[i]:
            left[j] -= 1
            if not left[j]:
                heapq.heappush(ready, (first[j], j))
    return tuple(order)


def _linear_section(node: GraphNode):
    """The (kind, param) cascade section of a linear node, or None for a
    non-concrete parameter."""
    kind = _LINEAR_KINDS[node.cfg_name]
    if kind == "gain":
        lvl = node.params["level"]
        return ("gain", float(np.float32(lvl))) if _concrete(lvl) else None
    if kind in ("lp", "hp"):
        r = node.params["ratio"]
        return (kind, float(r)) if _concrete(r) else None
    raw = [node.params[k] for k in ("a0", "a1", "a2", "b0", "b1", "b2")]
    if not all(_concrete(v) for v in raw):
        return None
    # same f32 division as BiQuad (biquad.rs:64-71)
    a0 = np.float32(raw[0])
    return ("bq", tuple(float(np.float32(np.float32(v) / a0))
                        for v in raw[1:]))


def _resolve_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" gets the current card's index.
    Raises when a CUDA device is asked for and there is none: the port
    never carries on on the CPU unless the caller says device="cpu"."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device is available for device={str(device)!r} "
                f"(the default); pass device=\"cpu\" to render on the CPU")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


class CompiledGraph:
    """A graph planned for rendering on one ``device``.

    ``render`` evaluates it; states and parameters are dicts keyed by
    ``str(node_id)``, as in the JAX package (convert.py carries them
    across).  Every tensor the object makes lives on ``device``, and
    tensors handed in on another device raise."""

    def __init__(self, graph: Graph, block_size: int, device, nodes: dict,
                 sccs: list, mega_plan: list, fusion_plan: list):
        self.graph = graph
        self.block_size = block_size
        self.device = _resolve_device(device)
        self.input_ids = sorted(n.id for n in nodes.values()
                                if getattr(n.spec.impl, "graph_input", False))
        self.output_ids = sorted(n.id for n in nodes.values()
                                 if getattr(n.spec.impl, "graph_output", False))
        self.sink_ids = sorted(
            n.id for n in nodes.values()
            if n.spec.is_sink and not getattr(n.spec.impl, "graph_output",
                                              False))
        #: the analysis sinks, evaluated after every unit (their aux)
        self._analyzed = tuple(n for n in self.sink_ids
                               if hasattr(nodes[n].spec.impl, "analyze"))
        self._nodes = nodes
        self._sccs = sccs
        self._mega_plan = mega_plan
        self._fusion_plan = fusion_plan
        #: the per-node cycle scans' loops over static buffers, and on the
        #: card their captured CUDA graphs (compiler/cycle_loop.py)
        self.cycle_loops = CycleLoops(self)
        #: claimed node set -> (pointwise groups, unit order), planned
        #: once per set (``_pointwise_plan``); (SCC, claimed set) -> a
        #: per-node scan's groups (``_cycle_groups``)
        self._pointwise_plans: dict = {}

    # -- state and parameters ---------------------------------------------

    def _on_device(self, v, what: str):
        if isinstance(v, torch.Tensor):
            if v.device != self.device:
                raise ValueError(f"{what} is on {v.device}; the graph was "
                                 f"compiled for {self.device}")
            return v.to(_F32)
        return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

    def init_state(self) -> dict:
        out = {}
        for nid, node in self._nodes.items():
            st = node.spec.impl.init_state(node.params, self.block_size)
            if isinstance(st, dict):
                st = {k: (v.to(self.device) if isinstance(v, torch.Tensor)
                          else v) for k, v in st.items()}
            out[str(nid)] = st
        # per-cycle previous-block outputs: the one block of delay on an
        # intra-cycle back edge is real state and chains across renders
        for comp in self._sccs:
            if _is_cycle(self.graph, comp):
                out[_cycle_key(comp)] = {
                    f"{nid}:{port}": torch.zeros((self.block_size,),
                                                 dtype=_F32, device=self.device)
                    for nid in comp for port in self._nodes[nid].spec.outputs}
        return out

    def init_params(self, requires_grad: bool = False) -> dict:
        """{node_id: {param: f32 scalar tensor}} holding every non-static
        slider at the graph's value: leaf tensors on the graph's device,
        which an optimizer takes (train/fit.py).  Pass (a changed copy of)
        it as ``render(params=...)`` to override the graph's values."""
        out = {}
        for nid, node in self._nodes.items():
            entry = {p.name: torch.tensor(float(np.float32(node.params[p.name])),
                                          dtype=_F32, device=self.device,
                                          requires_grad=requires_grad)
                     for p in node.spec.params
                     if isinstance(p, ParamSpec) and not p.static}
            if entry:
                out[str(nid)] = entry
        return out

    def broadcast_state(self, state: dict, batch_shape: tuple[int, ...]):
        """Tile a state across leading batch dimensions (each stream gets
        its own copy); Python ints (lockstep positions) stay shared."""
        def tile(v):
            if isinstance(v, torch.Tensor):
                return v.expand(*batch_shape, *v.shape).clone()
            return v
        return {k: ({kk: tile(vv) for kk, vv in st.items()}
                    if isinstance(st, dict) else st)
                for k, st in state.items()}

    @functools.cached_property
    def _state_ndims(self) -> dict:
        """{state key: {entry: ndim of the unbatched tensor}}."""
        return {k: {kk: v.dim() for kk, v in st.items()
                    if isinstance(v, torch.Tensor)}
                for k, st in self.init_state().items()
                if isinstance(st, dict)}

    def _batched_state(self, state: dict, batch_shape: tuple[int, ...]):
        """Every per-stream state tensor on the batch shape, as the JAX
        package's batched state has it: a node that saw no batched signal
        (an LFO, a cycle entry no member wrote) returns an unbatched state,
        which broadcasts here.  Python ints (lockstep counters) stay
        shared."""
        nd = self._state_ndims

        def tile(v, n):
            if not isinstance(v, torch.Tensor):
                return v
            return v.expand(*batch_shape, *v.shape[v.dim() - n:])
        return {k: ({kk: tile(v, nd[k].get(kk, 0)) for kk, v in st.items()}
                    if isinstance(st, dict) else st)
                for k, st in state.items()}

    # -- rendering ----------------------------------------------------------

    def render(self, inputs=None, T: int | None = None, state=None,
               batch_shape: tuple[int, ...] = (), params=None):
        """One-call offline render.

        inputs -- None (silence), an [n_inputs, T] array or tensor, a dict
                  {node_id: [T]}, or with leading batch dimensions
                  [..., n_inputs, T] matching batch_shape.
        Returns (outs [..., n_out, T], aux dict, state)."""
        batch_shape = tuple(batch_shape)
        ext = self._pack_inputs(inputs, T, batch_shape)
        T = next(iter(ext.values())).shape[-1] if ext else T
        if T is None:
            raise ValueError("T is required when the graph has no Input nodes")
        if T % self.block_size:
            raise ValueError(f"T={T} must be a multiple of "
                             f"block_size={self.block_size}")
        if state is None:
            state = self.init_state()
        else:
            for k, st in state.items():
                for kk, v in (st or {}).items():
                    if isinstance(v, torch.Tensor):
                        self._on_device(v, f"state[{k!r}][{kk!r}]")
        state, outs, aux = self.fn(state, ext, params)
        if batch_shape:
            state = self._batched_state(state, batch_shape)
        if self.output_ids:
            sigs = [outs[i] for i in self.output_ids]
            shape = torch.broadcast_shapes(*(s.shape for s in sigs),
                                           (*batch_shape, T))
            out_arr = torch.stack([s.expand(shape) for s in sigs], dim=-2)
        else:
            out_arr = torch.zeros((*batch_shape, 0, T), dtype=_F32,
                                  device=self.device)
        return out_arr, aux, state

    def _pack_inputs(self, inputs, T, batch_shape):
        if inputs is None:
            if T is None:
                raise ValueError("T required to synthesize silent inputs")
            ext = {str(i): torch.zeros((*batch_shape, T), dtype=_F32,
                                       device=self.device)
                   for i in self.input_ids}
            if not ext:
                # length-carrying dummy so fn can infer T
                ext["__len__"] = torch.zeros((*batch_shape, T), dtype=_F32,
                                             device=self.device)
            return ext
        if isinstance(inputs, dict):
            ext = {str(k): self._on_device(v, f"input {k!r}")
                   for k, v in inputs.items()}
            want = 1 + len(batch_shape)
            for k, v in ext.items():
                if v.dim() != want:
                    raise ValueError(
                        f"input {k!r} has shape {tuple(v.shape)}; expected "
                        f"{want}-d [*batch_shape, T] for "
                        f"batch_shape={batch_shape}")
            Td = next(iter(ext.values())).shape[-1] if ext else T
            for i in self.input_ids:
                if str(i) not in ext:
                    ext[str(i)] = torch.zeros((*batch_shape, Td), dtype=_F32,
                                              device=self.device)
            return ext
        arr = self._on_device(inputs, "inputs")
        if arr.dim() == 1:
            arr = arr[None]
        if arr.shape[-2] != len(self.input_ids):
            raise ValueError(f"inputs of shape {tuple(arr.shape)} do not "
                             f"match the graph's {len(self.input_ids)} "
                             f"Input nodes")
        return {str(nid): arr[..., i, :]
                for i, nid in enumerate(self.input_ids)}

    def fn(self, state, ext, params=None):
        """(state, ext, params) -> (new_state, outs {output id: signal},
        aux): one render of ``ext`` (dict of [..., T] input signals)."""
        T = None
        for k, v in ext.items():
            if T is not None and v.shape[-1] != T:
                raise ValueError(
                    f"external inputs disagree on render length: input "
                    f"node {k!r} has T={v.shape[-1]}, others had T={T}")
            T = v.shape[-1]
        if T is None:
            raise ValueError("graphs without Input nodes need a length "
                             "hint; use CompiledGraph.render(T=...)")
        return self._eval(state, ext, T, params)

    # -- evaluation ---------------------------------------------------------

    def _override(self, v, what: str):
        """An override slider: a tensor stays a tensor (on this graph's
        device, f32, its autograd history kept), a stream's slider as data
        (utils/sliders.Data, which a node reads as it reads a float, from
        device buffers) stays a Data, anything else a float."""
        if isinstance(v, torch.Tensor):
            return self._on_device(v, what)
        if isinstance(v, Data):
            return v
        return float(v)

    def _resolve_params(self, node: GraphNode, mods: dict, pdict):
        """params dict with modulation ports resolved; mods maps each
        connected modulation port to its mapped fan-in (``_map_mod``);
        pdict (if given) overrides non-static sliders, its tensors and
        Data passed through to the nodes unchanged.  An overridden member
        leaves the fused runs and cycle programs (``_active_mega``,
        ``_run_sections``, ``_cycle_program``), as in the JAX package,
        whatever its value."""
        over = (pdict or {}).get(str(node.id), {})
        params: dict[str, Any] = {}
        for p in node.spec.params:
            what = f"params[{str(node.id)!r}][{p.name!r}]"
            if isinstance(p, ParamSpec) and p.as_input:
                if p.name in mods:
                    params[p.name] = mods[p.name]
                elif p.name in over:
                    params[p.name] = self._override(over[p.name], what)
                else:
                    params[p.name] = float(node.params[p.name])
            elif isinstance(p, ParamSpec) and p.name in over:
                params[p.name] = self._override(over[p.name], what)
            else:
                params[p.name] = node.params[p.name]
        return params

    def _run_sections(self, run, pdict):
        """(sections, member_end) for a fusable linear run: the section
        tuple with the link fan-in scales interleaved as gain sections, and
        each node id's last section index (the emit point of a tapped
        intermediate) -- or None when a member has overrides or a
        non-concrete parameter."""
        h = 1.0 / float(_fanin_divisor(1))
        secs: list = []
        member_end: dict[int, int] = {}
        for i, nid in enumerate(run):
            if str(nid) in (pdict or {}):
                return None
            sec = _linear_section(self._nodes[nid])
            if sec is None:
                return None
            if i:
                secs.append(("gain", h))
            secs.append(sec)
            member_end[nid] = len(secs) - 1
        return tuple(secs), member_end

    def _run_taps(self, run) -> list[int]:
        """Non-tail run members whose output has a consumer besides the
        chain link to the next member: the fused solve must emit them."""
        internal = set(zip(run[:-1], run[1:]))
        return [nid for nid in run[:-1]
                if any(l.src == nid and (nid, l.dst) not in internal
                       for l in self.graph.links)]

    def _mega_stages(self, run, pdict):
        """(stages, state_specs, head_single, out_fold, tapped) for a mega
        run in ops/chain_segment's stage grammar, or None when a member has
        overrides or a non-concrete parameter.

        Adjacent linear members collapse into shared ("cascade", sections)
        stages (split at cascade.MAX_RUN_DIM) with the link fan-in scales
        interleaved as gain sections; scales between non-linear stages
        accumulate into one ("scale", s).  state_specs parallels the
        stateful stages: ("cascade", sections, stateful_ids) | ("comb",
        nid) | ("mtap", nid, rate, depth, base, L).  ``tapped`` lists the
        members emitted by ("tap", ti) stages.

        Two boundary scale folds keep the segment one read and one write:
        ``head_single`` (the head's single in-link scale seeds the pending
        scale, so the eval skips _avg) and ``out_fold`` (the tail's sole
        consumer is a single-source Output, whose fan-in scale appends as
        a trailing stage).  Both replace the fan-in divide by a multiply
        with the f32 reciprocal, the fast policy's documented 1-ulp class."""
        graph = self.graph
        h = 1.0 / float(_fanin_divisor(1))
        stages: list = []
        specs: list = []
        cur: list = []          # open cascade: (kind, param) sections
        cur_ids: list = []      # stateful member node ids of cur
        cur_dim = 0
        head_single = len(graph.in_links(run[0], "in")) == 1
        pend = h if head_single else 1.0   # pending scale before next stage
        tail_out = [l for l in graph.links if l.src == run[-1]]
        out_fold = None
        if (len(tail_out) == 1 and tail_out[0].dst_port == "in"
                and tail_out[0].dst in self.output_ids
                and len(graph.in_links(tail_out[0].dst, "in")) == 1):
            out_fold = tail_out[0].dst

        def close():
            nonlocal cur, cur_ids, cur_dim, pend
            if not cur:
                return
            if cur_dim == 0:
                # stateless (pure-gain) group: fold into the running scale
                for _, v in cur:
                    pend *= float(v)
            else:
                stages.append(("cascade", tuple(cur)))
                specs.append(("cascade", tuple(cur), tuple(cur_ids)))
            cur, cur_ids, cur_dim = [], [], 0

        def flush_scale():
            nonlocal pend
            if pend != 1.0:
                stages.append(("scale", float(np.float32(pend))))
                pend = 1.0

        tap_set = set(self._run_taps(run))
        tapped: list[int] = []
        for i, nid in enumerate(run):
            if str(nid) in (pdict or {}):
                return None
            node = self._nodes[nid]
            cn = node.cfg_name
            if cn in _LINEAR_KINDS:
                sec = _linear_section(node)
                if sec is None:
                    return None
                d = cascade.SECTION_DIMS[sec[0]]
                if cur and cur_dim + d > cascade.MAX_RUN_DIM:
                    close()
                if cur:
                    cur.append(("gain", h))
                else:
                    if i:
                        pend *= h
                    if pend != 1.0:
                        cur.append(("gain", float(np.float32(pend))))
                        pend = 1.0
                cur.append(sec)
                if d:
                    cur_ids.append(nid)
                cur_dim += d
            else:
                close()
                if i:
                    pend *= h
                if cn == "reverb":
                    dec = node.params["decay"]
                    if not _concrete(dec):
                        return None
                    flush_scale()
                    D = delay_samples(float(node.params["seconds"]))
                    stages.append(("comb", float(np.float32(dec)), int(D)))
                    specs.append(("comb", nid))
                elif cn == "chorus":
                    geo = _chorus_mega_geo(node)
                    if geo is None:
                        return None
                    L, NH, EV, RS = geo
                    flush_scale()
                    stages.append(("mtap",
                                   float(np.float32(node.params["mix"])),
                                   int(L), int(NH), int(EV), int(RS)))
                    specs.append(("mtap", nid, float(node.params["rate"]),
                                  float(node.params["depth"]),
                                  float(node.params["base"]), int(L)))
                else:
                    keys = {"overdrive": ("boost", "drive", "level"),
                            "chebyshev": ("level_pos", "level_neg")
                            }.get(cn, ("level",))
                    ps = [node.params[k] for k in keys]
                    if not all(_concrete(v) for v in ps):
                        return None
                    flush_scale()
                    kind = cn if cn != "distort" \
                        else f"distort:{node.params['mode']}"
                    stages.append(("ew", kind,
                                   tuple(float(np.float32(v)) for v in ps)))
            if nid in tap_set:
                # the tap point is the node's OWN output: close the open
                # cascade and flush any folded scale before emitting
                close()
                flush_scale()
                stages.append(("tap", len(tapped)))
                tapped.append(nid)
        close()
        if out_fold is not None:
            pend *= h
        flush_scale()
        return (tuple(stages), tuple(specs), head_single, out_fold,
                tuple(tapped))

    def _active_mega(self, pdict):
        """(head id -> (run, stages, specs, head_single, out_fold, tapped),
        non-head member ids) for the mega runs this render fuses: fast
        policy only.  Members with override sliders (``pdict``) run node
        by node and split their run: each stretch of the others between
        them that still makes a mega run fuses, so a fit of some sliders
        keeps the rest of the chain on the chain kernel."""
        if (not self._mega_plan or NODE_HOOK is not None
                or precision.get_policy().name != "fast"):
            return {}, set()
        heads: dict[int, tuple] = {}
        interior: set = set()
        over = pdict or {}
        for plan_run in self._mega_plan:
            subs = [[]]
            for nid in plan_run:
                if str(nid) in over:
                    subs.append([])
                else:
                    subs[-1].append(nid)
            for run in subs:
                if not _mega_worthy(self._nodes, run):
                    continue
                got = self._mega_stages(run, pdict)
                if got is not None:
                    heads[run[0]] = (run, *got)
                    interior.update(run[1:])
        return heads, interior

    def _mega_run_eval(self, run, stages, specs, tapped, x1, st):
        """Evaluate a mega run over its head input ``x1`` [..., T] as one
        ops/chain_segment, updating the member states in ``st``; returns
        {(nid, "out"): signal} for the tail and every tapped member."""
        T_run = x1.shape[-1]
        state_in = []
        for sp in specs:
            if sp[0] == "cascade":
                _, secs, ids = sp
                state_in.append(cascade.cascade_state_in(
                    secs, [st[str(n)] for n in ids]))
            elif sp[0] == "mtap":
                _, nid_m, rate, depth, base, L = sp
                nst = st[str(nid_m)]
                # the trajectory operands are shared by all streams: the
                # chorus clock t0 is lockstep state
                state_in += [nst["hist"], *mtap_shared(
                    rate, depth, base, L, T_run, nst["t0"],
                    device=x1.device)]
            else:
                nst = st[str(sp[1])]
                # the reverb ring oldest-first
                state_in.append(oldest_first(nst["ring"], nst["pos"]))
        y, cinfos, hists, tap_sigs = _cs.chain_segment(x1, stages,
                                                       tuple(state_in))
        ci = hi = 0
        for sp in specs:
            if sp[0] == "cascade":
                _, secs, ids = sp
                for n, ns in zip(ids, cascade.cascade_state_out(
                        secs, *cinfos[ci])):
                    st[str(n)] = ns
                ci += 1
            elif sp[0] == "mtap":
                st[str(sp[1])] = {"hist": hists[hi],
                                  "t0": advance(st[str(sp[1])]["t0"], T_run)}
                hi += 1
            else:
                st[str(sp[1])] = {"ring": hists[hi], "pos": 0}
                hi += 1
        out = {(run[-1], "out"): y}
        for n, sig in zip(tapped, tap_sigs):
            out[(n, "out")] = sig
        return out

    def _active_fusion(self, pdict):
        """(head id -> (run, sections, emits, tapped), non-head member ids)
        for the linear runs this render fuses: fast policy only."""
        if (not self._fusion_plan or NODE_HOOK is not None
                or precision.get_policy().name != "fast"):
            return {}, set()
        heads: dict[int, tuple] = {}
        interior: set = set()
        for run in self._fusion_plan:
            got = self._run_sections(run, pdict)
            if got is None:
                continue
            secs, member_end = got
            tapped = self._run_taps(run)
            heads[run[0]] = (run, secs, tuple(member_end[n] for n in tapped),
                             tapped)
            interior.update(run[1:])
        return heads, interior

    def _fused_run_eval(self, run, secs, emits, tapped, x1, st):
        """Evaluate a fused linear run over its head input ``x1`` (T >= 2),
        updating the per-node states in ``st``; returns {(nid, "out"):
        signal} for the tail and every tapped member."""
        stateful = [n for n in run if cascade.SECTION_DIMS[
            _LINEAR_KINDS[self._nodes[n].cfg_name]] > 0]
        s_in = cascade.cascade_state_in(secs, [st[str(n)] for n in stateful])
        res = cascade.linear_cascade(x1, secs, s_in, emits)
        y, s_tm1, s_tm2 = res[:3]
        emit_sigs = res[3] if emits else ()
        for n, st_new in zip(stateful, cascade.cascade_state_out(
                secs, s_tm1, s_tm2, x1[..., -1], x1[..., -2])):
            st[str(n)] = st_new
        out = {(run[-1], "out"): y}
        for n, sig in zip(tapped, emit_sigs):
            out[(n, "out")] = sig
        return out

    def _cycle_program(self, comp, pdict):
        """Lower a feedback SCC to the ops/cycle_segment block program, or
        None when any member (or this render) cannot.

        Members evaluate in ascending-id order, as in the per-node scan;
        every member output read by another member flows through a
        REGISTER (read before its write, a back edge sees the previous
        block), every output read outside the SCC is TAPPED as a full
        sequence.  Linear members contiguous in that order and joined by
        sole links fold into one cascade (split at MAX_RUN_DIM), with the
        link fan-in scales interleaved as gain sections.  Fan-in divides
        become multiplies by the f32 reciprocal (the fast policy's 1-ulp
        class).  Returns (program, ext_keys, reg_ports, tap_ports,
        state_specs), state_specs in program order:
        ("cascade", sections, stateful_ids) | ("comb", nid)."""
        if self.block_size != 128:
            return None          # the program's block frame is 128
        graph, nodes = self.graph, self._nodes
        order = sorted(comp)
        comp_set = set(order)
        ports_of = {}
        for nid in order:
            node = nodes[nid]
            cn = node.cfg_name
            if str(nid) in (pdict or {}):
                return None
            if cn in ("add", "mix"):
                ports_of[nid] = ("a", "b")
            elif cn in _LINEAR_KINDS or cn == "reverb" or cn in _CYCLE_EW:
                if cn in ("distort", "overdrive") and str(
                        node.params.get("oversample", "1")) != "1":
                    return None
                ports_of[nid] = ("in",)
            else:
                return None
            if cn == "mix" and not _concrete(node.params["ratio"]):
                return None

        in_links: dict[tuple[int, str], list] = {}
        out_links: dict[int, list] = {}
        for l in graph.links:
            if l.dst in comp_set:
                if l.dst_port not in ports_of[l.dst]:
                    return None          # modulated member: the scan path
                in_links.setdefault((l.dst, l.dst_port), []).append(l)
            if l.src in comp_set:
                out_links.setdefault(l.src, []).append(l)

        # member i absorbs the NEXT member in order when both are linear,
        # the link between them is i's only out-link and the next's only
        # source, and the composite dim fits the cap
        units = []
        i = 0
        while i < len(order):
            members = [order[i]]
            if nodes[order[i]].cfg_name in _LINEAR_KINDS:
                dim = cascade.SECTION_DIMS[
                    _LINEAR_KINDS[nodes[order[i]].cfg_name]]
                while i + 1 < len(order):
                    nxt = order[i + 1]
                    ls = out_links.get(order[i], [])
                    if not (nodes[nxt].cfg_name in _LINEAR_KINDS
                            and len(ls) == 1 and ls[0].dst == nxt
                            and ls[0].dst_port == "in"
                            and len(in_links.get((nxt, "in"), [])) == 1):
                        break
                    d2 = cascade.SECTION_DIMS[
                        _LINEAR_KINDS[nodes[nxt].cfg_name]]
                    if dim + d2 > cascade.MAX_RUN_DIM:
                        break
                    members.append(nxt)
                    dim += d2
                    i += 1
            i += 1
            units.append(members)

        reg_of: dict[tuple[int, str], int] = {}
        tap_of: dict[tuple[int, str], int] = {}
        reg_ports: list = []
        tap_ports: list = []
        for members in units:
            tail = members[-1]
            for port in nodes[tail].spec.outputs:
                kp = (tail, port)
                ls = [l for l in out_links.get(tail, []) if l.src_port == port]
                if any(l.dst in comp_set for l in ls):
                    reg_of[kp] = len(reg_ports)
                    reg_ports.append(kp)
                if any(l.dst not in comp_set for l in ls):
                    tap_of[kp] = len(tap_ports)
                    tap_ports.append(kp)

        ext_keys: list = []
        ext_of: dict = {}

        def port_join(nid, port):
            ls = in_links.get((nid, port), [])
            terms = []
            for l in ls:
                key = (l.src, l.src_port)
                if l.src in comp_set:
                    if key not in reg_of:
                        return None      # an interior member's port
                    terms.append(("reg", reg_of[key]))
                else:
                    if key not in ext_of:
                        ext_of[key] = len(ext_keys)
                        ext_keys.append(key)
                    terms.append(("ext", ext_of[key]))
            return tuple(terms), 1.0 / float(_fanin_divisor(len(ls)))

        h1 = 1.0 / float(_fanin_divisor(1))
        program: list = []
        specs: list = []
        for members in units:
            head = members[0]
            node = nodes[head]
            cn = node.cfg_name
            if cn in ("add", "mix"):
                ja, jb = port_join(head, "a"), port_join(head, "b")
                if ja is None or jb is None or not ja[0] or not jb[0]:
                    return None
                if cn == "add":
                    cA = cB = 1.0
                else:
                    r = np.float32(node.params["ratio"])
                    cA, cB = float(np.float32(1.0) - r), float(r)
                program.append(("lin2", ja[0], ja[1], jb[0], jb[1], cA, cB))
            else:
                j = port_join(head, "in")
                if j is None or not j[0]:
                    return None
                program.append(("join", j[0], j[1]))
                if cn == "reverb":
                    dec, sec = node.params["decay"], node.params["seconds"]
                    if not (_concrete(dec) and _concrete(sec)):
                        return None
                    program.append(("comb", float(np.float32(dec)),
                                    int(delay_samples(float(sec))),
                                    sum(1 for sp in specs if sp[0] == "comb")))
                    specs.append(("comb", head))
                elif cn in _CYCLE_EW:
                    keys = {"overdrive": ("boost", "drive", "level"),
                            "chebyshev": ("level_pos", "level_neg")
                            }.get(cn, ("level",))
                    ps = [node.params[k] for k in keys]
                    if not all(_concrete(v) for v in ps):
                        return None
                    kind = cn if cn != "distort" \
                        else f"distort:{node.params['mode']}"
                    program.append(("ew", kind,
                                    tuple(float(np.float32(v)) for v in ps)))
                else:                    # a linear unit of 1..k members
                    secs: list = []
                    ids: list = []
                    for m_i, m in enumerate(members):
                        sec = _linear_section(nodes[m])
                        if sec is None:
                            return None
                        if m_i:
                            secs.append(("gain", h1))
                        secs.append(sec)
                        if cascade.SECTION_DIMS[sec[0]]:
                            ids.append(m)
                    if not ids:
                        for _, v in secs:
                            program.append(("scale", float(v)))
                    else:
                        program.append(("cascade", tuple(secs),
                                        sum(1 for sp in specs
                                            if sp[0] == "cascade")))
                        specs.append(("cascade", tuple(secs), tuple(ids)))
            tail = members[-1]
            for port in nodes[tail].spec.outputs:
                kp = (tail, port)
                if kp in reg_of:
                    program.append(("setreg", reg_of[kp]))
                if kp in tap_of:
                    program.append(("tap", tap_of[kp]))
        if not ext_keys:
            return None          # a self-oscillator: no feed sets the length
        return (tuple(program), tuple(ext_keys), tuple(reg_ports),
                tuple(tap_ports), tuple(specs))

    def _needs_sequence(self, comp_set, nid, port) -> bool:
        """Whether a member port's full sequence is read: by a node
        outside the cycle, or (for the knob writeback) by a modulation
        port inside it."""
        for l in self.graph.links:
            if l.src != nid or l.src_port != port:
                continue
            if (l.dst not in comp_set
                    or l.dst_port in self._nodes[l.dst].spec.mod_inputs):
                return True
        return False

    def _eval_cycle(self, comp, state, values, T: int, pdict,
                    fused_heads, fused_interior):
        """Evaluate one feedback SCC over T/128 blocks.

        Members run in ascending-id order within a block; an intra-cycle
        edge from a not-yet-run member reads the previous block's value
        (one BLOCK of delay), the defined semantic of the reference's
        emergent feedback latency.  Under ``fast``, when every member
        lowers, the whole SCC runs as ONE ops/cycle_segment block program.
        Otherwise (``parity``, a modulated member, a member the program
        does not take, ``CYCLE_FUSION`` off) a per-node scan over the
        blocks runs (:class:`_CycleScan`), in which the in-cycle linear
        runs (``fast`` only) are one cascade solve per block at the head's
        position: as a Python loop over the blocks, or, on the card, as
        the loop over static buffers that compiler/cycle_loop.py captures
        in CUDA graphs (its rule: ``CycleLoops.takes``)."""
        B = self.block_size
        ckey = _cycle_key(comp)
        planned = (self._cycle_program(comp, pdict)
                   if CYCLE_FUSION and NODE_HOOK is None
                   and precision.get_policy().name == "fast" else None)
        if planned is not None:
            program, ext_keys, reg_ports, tap_ports, cspecs = planned
            regs0 = tuple(state[ckey][f"{nid}:{port}"]
                          for nid, port in reg_ports)
            st_in = []
            for sp in cspecs:
                if sp[0] == "cascade":
                    st_in.append(cascade.cascade_state_in(
                        sp[1], [state[str(n)] for n in sp[2]]))
                else:
                    nst = state[str(sp[1])]
                    st_in.append(oldest_first(nst["ring"], nst["pos"]))
            taps, regs_f, cinfos, hists = cycle_segment(
                tuple(values[k] for k in ext_keys), regs0, tuple(st_in),
                program, len(tap_ports))
            ci = hi = 0
            for sp in cspecs:
                if sp[0] == "cascade":
                    for n, ns in zip(sp[2], cascade.cascade_state_out(
                            sp[1], *cinfos[ci])):
                        state[str(n)] = ns
                    ci += 1
                else:
                    state[str(sp[1])] = {"ring": hists[hi], "pos": 0}
                    hi += 1
            prev = dict(state[ckey])
            for (nid, port), r in zip(reg_ports, regs_f):
                prev[f"{nid}:{port}"] = r
            for kp, seq in zip(tap_ports, taps):
                values[kp] = seq
                if kp not in reg_ports:
                    prev[f"{kp[0]}:{kp[1]}"] = seq[..., -B:]
            state[ckey] = prev
            return

        scan = _CycleScan(self, comp, fused_heads, fused_interior)
        st = {str(nid): state[str(nid)] for nid in scan.order}
        prev = {kp: state[ckey][f"{kp[0]}:{kp[1]}"] for kp in scan.ports}
        nb = T // B
        if NODE_HOOK is None and self.cycle_loops.takes(scan, values, pdict,
                                                        st, prev, nb):
            st, prev, seqs = self.cycle_loops.run(scan, values, pdict, st,
                                                  prev, nb)
        else:
            blocks: list = [[] for _ in scan.emit]
            for b in range(nb):
                st, prev, emitted = scan.body(values, pdict, st, prev, b)
                for seq, blk in zip(blocks, emitted):
                    seq.append(blk)
            seqs = [torch.cat(torch.broadcast_tensors(*seq), dim=-1)
                    for seq in blocks]
        state.update(st)
        state[ckey] = {f"{nid}:{port}": prev[(nid, port)]
                       for nid, port in scan.ports}
        values.update(zip(scan.emit, seqs))

    def _pointwise_plan(self, mega_heads: dict, fused_heads: dict):
        """(groups, unit order) of this render: the pointwise groups of
        the nodes that this render's mega runs and linear runs leave
        (``_plan_pointwise``), planned once per claimed set; none while
        ``NODE_HOOK`` is set (every node reports) or with
        ``POINTWISE_FUSION`` off.  A slider override does not take a node
        out of its group: the group reads it as an operand."""
        claimed = set()
        for run, *rest in mega_heads.values():
            claimed.update(run)
            if rest[3] is not None:            # the Output it folds
                claimed.add(rest[3])
        for run, *_ in fused_heads.values():
            claimed.update(run)
        key = frozenset(claimed)
        if NODE_HOOK is not None or not POINTWISE_FUSION:
            key = None
        got = self._pointwise_plans.get(key)
        if got is None:
            groups = () if key is None else _plan_pointwise(
                self.graph, self._nodes, self._sccs, key)
            got = self._pointwise_plans[key] = (
                groups, _unit_order(self.graph, self._sccs, groups))
        return got

    def _fanin_plan(self, mega_heads: dict, fused_heads: dict):
        """The render's fan-ins outside its groups that groups compute
        (``_plan_fanins``, a ``_FaninPlan``), planned once per groups and
        structure of the fused runs; None while ``NODE_HOOK`` is set or
        with ``POINTWISE_FUSION`` or ``FANIN_GROUPS`` off (every fan-in its
        eager ops).  The sites, in the order the render reads them: a mega
        run's head with several sources (one source folds into the
        segment), a linear run's head, each input and connected modulation
        port of a node that runs on its own, then (after every unit) each
        Output that no group averaged and no mega run folds, and each
        analysis sink's ports."""
        if NODE_HOOK is not None or not (POINTWISE_FUSION and FANIN_GROUPS):
            return None
        groups, order = self._pointwise_plan(mega_heads, fused_heads)
        key = ("fanins", groups,
               tuple((h, tuple(r[0]), r[3], r[4])
                     for h, r in sorted(mega_heads.items())),
               tuple((h, tuple(r[0])) for h, r in sorted(fused_heads.items())))
        got = self._pointwise_plans.get(key)
        if got is not None:
            return got
        graph, nodes = self.graph, self._nodes
        interior = {n for run, *_ in (*mega_heads.values(),
                                      *fused_heads.values())
                    for n in run[1:]}
        folded = {r[4] for r in mega_heads.values()}
        at: dict = {}
        sites: list = []
        for i, (kind, comp) in enumerate(order):
            for n in comp:
                at[n] = i
            nid = comp[0]
            if (kind == "group" or _is_cycle(graph, comp) or nid in interior
                    or nid in self.output_ids or nid in self._analyzed):
                continue
            if nid in mega_heads:
                if not mega_heads[nid][3]:
                    sites.append((nid, "in", None))
            elif nid in fused_heads:
                sites.append((nid, "in", None))
            else:
                sites += _fanin_sites(nodes[nid])
        grouped = {n for g in groups for n in g}
        for nid in (*self.output_ids, *self._analyzed):
            if nid in grouped or nid in folded:
                continue
            at[nid] = len(order)
            sites += _fanin_sites(nodes[nid])
        unit_of = [at[g[0]] for g in groups]
        writes, taken, solo = _plan_fanins(
            graph, nodes, groups, sites,
            lambda i, nid: unit_of[i] < at[nid])
        got = self._pointwise_plans[key] = _FaninPlan(
            dict(zip(groups, writes)), taken, solo)
        return got

    def _cycle_groups(self, order, fused_heads: dict,
                      fused_interior: set) -> tuple:
        """The pointwise groups of the per-node scan of the feedback SCC
        whose members are ``order`` (``_plan_cycle_groups``), planned once
        per SCC and set of members this render's in-cycle linear runs
        claim; none while ``NODE_HOOK`` is set or with
        ``POINTWISE_FUSION`` off, as ``_pointwise_plan`` rules."""
        if NODE_HOOK is not None or not POINTWISE_FUSION:
            return ()
        claimed = {n for run, *_ in fused_heads.values() for n in run}
        key = (tuple(order), frozenset(claimed))
        got = self._pointwise_plans.get(key)
        if got is None:
            got = self._pointwise_plans[key] = _plan_cycle_groups(
                self.graph, self._nodes, order, frozenset(claimed),
                frozenset(fused_interior))
        return got

    def _lower_group(self, members, pdict, fanins=()):
        """``_lower`` with each slider and divisor operand made its tensor
        (:meth:`_operand`; a value's key stays a key): the group as one
        render reads it."""
        prog, sigs, scals, written = self._lower(members, pdict,
                                                 fanins=fanins)
        return (prog, [self._operand(d, pdict, lambda key: key)
                       for d in sigs],
                [self._operand(d, pdict, None) for d in scals], written)

    def _lower(self, members, pdict, every: bool = False, fanins=()):
        """(program, signals, scalars, written) of a pointwise group
        (compiler/pointwise.py): its members' input ports' fan-in averages,
        modulation maps and node forms, in the members' order, then the
        fan-ins it computes for readers outside it (``fanins``: (key, the
        ports that read it), ``_plan_fanins``; a one-form group has no
        members and one of them).
        ``signals`` lists its signal operands: a value's key (nid, port) or
        a slider with a shape; ``scalars`` its scalar operands: the
        sliders, read from device memory, and one fan-in divisor per source
        count.  A slider is a ``_Slider`` (the override in ``pdict`` or the
        graph's value), a divisor a ``_Divisor``, each made a tensor where
        it is read (:meth:`_operand`), so that one lowering serves every
        block of a scan.  A member source the group has not computed yet (a
        later member or the member itself, inside a feedback SCC) is a
        value operand.  ``written`` says what its outputs are, in order:
        ("value", (nid, port)) for a member output that a node outside the
        group reads or a modulation port reads (for the knob writeback), or
        every member output with ``every`` (the per-node scan carries them
        all), ("out", nid) for an Output member's fan-in average, and a
        fan-in's key for each of ``fanins``: a member output that only
        those read is not written."""
        graph, nodes = self.graph, self._nodes
        mset = set(members)
        covered = {port for _, ports in fanins for port in ports}
        b = pointwise.Builder()
        sigs: list = []
        scals: list = []
        ext: dict = {}
        mine: dict = {}
        divisors: dict = {}

        def scalar(d):
            scals.append(d)
            return b.scal()

        def slider(nid, name):
            d = _Slider(nid, name)
            if self._operand(d, pdict, None).dim() == 0:
                return scalar(d)
            sigs.append(d)
            return b.sig()

        def signal(key):
            if key in mine:
                return mine[key]
            if key not in ext:
                sigs.append(key)
                ext[key] = b.sig()
            return ext[key]

        def avg(srcs):
            if srcs and len(srcs) not in divisors:
                divisors[len(srcs)] = scalar(_Divisor(len(srcs)))
            return pointwise.avg(b, [signal(k) for k in srcs],
                                 divisors.get(len(srcs)))

        def port_avg(nid, port):
            return avg([(l.src, l.src_port) for l in graph.in_links(nid, port)])

        def read_outside(l) -> bool:
            if l.dst in mset:
                return l.dst_port in nodes[l.dst].spec.mod_inputs
            return (l.dst, l.dst_port) not in covered

        written: list = []
        outs: list = []
        for nid in members:
            node = nodes[nid]
            if node.cfg_name == "output":
                written.append(("out", nid))
                outs.append(port_avg(nid, "in"))
                continue
            in_ports, names, lower = pointwise.node_form(node.cfg_name,
                                                         node.params)
            ps = {}
            for p in node.spec.params:
                if not isinstance(p, ParamSpec) or p.name not in names:
                    continue
                if p.as_input and graph.in_links(nid, p.name):
                    ps[p.name] = pointwise.map_mod(
                        b, port_avg(nid, p.name), p.lo, p.hi)
                else:
                    ps[p.name] = slider(nid, p.name)
            res = lower(b, {p: port_avg(nid, p) for p in in_ports}, ps,
                        precision.get_policy().name)
            for port, v in res.items():
                mine[(nid, port)] = v
                if every or any(l.src == nid and l.src_port == port
                                and read_outside(l) for l in graph.links):
                    written.append(("value", (nid, port)))
                    outs.append(v)
        for key, _ in fanins:
            kind, what = key
            if kind == "avg":
                v = avg(what)
            else:
                srcs, lo, hi = what
                v = pointwise.map_mod(b, avg(srcs), lo, hi)
            written.append(key)
            outs.append(v)
        return b.program(outs), sigs, scals, written

    def _operand(self, d, pdict, read):
        """The tensor of a group operand described by ``_lower``: a
        slider's (the override in ``pdict`` or the graph's value, from the
        device caches, ``precision.on_device``), a fan-in divisor's, or
        ``read(key)`` for a value's key."""
        if isinstance(d, _Slider):
            over = (pdict or {}).get(str(d.nid), {})
            v = (self._override(over[d.name],
                                f"params[{str(d.nid)!r}][{d.name!r}]")
                 if d.name in over else self._nodes[d.nid].params[d.name])
            return precision.on_device(v, self.device)
        if isinstance(d, _Divisor):
            return _divisor_on(d.n, self.device)
        return read(d)

    def _group_eval(self, members, values: dict, outs: dict, pdict, T: int,
                    fanins=(), fan=None):
        """Evaluate a pointwise group (``_lower``) as one program,
        one kernel launch on the card: sets ``values``, ``outs`` (the
        Output members' averages) and ``fan`` (the fan-ins it computes for
        readers outside it, ``fanins``, by key; an Output member's average
        under its fan-in's key too) for what it writes."""
        prog, sigs, scals, written = self._lower(members, pdict,
                                                 fanins=fanins)
        if not written:
            return                      # nothing reads the group's nodes
        got = group_call(prog, [self._operand(d, pdict, values.__getitem__)
                                for d in sigs],
                         [self._operand(d, pdict, None) for d in scals], T,
                         self.device)
        for (kind, key), sig in zip(written, got):
            if kind == "out":
                outs[key] = sig
                if fan is not None:
                    fan[_fanin_key(self.graph, key, "in")] = sig
            elif kind == "value":
                values[key] = sig
            else:
                fan[(kind, key)] = sig

    def _eval(self, state, ext, T: int, pdict=None):
        graph = self.graph
        state = dict(state)
        values: dict[tuple[int, str], Any] = {}
        fused_heads, fused_interior = self._active_fusion(pdict)
        mega_heads, mega_interior = self._active_mega(pdict)
        # Output ids whose fan-in scale a mega run already applied
        mega_out_folds: dict[int, tuple[int, str]] = {}
        # Output ids a pointwise group averaged
        group_outs: dict[int, Any] = {}
        _, order = self._pointwise_plan(mega_heads, fused_heads)
        plan = self._fanin_plan(mega_heads, fused_heads)
        solo = plan.solo if plan is not None else frozenset()
        # the fan-ins read outside the groups, by key (_fanin_key): what a
        # group or a one-form group wrote, and each eager one, computed once
        fan: dict = {}

        def sources(nid, port):
            return [values[(l.src, l.src_port)]
                    for l in graph.in_links(nid, port)]

        def fanin(nid, port, p=None):
            """The fan-in of a port: its average, or for a modulation port
            ``p`` the average mapped (``_map_mod``)."""
            key = None if plan is None else _fanin_key(graph, nid, port, p)
            if key in fan:
                return fan[key]
            if key in solo:
                self._group_eval((), values, group_outs, pdict, T,
                                 ((key, ((nid, port),)),), fan)
                return fan[key]
            sig, n = _avg(sources(nid, port), T, self.device)
            if p is not None:
                sig = _map_mod(sig, p)
            if key is not None and n:
                fan[key] = sig
            return sig

        def node_fanins(node):
            """(inputs, mods) of a node: each input port's fan-in, and each
            connected modulation port's mapped one."""
            return ({port: fanin(node.id, port) for port in node.spec.inputs},
                    {p.name: fanin(node.id, p.name, p)
                     for p in _mod_params(node)
                     if graph.in_links(node.id, p.name)})

        for kind, comp in order:
            if kind == "group":
                self._group_eval(comp, values, group_outs, pdict, T,
                                 () if plan is None else plan.writes[comp],
                                 None if plan is None else fan)
                continue
            if _is_cycle(graph, comp):
                self._eval_cycle(comp, state, values, T, pdict,
                                 fused_heads, fused_interior)
                continue
            nid = comp[0]
            if nid in mega_interior or nid in fused_interior:
                continue                      # evaluated at the run head
            if nid in mega_heads:
                run, stages, specs, head_single, out_fold, tapped = \
                    mega_heads[nid]
                # head_single: the fan-in scale is folded into the stages
                x1 = (sources(run[0], "in")[0] if head_single
                      else fanin(run[0], "in"))
                values.update(self._mega_run_eval(run, stages, specs, tapped,
                                                  x1, state))
                if out_fold is not None:
                    mega_out_folds[out_fold] = (run[-1], "out")
                continue
            if nid in fused_heads:
                run, secs, emits, tapped = fused_heads[nid]
                values.update(self._fused_run_eval(
                    run, secs, emits, tapped, fanin(run[0], "in"), state))
                continue
            node = self._nodes[nid]
            impl = node.spec.impl
            if getattr(impl, "graph_output", False) or nid in self._analyzed:
                # an Output computes nothing: its fan-in average is the
                # rendered channel, taken once below; an analysis sink
                # (its process_seq nothing) reads its fan-ins there too
                if NODE_HOOK is not None:
                    NODE_HOOK(nid, node.cfg_name, {})
                continue
            in_sigs, mods = node_fanins(node)
            if getattr(impl, "graph_input", False):
                inputs = {EXTERNAL: ext[str(nid)]}
            else:
                inputs = in_sigs
            params = self._resolve_params(node, mods, pdict)
            outs, state[str(nid)] = _call(impl, params, state[str(nid)],
                                          inputs, T, self.block_size)
            if NODE_HOOK is not None:
                NODE_HOOK(nid, node.cfg_name, outs)
            for port in node.spec.outputs:
                values[(nid, port)] = outs[port]

        # graph outputs: fan-in average into each Output node
        # (output.rs:215-250)
        outs = {}
        for nid in self.output_ids:
            if nid in mega_out_folds:
                outs[nid] = values[mega_out_folds[nid]]
            elif nid in group_outs:
                outs[nid] = group_outs[nid]
            else:
                outs[nid] = fanin(nid, "in")

        # modulation knob writeback (reference quirk SURVEY.md 2.4 #9): the
        # knob ends at the mapped value of the last block's first sample,
        # taken from the port's mapped fan-in where the render computed it,
        # else averaged and mapped at that one sample (both are per-sample,
        # so either is bitwise the full-length average's sample);
        # a batched render batches every aux leaf, as the JAX package's
        # vmap does (out_axes 0): a knob or a sink fed only by unbatched
        # signals (an LFO, nothing at all) broadcasts over the streams
        batch = torch.broadcast_shapes(*(v.shape[:-1] for v in ext.values()))
        at = T - self.block_size
        knobs = {}
        for nid, node in self._nodes.items():
            for p in _mod_params(node):
                if not graph.in_links(nid, p.name):
                    continue
                key = _fanin_key(graph, nid, p.name, p)
                if key in fan:
                    knob = fan[key][..., at]
                else:
                    sig, _ = _avg([s[..., at:at + 1]
                                   for s in sources(nid, p.name)], 1,
                                  self.device)
                    knob = _map_mod(sig, p)[..., 0]
                knobs[f"{nid}:{p.name}"] = knob.expand(batch)
        aux = {"__knobs__": knobs} if knobs else {}

        # analysis sinks, under "<cfg_name>:<node id>"
        for nid in self._analyzed:
            node = self._nodes[nid]
            inputs, mods = node_fanins(node)
            params = self._resolve_params(node, mods, pdict)
            res = node.spec.impl.analyze(params, inputs)
            if all(v.dim() == 1 for v in inputs.values()):
                res = _on_batch(res, batch)
            aux[f"{node.cfg_name}:{nid}"] = res
        return state, outs, aux


class _Slider(NamedTuple):
    """A group operand that is ``params[nid][name]`` (compile._lower)."""
    nid: int
    name: str


class _Divisor(NamedTuple):
    """A group operand that is the fan-in divisor of ``n`` sources."""
    n: int


class _CycleScan:
    """The per-node scan of one feedback SCC over blocks of the graph's
    block size: the members in ascending-id order, the member ports
    carried from block to block (``ports``), those whose whole sequence
    the render reads (``emit``: read outside the SCC, or by a modulation
    port for the knob writeback) and the signals it reads from outside
    (``feeds``).  :meth:`body` is one block of it, which both routes of
    the scan run: the Python loop over the blocks
    (``CompiledGraph._eval_cycle``) and the loop over static buffers
    (compiler/cycle_loop.py), the JAX package's ``lax.scan`` body
    (dsp_stuff_tpu/compiler/compile.py:1386).  Its stateless members run
    in pointwise groups (``groups``, ``CompiledGraph._cycle_groups``),
    one kernel launch a group and block on the card, as XLA fuses them
    inside that body; each group is lowered once per scan and structure
    of the overrides (:meth:`_lowered`).  A fan-in that a member running
    on its own (or a fused run's head) reads from the members of one
    group that runs before it in the block is an output of that group
    (``fanins``, ``_plan_fanins`` without one-form groups: a fan-in of
    several sources outside one group stays its eager ops, since the
    Python loop pays a group call's host work every block)."""

    def __init__(self, cg: CompiledGraph, comp, fused_heads: dict,
                 fused_interior: set):
        self.cg = cg
        self.order = sorted(comp)
        self.comp_set = set(self.order)
        self.groups = cg._cycle_groups(self.order, fused_heads,
                                       fused_interior)
        self.group_at = {g[0]: g for g in self.groups}
        self.grouped = {n for g in self.groups for n in g}
        self._lowerings: dict = {}
        self.ports = [(nid, port) for nid in self.order
                      for port in cg._nodes[nid].spec.outputs]
        self.emit = [kp for kp in self.ports
                     if cg._needs_sequence(self.comp_set, *kp)]
        self.feeds = sorted({(l.src, l.src_port) for l in cg.graph.links
                             if l.dst in self.comp_set
                             and l.src not in self.comp_set})
        self.fused_heads = fused_heads
        self.fused_interior = fused_interior
        #: (nid, port) -> the key of its fan-in, which a group writes;
        #: members -> the group's fan-in outputs, (key, ports)
        self.fanins: dict = {}
        self.group_fanins: dict = {}
        if FANIN_GROUPS and self.groups:
            self._plan_fanins()

    def _plan_fanins(self):
        """``fanins`` and ``group_fanins``: the fan-ins of each member
        that runs on its own and of each fused run's head that a group
        running before it in the block writes (``_plan_fanins``)."""
        nodes = self.cg._nodes
        pos = {n: i for i, n in enumerate(self.order)}
        sites: list = []
        for nid in self.order:
            if nid in self.fused_interior or nid in self.grouped:
                continue
            if nid in self.fused_heads:
                sites.append((nid, "in", None))
                continue
            sites += _fanin_sites(nodes[nid])
        writes, self.fanins, _ = _plan_fanins(
            self.cg.graph, nodes, self.groups, sites,
            lambda i, nid: pos[self.groups[i][0]] < pos[nid], one_form=False)
        self.group_fanins = {g: w for g, w in zip(self.groups, writes) if w}

    def feed_blocks(self, feeds: dict, b) -> dict:
        """Block ``b`` of each of ``self.feeds`` from its [..., T] signal in
        ``feeds``: a slice for a Python int ``b``, a gather at ``b * block
        + arange(block)`` for a 0-d int64 counter on the device (then
        nothing on the host changes from one block to the next)."""
        B = self.cg.block_size
        return {k: _block_of(feeds[k], b, B) for k in self.feeds}

    def body(self, feeds: dict, pdict, st: dict, prev: dict, b):
        """Block ``b`` of the scan: :meth:`step` on the feeds' blocks
        (:meth:`feed_blocks`)."""
        return self.step(self.feed_blocks(feeds, b), pdict, st, prev)

    def step(self, blocks: dict, pdict, st: dict, prev: dict):
        """One block of the scan.  ``blocks`` maps each of ``self.feeds``
        to its block [..., block], ``st`` each member id to its state,
        ``prev`` each carried port to the previous block's output.
        Returns (st, cur, emitted): the members' new states, this block's
        outputs (the next block's ``prev``) and the blocks of
        ``self.emit``.  A function of its arguments alone, so the reverse
        of the loop over buffers differentiates it block by block with
        respect to the feed blocks, states, carried blocks and overrides
        (compiler/cycle_loop.py)."""
        cg = self.cg
        graph, nodes, B = cg.graph, cg._nodes, cg.block_size
        st = dict(st)
        cur: dict = {}
        fan: dict = {}          # the fan-ins the groups wrote, by key

        def lookup(src, src_port):
            key = (src, src_port)
            if src in self.comp_set:
                return cur[key] if key in cur else prev[key]
            return blocks[key]

        def fanin(nid, port, p=None):
            key = self.fanins.get((nid, port))
            if key is not None:
                return fan[key]
            sig, _ = _avg([lookup(l.src, l.src_port)
                           for l in graph.in_links(nid, port)], B, cg.device)
            return sig if p is None else _map_mod(sig, p)

        for nid in self.order:
            if nid in self.fused_interior:
                continue                      # evaluated at the run head
            if nid in self.fused_heads:
                run, secs, emits, tapped = self.fused_heads[nid]
                cur.update(cg._fused_run_eval(run, secs, emits, tapped,
                                              fanin(run[0], "in"), st))
                continue
            if nid in self.group_at:
                prog, sigs, scals, written = self._lowered(
                    self.group_at[nid], pdict)
                got = group_call(
                    prog, [cg._operand(d, pdict, lambda k: lookup(*k))
                           for d in sigs],
                    [cg._operand(d, pdict, None) for d in scals], B,
                    cg.device)
                for (kind, key), sig in zip(written, got):
                    if kind == "value":
                        cur[key] = sig
                    else:
                        fan[(kind, key)] = sig
                continue
            if nid in self.grouped:
                continue                      # evaluated with its group
            node = nodes[nid]
            inputs = {port: fanin(nid, port) for port in node.spec.inputs}
            params = cg._resolve_params(
                node, {p.name: fanin(nid, p.name, p) for p in _mod_params(node)
                       if graph.in_links(nid, p.name)}, pdict)
            outs, st[str(nid)] = _call_block(node.spec.impl, params,
                                             st[str(nid)], inputs, B)
            if NODE_HOOK is not None:
                NODE_HOOK(nid, node.cfg_name, outs)
            for port in node.spec.outputs:
                cur[(nid, port)] = outs[port]
        # members a fused run skipped without emitting: nothing reads
        # them, their carried entries pass through unchanged
        for kp in self.ports:
            if kp not in cur:
                cur[kp] = prev[kp]
        return st, cur, tuple(cur[kp] for kp in self.emit)

    def _lowered(self, members, pdict):
        """``CompiledGraph._lower`` of a group, every member output
        written and its fan-in outputs (``group_fanins``) after them, once
        per policy and structure of the overrides (which sliders are
        overridden, and which of them have a shape)."""
        fanins = self.group_fanins.get(members, ())
        key = (members, fanins, precision.get_policy().name, tuple(
            (nid, name, isinstance(v, torch.Tensor) and v.dim() > 0)
            for nid in members
            for name, v in (pdict or {}).get(str(nid), {}).items()))
        got = self._lowerings.get(key)
        if got is None:
            got = self._lowerings[key] = self.cg._lower(
                members, pdict, every=True, fanins=fanins)
        return got


def _block_of(seq: torch.Tensor, b, B: int) -> torch.Tensor:
    """Block ``b`` of ``seq`` [..., T]: a slice for a Python int, a gather
    at ``b * B + arange(B)`` for a counter on the device."""
    if isinstance(b, torch.Tensor):
        return seq.index_select(-1, b * B + torch.arange(B,
                                                          device=seq.device))
    return seq[..., b * B:(b + 1) * B]


def compile_graph(graph: Graph, block_size: int = 128,
                  device="cuda") -> CompiledGraph:
    """Plan ``graph`` for rendering on ``device``: the card by default,
    "cpu" for the plain PyTorch versions; raises RuntimeError when
    "cuda" is asked for and no CUDA device is present."""
    if block_size % 128:
        # the reference frame (node.rs:257) is semantically visible: Fuzz
        # block-max is pinned to the 128 grid (SURVEY 2.4 #5)
        raise ValueError(
            f"block_size must be a multiple of 128 (the reference frame, "
            f"node.rs:257); got {block_size}")
    active = _active_nodes(graph)
    nodes = {nid: n for nid, n in graph.nodes.items() if nid in active}
    edges: dict[int, set[int]] = {nid: set() for nid in nodes}
    for l in graph.links:
        if l.src in nodes and l.dst in nodes:
            edges[l.src].add(l.dst)
    sccs = condensation_topo_order(sorted(nodes), edges)
    mega_plan = _plan_mega_fusion(graph, nodes, sccs)
    mega_members = frozenset(n for run in mega_plan for n in run)
    fusion_plan = _plan_linear_fusion(graph, nodes, sccs,
                                      exclude=mega_members)
    return CompiledGraph(graph, block_size, device, nodes, sccs, mega_plan,
                         fusion_plan)
