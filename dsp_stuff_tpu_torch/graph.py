"""Graph IR and reference-compatible JSON (de)serialization.

The reference's de-facto public file format (runtime.rs:44-48, 560-564,
606-612) is::

    {
      "nodes": [{"id": N, "typename": "<cfg_name>", "position": [x, y],
                 "cfg": {"id": N, "inputs": {"<port>": pid, ...},
                          "outputs": {"<port>": pid, ...}, <saved fields>}}],
      "links": [{"lhs": [node_id, port_id], "rhs": [node_id, port_id]}]
    }

``lhs`` is the producing (node, output-port), ``rhs`` the consuming
(node, input-port) (runtime.rs:125-134).  Port IDs are only meaningful
through the per-node name->id maps inside ``cfg``; we resolve them to names
on load and regenerate them on save.  Restored IDs bump the generators with
fetch_max semantics (ids.rs:16) so fresh IDs never collide.

Known reference quirk handled here: the Low Pass node declares
``cfg_name = "high_pass"`` (low_pass.rs:9), so a *reference-saved* Low Pass
restores as a High Pass over there (RESTORE lookup nodes/mod.rs:119).  We
write the unambiguous ``low_pass`` (which the reference's own RESTORE table
also accepts, nodes/mod.rs:118) and accept both names on read, resolving
``high_pass`` to the High Pass node exactly as the reference does.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from dsp_stuff_tpu_torch.ids import IdSpace, GLOBAL_IDS
from dsp_stuff_tpu_torch.registry import REGISTRY, NOT_PORTED, NodeSpec


@dataclasses.dataclass
class GraphNode:
    id: int
    spec: NodeSpec
    params: dict[str, Any]
    position: tuple[float, float] = (100.0, 100.0)
    # port-name -> PortId maps (regenerated on save if absent)
    in_port_ids: dict[str, int] = dataclasses.field(default_factory=dict)
    out_port_ids: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def cfg_name(self) -> str:
        return self.spec.cfg_name


@dataclasses.dataclass(frozen=True)
class Link:
    src: int            # producing node id
    src_port: str       # output port name
    dst: int            # consuming node id
    dst_port: str       # input port name


class Graph:
    """A DAG-with-cycles of effect nodes, edges allowed to fan in and out.

    Fan-out duplicates the signal to every consumer (node.rs:321-325);
    fan-in averages with the reference's ``sum / (n + 1e-4)`` rule
    (node.rs:162-194).  Both are applied by the compiler, not stored here.
    """

    def __init__(self, ids: IdSpace | None = None) -> None:
        self.ids = ids or GLOBAL_IDS
        self.nodes: dict[int, GraphNode] = {}
        self.links: list[Link] = []

    # -- construction ----------------------------------------------------

    def add(self, cfg_name: str, *, id: int | None = None,
            position: tuple[float, float] = (100.0, 100.0),
            **params: Any) -> GraphNode:
        spec = REGISTRY.by_cfg_name(cfg_name)
        nid = self.ids.node.generate() if id is None else self.ids.node.restore(id)
        merged = spec.default_params()
        for k, v in params.items():
            if k not in merged:
                raise KeyError(f"{cfg_name} has no parameter {k!r}; has {sorted(merged)}")
            merged[k] = v
        node = GraphNode(id=nid, spec=spec, params=merged, position=position)
        node.in_port_ids = {p: self.ids.port.generate() for p in spec.all_inputs}
        node.out_port_ids = {p: self.ids.port.generate() for p in spec.outputs}
        self.nodes[nid] = node
        return node

    def connect(self, src: GraphNode | int, src_port: str,
                dst: GraphNode | int, dst_port: str) -> Link:
        src_id = src.id if isinstance(src, GraphNode) else src
        dst_id = dst.id if isinstance(dst, GraphNode) else dst
        src_node, dst_node = self.nodes[src_id], self.nodes[dst_id]
        if src_port not in src_node.spec.outputs:
            raise KeyError(f"{src_node.cfg_name} has no output {src_port!r}")
        if dst_port not in dst_node.spec.all_inputs:
            raise KeyError(f"{dst_node.cfg_name} has no input {dst_port!r}")
        link = Link(src_id, src_port, dst_id, dst_port)
        self.links.append(link)
        return link

    def chain(self, *steps: GraphNode) -> None:
        """Connect single-output -> single-audio-input nodes in sequence."""
        for a, b in zip(steps, steps[1:]):
            self.connect(a, a.spec.outputs[0], b, b.spec.inputs[0])

    def disconnect(self, link: Link) -> None:
        """Remove one link (the link_destroyed path, runtime.rs:319-335;
        node state restart is a compile-time concern here — recompiling
        the graph starts every node fresh, like restart_node)."""
        self.links.remove(link)

    def remove_node(self, node: GraphNode | int) -> None:
        """Remove a node and every link touching it (node-deletion path,
        runtime.rs:364-402)."""
        nid = node.id if isinstance(node, GraphNode) else node
        del self.nodes[nid]
        self.links = [l for l in self.links
                      if l.src != nid and l.dst != nid]

    # -- queries ---------------------------------------------------------

    def in_links(self, nid: int, port: str) -> list[Link]:
        """A port's sources in insertion order (== JSON list order on load
        == the reference's ascending-LinkId order after restore).  This is
        the canonical fan-in sum order the compiler and oracle share; see
        compiler.compile._avg for the bit-exactness contract."""
        return [l for l in self.links if l.dst == nid and l.dst_port == port]

    def out_links(self, nid: int, port: str) -> list[Link]:
        return [l for l in self.links if l.src == nid and l.src_port == port]

    def nodes_of_type(self, cfg_name: str) -> list[GraphNode]:
        return [n for n in self.nodes.values() if n.cfg_name == cfg_name
                or cfg_name in n.spec.aliases]

    # -- serialization ---------------------------------------------------

    def to_config(self) -> dict:
        nodes_out = []
        for node in self.nodes.values():
            cfg: dict[str, Any] = {"id": node.id}
            # port maps; reference nodes serialize inputs/outputs maps they
            # own (derive lib.rs:233-293; Input omits `inputs`, sinks omit
            # `outputs` -- we include maps only for ports that exist, which
            # covers both)
            if node.spec.all_inputs:
                cfg["inputs"] = dict(node.in_port_ids)
            if node.spec.outputs:
                cfg["outputs"] = dict(node.out_port_ids)
            for p in node.spec.params:
                if getattr(p, "save", True):
                    cfg[p.name] = node.params[p.name]
            nodes_out.append({
                "id": node.id,
                "typename": node.cfg_name,
                "position": list(node.position),
                "cfg": cfg,
            })
        links_out = []
        for l in self.links:
            lhs = [l.src, self.nodes[l.src].out_port_ids[l.src_port]]
            rhs = [l.dst, self.nodes[l.dst].in_port_ids[l.dst_port]]
            links_out.append({"lhs": lhs, "rhs": rhs})
        return {"nodes": nodes_out, "links": links_out}

    @classmethod
    def from_config(cls, cfg: dict, ids: IdSpace | None = None) -> "Graph":
        g = cls(ids)
        # port_id -> (node_id, port_name, direction)
        port_index: dict[tuple[int, int], tuple[str, str]] = {}
        for ncfg in cfg.get("nodes", ()):
            typename = ncfg["typename"]
            if typename not in REGISTRY and typename not in NOT_PORTED:
                raise KeyError(f"unknown node typename {typename!r}")
            spec = REGISTRY.by_cfg_name(typename)
            sub = ncfg.get("cfg", {}) or {}
            params = spec.default_params()
            for p in spec.params:
                if p.name in sub:
                    params[p.name] = sub[p.name]
            pos = tuple(ncfg.get("position", (100.0, 100.0)))
            node = g.add(spec.cfg_name, id=int(ncfg["id"]), position=pos, **params)
            # adopt serialized port ids so links resolve
            for pname, pid in (sub.get("inputs") or {}).items():
                if pname in node.in_port_ids:
                    g.ids.port.restore(int(pid))
                    node.in_port_ids[pname] = int(pid)
                    port_index[(node.id, int(pid))] = (pname, "in")
            for pname, pid in (sub.get("outputs") or {}).items():
                if pname in node.out_port_ids:
                    g.ids.port.restore(int(pid))
                    node.out_port_ids[pname] = int(pid)
                    port_index[(node.id, int(pid))] = (pname, "out")
        for lcfg in cfg.get("links", ()):
            (src_n, src_p), (dst_n, dst_p) = lcfg["lhs"], lcfg["rhs"]
            src_name, src_dir = port_index.get((int(src_n), int(src_p)), (None, None))
            dst_name, dst_dir = port_index.get((int(dst_n), int(dst_p)), (None, None))
            if src_name is None or dst_name is None:
                raise KeyError(f"link references unknown port: {lcfg}")
            # direction-normalize like runtime.rs:337-353 (links may be
            # recorded either way around by a hand-written config)
            if src_dir == "in" and dst_dir == "out":
                src_n, src_p, src_name, dst_n, dst_p, dst_name = \
                    dst_n, dst_p, dst_name, src_n, src_p, src_name
            g.connect(int(src_n), src_name, int(dst_n), dst_name)
        return g


def loads_graph(text: str, ids: IdSpace | None = None) -> Graph:
    return Graph.from_config(json.loads(text), ids)


def load_graph(path: str, ids: IdSpace | None = None) -> Graph:
    with open(path) as f:
        return Graph.from_config(json.load(f), ids)


def dumps_graph(graph: Graph, indent: int | None = 2) -> str:
    return json.dumps(graph.to_config(), indent=indent)


def save_graph(graph: Graph, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps_graph(graph))
