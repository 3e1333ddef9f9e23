"""Node-type registry: the Python analog of the reference's derive macro DSL.

The reference declares node types with ``#[derive(DspNode)]`` + ``#[dsp(...)]``
attributes (dsp-stuff-derive/src/lib.rs): title, cfg_name, description, input
and output port lists, sliders (range, logarithmic, as_input modulation flag,
suffix), select enums, saved fields and defaults.  Registration adds the type
to two static tables, display-name -> constructor and cfg_name -> restorer
(dsp-stuff/src/nodes/mod.rs:65-123).

Here a node type is a class decorated with ``@register_node``; the class
declares the same metadata via class attributes and implements the DSP
semantics as plain functions on torch tensors:

* ``init_state(cfg, block_size)``          -> dict of tensors (or None)
* ``process_seq(params, state, inputs)``   -> (outputs, state)
      full-sequence semantics; signals are tensors shaped ``[..., T]``
      with any leading batch dimensions.  A source that needs the render
      length (``needs_length = True``, signal_gen) also takes ``T`` and
      ``block_size``; a node may add ``process_block`` for the per-node
      feedback-cycle scan (Reverb).

``params`` maps param name -> resolved value: a per-sample f32 tensor for
``as_input`` (modulation) sliders that have a connected source, a python
float for plain sliders, and a string for selects.  The compiler resolves
modulation inputs (including the [-1,1] -> slider-range mapping of
dsp-stuff-derive/src/lib.rs:135-153) before calling these functions.

This registry is the port's own: it holds only the node types the port
implements, independent of the JAX package's table.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """A slider parameter (lib.rs:10-17 SliderOptions)."""
    name: str
    lo: float
    hi: float
    default: float
    as_input: bool = False       # adds a modulation input port of this name
    logarithmic: bool = False
    suffix: str = ""
    save: bool = True
    label: str | None = None
    # structural parameter: fixes shapes (e.g. a delay-line length), so it
    # is excluded from CompiledGraph.init_params
    static: bool = False


@dataclasses.dataclass(frozen=True)
class SelectSpec:
    """An enum combo-box parameter; serialized by variant name (serde)."""
    name: str
    choices: tuple[str, ...]
    default: str
    save: bool = True


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A saved free-form config field (e.g. device names)."""
    name: str
    default: Any = None
    save: bool = True


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    title: str
    cfg_name: str
    description: str
    inputs: tuple[str, ...]           # declared audio input ports, in order
    outputs: tuple[str, ...]
    params: tuple[Any, ...]           # ParamSpec | SelectSpec | FieldSpec
    impl: type
    # cfg_names this type also restores from (reference RESTORE table keys,
    # nodes/mod.rs:92-123)
    aliases: tuple[str, ...] = ()
    # pure sink (no audio output)
    is_sink: bool = False
    # graph-level source (audio enters the graph here)
    is_source: bool = False

    @property
    def mod_inputs(self) -> tuple[str, ...]:
        """as_input sliders append one extra input port each, in field order
        (derive: lib.rs:191-219 generates inputs then slider-input ports)."""
        return tuple(p.name for p in self.params
                     if isinstance(p, ParamSpec) and p.as_input)

    @property
    def all_inputs(self) -> tuple[str, ...]:
        return self.inputs + self.mod_inputs

    def param(self, name: str):
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(name)

    def default_params(self) -> dict[str, Any]:
        return {p.name: p.default for p in self.params}


class Registry:
    def __init__(self) -> None:
        self._by_cfg: dict[str, NodeSpec] = {}
        self._by_title: dict[str, NodeSpec] = {}

    def add(self, spec: NodeSpec) -> None:
        for key in (spec.cfg_name, *spec.aliases):
            # first registration wins for aliases so the canonical owner of a
            # cfg_name keeps it (reference RESTORE list is ordered;
            # runtime.rs:634 takes the first match)
            self._by_cfg.setdefault(key, spec)
        self._by_cfg[spec.cfg_name] = spec
        self._by_title[spec.title] = spec

    def by_cfg_name(self, name: str) -> NodeSpec:
        if name not in self._by_cfg and name in NOT_PORTED:
            raise KeyError(f"node type {name!r} is not ported to "
                           f"dsp_stuff_tpu_torch yet (ROADMAP Queue 1)")
        return self._by_cfg[name]

    def by_title(self, title: str) -> NodeSpec:
        return self._by_title[title]

    def __contains__(self, name: str) -> bool:
        return name in self._by_cfg

    def __iter__(self):
        seen = set()
        for spec in self._by_cfg.values():
            if id(spec) not in seen:
                seen.add(id(spec))
                yield spec

    def titles(self) -> list[str]:
        return sorted(self._by_title)


#: node types of the JAX package that this package does not implement yet;
#: naming one raises a KeyError that says so instead of "unknown"
NOT_PORTED = frozenset()

REGISTRY = Registry()


def register_node(cls=None, *, title: str, cfg_name: str, description: str = "",
                  inputs: Sequence[str] = (), outputs: Sequence[str] = (),
                  params: Sequence[Any] = (), aliases: Sequence[str] = (),
                  is_sink: bool = False, is_source: bool = False):
    """Class decorator registering a node type (analog of #[derive(DspNode)])."""

    def wrap(c):
        spec = NodeSpec(
            title=title, cfg_name=cfg_name, description=description,
            inputs=tuple(inputs), outputs=tuple(outputs),
            params=tuple(params), impl=c, aliases=tuple(aliases),
            is_sink=is_sink, is_source=is_source,
        )
        c.spec = spec
        if not hasattr(c, "init_state"):
            c.init_state = staticmethod(lambda cfg, block_size: None)
        REGISTRY.add(spec)
        return c

    if cls is not None:
        return wrap(cls)
    return wrap
