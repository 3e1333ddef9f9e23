"""Stateless combinator nodes: Gain, Add, Mix, Mux, Demux."""

from __future__ import annotations

import torch

from dsp_stuff_tpu_torch.registry import register_node, ParamSpec, SelectSpec
from dsp_stuff_tpu_torch.utils.precision import on_device


@register_node(
    title="Gain", cfg_name="gain", description="Adjust gain of a signal",
    inputs=("in",), outputs=("out",),
    params=(ParamSpec("level", 0.0, 10.0, 1.0, as_input=True),),
)
class Gain:
    """out[i] = in[i] * level[i] (gain.rs:27-38)."""

    @staticmethod
    def process_seq(params, state, inputs):
        x = inputs["in"]
        level = on_device(params["level"], x.device)
        return {"out": x * level}, state


@register_node(
    title="add", cfg_name="add", description="add two signals together",
    inputs=("a", "b"), outputs=("out",),
)
class Add:
    """out = a + b (add.rs:24-34)."""

    @staticmethod
    def process_seq(params, state, inputs):
        return {"out": inputs["a"] + inputs["b"]}, state


@register_node(
    title="Mix", cfg_name="mix", description="Mix two signals together",
    inputs=("a", "b"), outputs=("out",),
    params=(ParamSpec("ratio", 0.0, 1.0, 0.5, as_input=True,
                      label="Ratio (a:b)"),),
)
class Mix:
    """out = b*ratio + a*(1-ratio) (mix.rs:33-47); 1 - ratio is an f32
    subtraction, as the reference reads the f32 ratio atomic."""

    @staticmethod
    def process_seq(params, state, inputs):
        a = inputs["a"]
        r = on_device(params["ratio"], a.device)
        return {"out": inputs["b"] * r + a * (1.0 - r)}, state


@register_node(
    title="mux", cfg_name="mux", description="Toggle between two input signals",
    inputs=("a", "b"), outputs=("out",),
    params=(SelectSpec("in_port", ("A", "B"), "A"),),
)
class Mux:
    """Copy the selected input (mux.rs:44-55); selection is a static param."""

    @staticmethod
    def process_seq(params, state, inputs):
        src = inputs["a"] if params["in_port"] == "A" else inputs["b"]
        return {"out": src}, state


@register_node(
    title="demux", cfg_name="demux",
    description="Toggle between two output signals",
    inputs=("in",), outputs=("a", "b"),
    params=(SelectSpec("out_port", ("A", "B"), "A"),),
)
class Demux:
    """Copy input to the selected output; the other output stays silent
    (demux.rs:44-58 -- the unselected buffer is simply left zeroed)."""

    @staticmethod
    def process_seq(params, state, inputs):
        x = inputs["in"]
        zero = torch.zeros_like(x)
        if params["out_port"] == "A":
            return {"a": x, "b": zero}, state
        return {"a": zero, "b": x}, state
