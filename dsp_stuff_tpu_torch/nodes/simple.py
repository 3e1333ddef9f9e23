"""Stateless combinator nodes.  Only Gain is ported; Add, Mix, Mux and
Demux are registry.NOT_PORTED."""

from __future__ import annotations

import torch

from dsp_stuff_tpu_torch.registry import register_node, ParamSpec


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
        level = torch.as_tensor(params["level"], dtype=torch.float32,
                                device=x.device)
        return {"out": x * level}, state
