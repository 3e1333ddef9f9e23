"""Input / Output device nodes.

In the reference these bridge to cpal audio devices on real-time OS threads
(input.rs:213-241, output.rs:215-250, devices.rs).  Offline, an Input node
is a graph *source* bound to a column of the provided input batch, and an
Output node is a graph *terminal* whose fan-in average becomes a rendered
output channel.  The host/device selections are carried as config fields
for JSON round-trips (InputConfig: input.rs:32-38).
"""

from __future__ import annotations

from dsp_stuff_tpu_torch.registry import register_node, FieldSpec


@register_node(
    title="Input", cfg_name="input", description="Stream audio from an input device",
    outputs=("out",), is_source=True,
    params=(
        FieldSpec("selected_host", "ALSA"),
        FieldSpec("selected_device", None),
    ),
)
class Input:
    graph_input = True

    @staticmethod
    def process_seq(params, state, inputs):
        # the compiler binds "__external__" to this node's source column
        return {"out": inputs["__external__"]}, state


@register_node(
    title="Output", cfg_name="output", description="Stream audio to an output device",
    inputs=("in",), is_sink=True,
    params=(
        FieldSpec("selected_host", "ALSA"),
        FieldSpec("selected_device", None),
    ),
)
class Output:
    graph_output = True

    @staticmethod
    def process_seq(params, state, inputs):
        # fan-in averaging is already applied; the averaged signal is the
        # rendered channel
        return {}, state
