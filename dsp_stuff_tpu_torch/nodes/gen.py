"""Signal Generator node."""

from __future__ import annotations

import torch

from dsp_stuff_tpu_torch.registry import register_node, ParamSpec, SelectSpec
from dsp_stuff_tpu_torch.ops.gen import oscillator


@register_node(
    title="Signal Generator", cfg_name="signal_gen",
    description="Generate a signal with a given frequency and amplitude",
    outputs=("out",),
    params=(
        ParamSpec("amplitude", -1.0, 1.0, 0.5, as_input=True),
        ParamSpec("frequency", 0.1, 20000.0, 100.0, as_input=True,
                  logarithmic=True, suffix=" hz"),
        SelectSpec("mode", ("Sine", "Triangle", "Square", "Constant"), "Sine"),
    ),
)
class SignalGen:
    """Sine/Triangle/Square/Constant with a persistent block-wrapped phase
    clock (signal_gen.rs:57-108), square-wave quirk included."""

    # a source: the compiler passes the render length T (and block size)
    needs_length = True

    @staticmethod
    def init_state(cfg, block_size):
        return {"clock": torch.zeros((), dtype=torch.float32)}

    @staticmethod
    def process_seq(params, state, inputs, *, T, block_size=128):
        # the per-block clock wrap and the intra-block square comparison are
        # defined on the reference's 128 frame (signal_gen.rs:57-103),
        # whatever the compile block size (which tiles 128); the card's
        # clock state sends it to the oscillator kernel (ops/gen.py)
        y, clock = oscillator(params["mode"], params["amplitude"],
                              params["frequency"], T, state["clock"],
                              block_size=128, device=state["clock"].device)
        return {"out": y}, {"clock": clock}
