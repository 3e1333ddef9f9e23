"""Delay-family nodes: Reverb (feedback echo).  Chorus is
registry.NOT_PORTED."""

from __future__ import annotations

import torch

from dsp_stuff_tpu_torch.registry import register_node, ParamSpec
from dsp_stuff_tpu_torch.ops.delay_line import feedback_comb, delay_samples


@register_node(
    title="Reverb", cfg_name="reverb",
    description="Repeat/ echo sounds with a given delay and decay factor",
    inputs=("in",), outputs=("out",),
    params=(
        ParamSpec("seconds", 0.0, 1.0, 0.5, suffix="s", label="Delay",
                  static=True),
        ParamSpec("decay", 0.0, 1.0, 0.5),
    ),
)
class Reverb:
    """y[n] = x[n] + decay * y[n-D], D = max(int(seconds*48000), 128)
    (reverb.rs:76-111, delay length reverb.rs:57).  The ring starts zeroed
    (reverb.rs:55-71).

    State is the JAX package's circular buffer + write position; ``pos``
    (a Python int, shared by all streams) is non-zero only in a state
    carried over from the JAX package's block path, and is canonicalized
    away before the comb runs."""

    @staticmethod
    def init_state(cfg, block_size):
        D = delay_samples(float(cfg["seconds"]))
        return {"ring": torch.zeros((D,), dtype=torch.float32), "pos": 0}

    @staticmethod
    def process_seq(params, state, inputs):
        ring = torch.roll(state["ring"], -int(state["pos"]), dims=-1)
        y, ring = feedback_comb(inputs["in"], params["decay"],
                                ring.shape[-1], ring)
        return {"out": y}, {"ring": ring, "pos": 0}
