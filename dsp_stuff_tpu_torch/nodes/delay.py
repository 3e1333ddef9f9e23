"""Delay-family nodes: Reverb (feedback echo) and Chorus (modulated tap)."""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.registry import register_node, ParamSpec
from dsp_stuff_tpu_torch.ops.delay_line import feedback_comb, delay_samples
from dsp_stuff_tpu_torch.ops.lockstep import counter, oldest_first
from dsp_stuff_tpu_torch.ops.modfx import max_delay_samples, modulated_delay
from dsp_stuff_tpu_torch.utils.sliders import lift, num


def _f32(v) -> float:
    return float(np.float32(v))


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
    (a lockstep counter, ops/lockstep.py) is non-zero only after the
    per-block path (``process_block``, which the feedback-cycle scan
    calls), and is canonicalized away before the comb runs."""

    @staticmethod
    def init_state(cfg, block_size):
        D = delay_samples(float(cfg["seconds"]))
        return {"ring": torch.zeros((D,), dtype=torch.float32), "pos": 0}

    @staticmethod
    def process_seq(params, state, inputs):
        ring = oldest_first(state["ring"], state["pos"])
        y, ring = feedback_comb(inputs["in"], params["decay"],
                                ring.shape[-1], ring)
        return {"out": y}, {"ring": ring, "pos": 0}

    @staticmethod
    def process_block(params, state, inputs):
        """One block no longer than the line: read the T oldest samples of
        the ring at ``pos``, overwrite them with the outputs."""
        x = inputs["in"]
        ring, pos = state["ring"], counter(state["pos"])
        D = ring.shape[-1]
        T = x.shape[-1]
        if T > D:
            return Reverb.process_seq(params, state, inputs)
        idx = (pos + torch.arange(T, device=x.device)) % D
        batch = torch.broadcast_shapes(x.shape[:-1], ring.shape[:-1])
        ring = ring.expand(*batch, D).clone()
        decay = params["decay"]
        if not isinstance(decay, torch.Tensor):
            decay = num(lift(_f32, decay), x)
        y = x + ring[..., idx] * decay
        ring[..., idx] = y.expand(*batch, T)
        return {"out": y}, {"ring": ring, "pos": (pos + T) % D}


@register_node(
    title="Chorus", cfg_name="chorus",
    description="Sine-modulated fractional delay (chorus/flanger/vibrato)",
    inputs=("in",), outputs=("out",),
    params=(
        ParamSpec("rate", 0.05, 10.0, 1.0, suffix=" hz", as_input=True),
        ParamSpec("depth", 0.0, 0.02, 0.003, suffix="s", static=True),
        ParamSpec("base", 0.0, 0.05, 0.01, suffix="s", static=True),
        ParamSpec("mix", 0.0, 1.0, 0.5, as_input=True),
    ),
)
class Chorus:
    """Extension node (no reference analog; BASELINE.json config #2 needs
    modulated fractional taps).  base/depth fix the history length, so
    they are structural; rate and mix are modulatable.  See ops/modfx.py.

    The sample clock ``t0`` is a lockstep counter (ops/lockstep.py)
    shared by all streams, so the tap trajectory is shared too."""

    @staticmethod
    def init_state(cfg, block_size):
        L = max_delay_samples(float(cfg["base"]), float(cfg["depth"]))
        return {"hist": torch.zeros((L,), dtype=torch.float32), "t0": 0}

    @staticmethod
    def process_seq(params, state, inputs):
        y, hist, t0 = modulated_delay(
            inputs["in"], params["rate"], params["depth"], params["base"],
            params["mix"], state["hist"], state["t0"])
        return {"out": y}, {"hist": hist, "t0": t0}
