"""Distortion / waveshaping nodes: Distort, Overdrive, Chebyshev, Muff."""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.registry import register_node, ParamSpec, SelectSpec
from dsp_stuff_tpu_torch.ops import shaping
from dsp_stuff_tpu_torch.ops.oversample import oversampled
from dsp_stuff_tpu_torch.ops.scan import first_order_affine


@register_node(
    title="Distort", cfg_name="distort", description="Distortion effects",
    inputs=("in",), outputs=("out",),
    params=(
        ParamSpec("level", 0.0, 30.0, 0.0, as_input=True),
        SelectSpec("mode", tuple(shaping.DISTORT_MODES), "SoftClip"),
        # extension beyond the reference (whose Distort aliases): polyphase
        # anti-aliased shaping at 2/4/8x rate (ops/oversample.py)
        SelectSpec("oversample", ("1", "2", "4", "8"), "1"),
    ),
)
class Distort:
    """9 waveshaper modes dispatched on a static enum (distort.rs:184-194).
    Fuzz normalizes per 128-sample block (distort.rs:148-151)."""

    @staticmethod
    def process_seq(params, state, inputs):
        R = int(params.get("oversample", "1"))
        if params["mode"] == "Fuzz":
            # defined at the base rate whatever ``oversample`` says
            y = shaping.fuzz(inputs["in"], params["level"], 128)
        else:
            y = oversampled(shaping.DISTORT_MODES[params["mode"]],
                            inputs["in"], R, params["level"])
        return {"out": y}, state


@register_node(
    title="Overdrive", cfg_name="overdrive", description="Overdrive",
    inputs=("in",), outputs=("out",),
    params=(
        ParamSpec("boost", 0.0, 30.0, 0.0, as_input=True),
        ParamSpec("drive", 0.0, 1.0, 0.0, as_input=True),
        ParamSpec("level", 0.0, 1.0, 0.0, as_input=True),
        SelectSpec("oversample", ("1", "2", "4", "8"), "1"),
    ),
)
class Overdrive:
    """atan overdrive (overdrive.rs:31-43); optional anti-aliased
    oversampling (extension, ops/oversample.py)."""

    @staticmethod
    def process_seq(params, state, inputs):
        y = oversampled(shaping.overdrive, inputs["in"],
                        int(params.get("oversample", "1")), params["boost"],
                        params["drive"], params["level"])
        return {"out": y}, state


@register_node(
    title="Chebyshev", cfg_name="chebyshev", description="Chebyshev Distortion",
    inputs=("in",), outputs=("out",),
    params=(
        ParamSpec("level_pos", 0.0, 50.0, 0.0),
        ParamSpec("level_neg", 0.0, 50.0, 0.0),
    ),
)
class Chebyshev:
    """Asymmetric tanh shaper (chebyshev.rs:28-42)."""

    @staticmethod
    def process_seq(params, state, inputs):
        y = shaping.chebyshev_asym(inputs["in"], params["level_pos"],
                                   params["level_neg"])
        return {"out": y}, state


# the tone stack's one-pole at about 500 Hz, r = exp(-2 pi fc / sr): a
# Python float, so on the card under ``fast`` the solve is the first-order
# kernel (ops/scan.py first_order_affine)
_MUFF_POLE = 0.93669


@register_node(
    title="Muff", cfg_name="muff", description="Big Muff",
    inputs=("in",), outputs=("out",),
    params=(
        ParamSpec("toan", 0.0, 1.0, 0.5),
        ParamSpec("level", 0.0, 1.0, 0.5),
        ParamSpec("sustain", 0.0, 1.0, 0.5),
    ),
)
class Muff:
    """Big Muff Pi-style fuzz, the JAX package's license-clean model.

    The reference's DSP body lives in an unvendored external GPL crate
    (muff.rs:6,45), so only its interface is knowable; the model is
    sustain-scaled gain into a soft clipper, a tone-stack crossfade
    between a one-pole low-pass and high-pass, then output level.  It
    claims no parity with the reference and is held against the JAX
    package only."""

    @staticmethod
    def init_state(cfg, block_size):
        return {"lp_z": torch.zeros((), dtype=torch.float32)}

    @staticmethod
    def process_seq(params, state, inputs):
        x = inputs["in"]
        sustain, toan, level = (shaping._t(params[k], x)
                                for k in ("sustain", "toan", "level"))
        # input gain: 1..~100 with sustain
        v = torch.tanh(x * (1.0 + sustain * 99.0))
        # tone stack: crossfade LP (toan=0) <-> HP (toan=1); both legs
        # share the one-pole, since hp = v - lp
        r = _MUFF_POLE
        lp = first_order_affine(r, v * float(np.float32(1.0)
                                             - np.float32(r)),
                                state["lp_z"])
        hp = v - lp
        y = ((1.0 - toan) * lp + toan * hp) * level
        return {"out": y}, {"lp_z": lp[..., -1]}
