"""Filter nodes: BiQuad, LowPass, HighPass, Envelope, Fir.

A slider is a Python float (the graph's value: host-constant solves), a
stream's slider as data (utils/sliders.Data: the float path, its host
constants derived with ``sliders.lift`` and read from device buffers) or,
from ``render(params=...)`` and the fitting path, a 0-d tensor that may
require grad, which each node keeps a tensor (no host read)."""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.registry import (register_node, ParamSpec,
                                          SelectSpec, FieldSpec)
from dsp_stuff_tpu_torch.ops.envelope import peak_envelope
from dsp_stuff_tpu_torch.ops.fir import fir_apply, init_fir_state
from dsp_stuff_tpu_torch.ops.scan import first_order_affine, biquad_df1
from dsp_stuff_tpu_torch.utils.precision import on_device
from dsp_stuff_tpu_torch.utils.sliders import lift, num


def _zero():
    return torch.zeros((), dtype=torch.float32)


def _ratio(params):
    r = params["ratio"]
    return r.to(torch.float32) if isinstance(r, torch.Tensor) \
        else lift(float, r)


def _one_minus_host(r) -> float:
    return float(np.float32(1.0) - np.float32(r))


def _one_minus(r, like):
    """1 - r in f32 as an operand of an op on ``like`` (a tensor ratio
    stays a tensor; a stream's slider is its buffer of the host value)."""
    if isinstance(r, torch.Tensor):
        return 1.0 - r
    return num(lift(_one_minus_host, r), like)


def _over_a0(v, a0) -> np.float32:
    """A coefficient over a0, in f32 (biquad.rs:64-71)."""
    return np.float32(np.float32(v) / np.float32(a0))


@register_node(
    title="Biquad", cfg_name="biquad", description="Generic biquad filter",
    inputs=("in",), outputs=("out",),
    params=(
        ParamSpec("a0", -10.0, 10.0, 1.0),
        ParamSpec("a1", -10.0, 10.0, -0.24),
        ParamSpec("a2", -10.0, 10.0, 0.0),
        ParamSpec("b0", -10.0, 10.0, 0.758),
        ParamSpec("b1", -10.0, 10.0, 0.0),
        ParamSpec("b2", -10.0, 10.0, 0.0),
    ),
)
class BiQuad:
    """DirectForm1 biquad; all coefficients are divided by a0 when settings
    change (biquad.rs:62-76), and the 4-sample IIR state resets on every
    slider change (biquad.rs:74).  Offline, params are static per render,
    so state is fresh at t=0."""

    @staticmethod
    def init_state(cfg, block_size):
        return {"x1": _zero(), "x2": _zero(), "y1": _zero(), "y2": _zero()}

    @staticmethod
    def process_seq(params, state, inputs):
        # f32 division by a0 as in regenerate_filter (biquad.rs:64-71)
        raw = [params[k] for k in ("a0", "a1", "a2", "b0", "b1", "b2")]
        if any(isinstance(v, torch.Tensor) for v in raw):
            x = inputs["in"]
            # a float among them is a cached device constant: a stream
            # block's capture may copy nothing from the host
            a0 = on_device(raw[0], x.device)
            a1, a2, b0, b1, b2 = (on_device(v, x.device) / a0
                                  for v in raw[1:])
        else:
            a1, a2, b0, b1, b2 = (lift(_over_a0, v, raw[0])
                                  for v in raw[1:])
        y, (x1, x2, y1, y2) = biquad_df1(
            inputs["in"], a1, a2, b0, b1, b2,
            (state["x1"], state["x2"], state["y1"], state["y2"]))
        return {"out": y}, {"x1": x1, "x2": x2, "y1": y1, "y2": y2}


@register_node(
    # The reference's LowPass declares cfg_name = "high_pass" (low_pass.rs:9)
    # so its saves restore as HighPass over there (nodes/mod.rs:119).  We
    # write the unambiguous name, which the reference RESTORE table also
    # accepts (nodes/mod.rs:118); reads of "high_pass" resolve to HighPass
    # here exactly as there.
    title="Low Pass", cfg_name="low_pass",
    description="Attenuates higher frequencies",
    inputs=("in",), outputs=("out",),
    params=(ParamSpec("ratio", 0.0, 1.0, 0.5),),
)
class LowPass:
    """y[i] = x[i]*(1-r) + r*z; z = y[i] (low_pass.rs:36-41)."""

    @staticmethod
    def init_state(cfg, block_size):
        return {"z": _zero()}

    @staticmethod
    def process_seq(params, state, inputs):
        x = inputs["in"]
        r = _ratio(params)
        y = first_order_affine(r, x * _one_minus(r, x), state["z"])
        return {"out": y}, {"z": y[..., -1]}


@register_node(
    title="High Pass", cfg_name="high_pass",
    description="Attenuates lower frequencies",
    inputs=("in",), outputs=("out",),
    params=(ParamSpec("ratio", 0.0, 1.0, 0.5),),
)
class HighPass:
    """z = x*(1-r) + r*z; y = x - z (high_pass.rs:36-41)."""

    @staticmethod
    def init_state(cfg, block_size):
        return {"z": _zero()}

    @staticmethod
    def process_seq(params, state, inputs):
        x = inputs["in"]
        r = _ratio(params)
        z = first_order_affine(r, x * _one_minus(r, x), state["z"])
        return {"out": x - z}, {"z": z[..., -1]}


def _clip_frames(v) -> float:
    return float(np.clip(np.float32(v), 0.0, 1000.0))


@register_node(
    title="Envelope", cfg_name="envelope", description="Envelope detection",
    inputs=("in",), outputs=("out",),
    params=(
        ParamSpec("attack", 0.0, 1000.0, 0.0),
        ParamSpec("release", 0.0, 1000.0, 0.0),
    ),
)
class Envelope:
    """dasp_envelope full-wave peak detector (envelope.rs:43-51); attack and
    release are frame counts re-applied every block."""

    @staticmethod
    def init_state(cfg, block_size):
        return {"env": _zero()}

    @staticmethod
    def process_seq(params, state, inputs):
        # clamp to the sliders' 0..1000 frames (envelope.rs): a frame count
        # below 0 would make exp(-1/f) > 1, an amplifying recurrence the
        # reference node cannot express
        atk, rel = (torch.clamp(v.to(torch.float32), 0.0, 1000.0)
                    if isinstance(v, torch.Tensor)
                    else lift(_clip_frames, v)
                    for v in (params["attack"], params["release"]))
        y, env = peak_envelope(inputs["in"], atk, rel, state["env"])
        return {"out": y}, {"env": env}


@register_node(
    title="FIR Filter", cfg_name="fir", description="Perform a FIR operation",
    inputs=("in",), outputs=("out",),
    params=(
        SelectSpec("mode", ("Average", "Balanced"), "Balanced"),
        FieldSpec("file_name", None),
        # stored REVERSED, as the reference saves them (fir.rs:160-170);
        # persisted inside the graph JSON (fir.rs:58-62)
        FieldSpec("taps", (1.0,)),
    ),
)
class Fir:
    """Direct-form FIR over a loaded impulse response (fir.rs:179-225),
    accumulated in the policy's fir_accum_dtype, with the reference's
    warm-up quirk (see ops/fir.py).  The global sample counter ``n_seen``
    is lockstep state, a Python int shared by every stream."""

    @staticmethod
    def init_state(cfg, block_size):
        hist, first, n_seen = init_fir_state(len(cfg["taps"]))
        return {"hist": hist, "first": first, "n_seen": n_seen}

    @staticmethod
    def process_seq(params, state, inputs):
        taps_rev = np.asarray(params["taps"], np.float64)
        divisor = np.float32(1.0 / taps_rev.size) \
            if params["mode"] == "Average" else np.float32(1.0)
        y, (hist, first, n_seen) = fir_apply(
            inputs["in"], taps_rev,
            (state["hist"], state["first"], state["n_seen"]), divisor)
        return {"out": y}, {"hist": hist, "first": first, "n_seen": n_seen}
