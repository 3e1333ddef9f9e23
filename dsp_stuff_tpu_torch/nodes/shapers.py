"""Distortion / waveshaping nodes: Distort, Overdrive, Chebyshev.  Muff is
registry.NOT_PORTED."""

from __future__ import annotations

from dsp_stuff_tpu_torch.registry import register_node, ParamSpec, SelectSpec
from dsp_stuff_tpu_torch.ops import shaping


def _base_rate_only(params):
    """The ``oversample`` select keeps the JAX package's JSON, but only the
    base rate is ported (ops/oversample.py is not)."""
    if str(params.get("oversample", "1")) != "1":
        raise NotImplementedError(
            f"oversample={params['oversample']!r} is not ported yet "
            f"(ops/oversample.py); only '1' is supported")


@register_node(
    title="Distort", cfg_name="distort", description="Distortion effects",
    inputs=("in",), outputs=("out",),
    params=(
        ParamSpec("level", 0.0, 30.0, 0.0, as_input=True),
        SelectSpec("mode", tuple(shaping.DISTORT_MODES), "SoftClip"),
        SelectSpec("oversample", ("1", "2", "4", "8"), "1"),
    ),
)
class Distort:
    """9 waveshaper modes dispatched on a static enum (distort.rs:184-194).
    Fuzz normalizes per 128-sample block (distort.rs:148-151)."""

    @staticmethod
    def process_seq(params, state, inputs):
        if params["mode"] == "Fuzz":
            # defined at the base rate whatever ``oversample`` says
            y = shaping.fuzz(inputs["in"], params["level"], 128)
        else:
            _base_rate_only(params)
            y = shaping.DISTORT_MODES[params["mode"]](inputs["in"],
                                                      params["level"])
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
    """atan overdrive (overdrive.rs:31-43)."""

    @staticmethod
    def process_seq(params, state, inputs):
        _base_rate_only(params)
        y = shaping.overdrive(inputs["in"], params["boost"], params["drive"],
                              params["level"])
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
