"""Analysis sink nodes: Wave View, Spectrogram and Pitch.

In the reference these draw into the egui UI; offline they return arrays,
collected into the compiled graph's ``aux`` under ``"<cfg_name>:<node_id>"``.
"""

from __future__ import annotations

from dsp_stuff_tpu_torch.registry import register_node, FieldSpec, ParamSpec
from dsp_stuff_tpu_torch.ops.fftspec import spectrogram
from dsp_stuff_tpu_torch.ops.pitch_mpm import detect_pitch


@register_node(
    title="Wave view", cfg_name="wave_view",
    description="Inspect the waveform of a signal",
    inputs=("in",), is_sink=True,
)
class WaveView:
    """Oscilloscope sink (wave_view.rs); offline it returns the full
    averaged input signal (the reference's ring and frame-rate decimation
    are UI artifacts)."""

    @staticmethod
    def process_seq(params, state, inputs):
        return {}, state

    @staticmethod
    def analyze(params, inputs):
        return {"samples": inputs["in"]}


@register_node(
    title="Spectrogram", cfg_name="spectrogram",
    description="Inspect the volume of individual frequencies over time",
    inputs=("in",), is_sink=True,
    params=(
        FieldSpec("fft_size", 512),
        FieldSpec("buffer_size", 250),
        FieldSpec("lower_bound", 20),
        FieldSpec("upper_bound", 20_000),
    ),
)
class Spectrogram:
    """FFT waterfall (spectrogram.rs:225-269): one column per fft_size
    samples, frequency-bounded; the last buffer_size columns are kept
    (spectrogram.rs:255-262)."""

    @staticmethod
    def process_seq(params, state, inputs):
        return {}, state

    @staticmethod
    def analyze(params, inputs):
        _, cols = spectrogram(
            inputs["in"], fft_size=int(params["fft_size"]),
            lower_hz=float(params["lower_bound"]),
            upper_hz=float(params["upper_bound"]))
        # n == 0 keeps none (a plain [-0:] slice would keep everything)
        n = int(params["buffer_size"])
        return {"columns": cols[..., -n:, :] if n > 0 else cols[..., :0, :]}


@register_node(
    title="Pitch Detector", cfg_name="pitch",
    description="Display the peak pitch of a signal",
    inputs=("in",), is_sink=True,
    params=(
        ParamSpec("power_thresh", 0.0, 1.0, 0.5),
        ParamSpec("clarity_thresh", 0.0, 1.0, 0.5),
        ParamSpec("pick_thresh", 0.0, 1.0, 0.5),
    ),
)
class Pitch:
    """McLeod pitch detection over 1024-sample windows (pitch.rs:115-147).

    The thresholds are read on the host (``float``), so they cannot be
    data of a stream step: a stream session refuses an override of one
    (``host_sliders``), as the JAX package's ``process()`` raises on
    them (``float`` of a traced value)."""

    host_sliders = ("power_thresh", "clarity_thresh", "pick_thresh")

    @staticmethod
    def process_seq(params, state, inputs):
        return {}, state

    @staticmethod
    def analyze(params, inputs):
        return detect_pitch(
            inputs["in"],
            power_threshold=float(params["power_thresh"]),
            clarity_threshold=float(params["clarity_thresh"]),
            pick_threshold=float(params["pick_thresh"]))
