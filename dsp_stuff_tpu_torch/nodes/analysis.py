"""Analysis sink nodes: Wave View, Spectrogram and Pitch.

In the reference these draw into the egui UI; offline they return arrays,
collected into the compiled graph's ``aux`` under ``"<cfg_name>:<node_id>"``.
"""

from __future__ import annotations

import numpy as np

from dsp_stuff_tpu_torch.registry import register_node, FieldSpec, ParamSpec
from dsp_stuff_tpu_torch.ops.fftspec import grid_frequencies, spectrogram
from dsp_stuff_tpu_torch.ops.pitch_mpm import detect_pitch


@register_node(
    title="Wave view", cfg_name="wave_view",
    description="Inspect the waveform of a signal",
    inputs=("in",), is_sink=True,
)
class WaveView:
    """Oscilloscope sink (wave_view.rs); offline it returns the full
    averaged input signal (the reference's ring and frame-rate decimation
    are UI artifacts, which ``sweeps`` reproduces on the host)."""

    RING = 4096          # wave_view.rs:145 circular_buffer::<f32>(4096)
    SMA_WINDOW = 32      # wave_view.rs:23 SumTreeSMA<f32, f32, 32>

    @staticmethod
    def process_seq(params, state, inputs):
        return {}, state

    @staticmethod
    def analyze(params, inputs):
        return {"samples": inputs["in"]}

    @classmethod
    def sweeps(cls, samples, fps: float = 60.0, sample_rate: int = 48_000):
        """Per-UI-frame oscilloscope sweeps, decimated the reference's way
        (wave_view.rs:70-123): the audio side copies each 128-block into a
        4096 ring, dropping whole blocks when it is full
        (wave_view.rs:159-176); each UI frame feeds the ring's fill level
        (0.0 if nothing arrived since the last frame) into a 32-tap simple
        moving average, draws min(average, available) samples and releases
        them.  Host-side draw logic over a rendered signal (a NumPy array
        or a tensor); returns a list of np.float32 arrays, one a frame."""
        if hasattr(samples, "detach"):
            samples = samples.detach().cpu().numpy()
        samples = np.asarray(samples, np.float32).ravel()
        per_frame = sample_rate / float(fps)
        ring: list[np.ndarray] = []         # queued blocks, oldest first
        avail = 0
        sma: list[float] = []
        out = []
        produced = 0.0
        blocks = [samples[i:i + 128] for i in range(0, len(samples), 128)]
        bi = 0
        while bi < len(blocks) or avail:
            produced += per_frame
            pushed = False
            while bi < len(blocks) and produced >= 128.0:
                blk = blocks[bi]
                produced -= 128.0
                bi += 1
                if avail + len(blk) <= cls.RING:     # else: dropped
                    ring.append(blk)
                    avail += len(blk)
                    pushed = True
            sma.append(float(avail) if pushed else 0.0)
            if len(sma) > cls.SMA_WINDOW:
                sma.pop(0)
            avg = int(sum(sma) / len(sma)) if sma else 0
            n = max(0, min(avg, avail))
            if n:
                flat = np.concatenate(ring)
                out.append(flat[:n])
                rest = flat[n:]
                ring = [rest] if rest.size else []
                avail = rest.size
            else:
                out.append(np.zeros(0, np.float32))
                if bi >= len(blocks):
                    break                   # drained, the average at 0
        return out


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

    @staticmethod
    def frequencies(params):
        """The frequency of each display-grid column of a param set (the
        grid ``analyze`` interpolates onto), as np.float32."""
        return grid_frequencies(int(params["fft_size"]),
                                float(params["lower_bound"]),
                                float(params["upper_bound"]), 48_000)

    @staticmethod
    def window(columns, params, end_frame: int):
        """The deque as the UI would see it after tick ``end_frame``: the
        reference pushes one column a tick and pops past buffer_size
        (spectrogram.rs:255-262), so it holds columns
        [max(0, end - n) : end] of a full render's ``columns`` (an array
        or a tensor, [..., n_frames, K])."""
        n = int(params["buffer_size"])
        end = max(0, min(int(end_frame), columns.shape[-2]))
        return columns[..., max(0, end - n) if n > 0 else end:end, :]


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
