"""Impulse-response loading for the FIR node.

Mirrors the reference's IR-load pipeline (fir.rs:69-176): decode the WAV,
average channels to mono (the IR path averages, unlike the capture path
which sums -- fir.rs:117-124 vs devices.rs:254), resample to 48 kHz with
the sinc-16 interpolator, and store the taps REVERSED (fir.rs:160-170) --
the layout the FIR node persists inside graph JSON (fir.rs:58-62).
"""

from __future__ import annotations

import numpy as np

from dsp_stuff_tpu_torch.io import wav as wav_io
from dsp_stuff_tpu_torch.io.resample import resample_sinc16

SAMPLE_RATE = 48_000


def load_ir(path: str, normalize: bool = False) -> list[float]:
    """Returns reversed taps ready for ``Graph.add('fir', taps=...)``."""
    data, rate = wav_io.read_wav(path)
    mono = np.mean(np.atleast_2d(data), axis=0).astype(np.float32)
    if rate != SAMPLE_RATE:
        mono = resample_sinc16(mono, SAMPLE_RATE / float(rate))
    if normalize:
        peak = np.abs(mono).max()
        if peak > 0:
            mono = mono / peak
    return [float(v) for v in mono[::-1]]


def set_fir_ir(graph, node_id: int, path: str, normalize: bool = False):
    """Load an IR file into an existing FIR node (the file picker analog,
    fir.rs:69-113); stores file_name and taps as the reference config
    does."""
    node = graph.nodes[node_id]
    if node.cfg_name != "fir":
        raise ValueError(f"node {node_id} is {node.cfg_name!r}, not fir")
    node.params["taps"] = load_ir(path, normalize)
    node.params["file_name"] = path
    return node
