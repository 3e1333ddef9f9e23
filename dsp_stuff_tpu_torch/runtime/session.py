"""Offline render session: the one-call front door.

Replaces the reference's live device loop (devices.rs + per-node tokio
tasks) with batch rendering: load graph JSON, compile once, feed WAV or
array sources, collect rendered outputs and analysis aux data.  The render
runs on the device; WAV ingest and export (io/wav.py, io/playback.py)
stay on the host.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from dsp_stuff_tpu_torch.compiler.compile import compile_graph
from dsp_stuff_tpu_torch.graph import Graph, load_graph
from dsp_stuff_tpu_torch.io import wav as wav_io
from dsp_stuff_tpu_torch.io.playback import host_resample

BLOCK_SIZE = 128


def _pad_to_block(x: torch.Tensor, block_size: int):
    T = x.shape[-1]
    pad = (-T) % block_size
    return (F.pad(x, (0, pad)) if pad else x), T


def render(graph: Graph, inputs=None, T: int | None = None,
           block_size: int = BLOCK_SIZE, state=None, batch_shape=(),
           device="cuda"):
    """Render a graph offline on ``device`` (the card by default; pass
    device="cpu" for the CPU; raises RuntimeError without a CUDA device).

    inputs -- None, an [n_inputs, T] array or tensor, or {input_node_id: [T]}
    Returns (outputs [..., n_out, T] tensor, aux, state); trims any block
    padding."""
    cg = compile_graph(graph, block_size, device=device)

    def as_tensor(v):
        return v if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v, np.float32), device=cg.device)

    orig_T = None
    if isinstance(inputs, dict):
        padded = {}
        for k, v in inputs.items():
            padded[k], orig_T = _pad_to_block(as_tensor(v), block_size)
        inputs = padded
    elif inputs is not None:
        inputs, orig_T = _pad_to_block(as_tensor(inputs), block_size)
    if T is not None:
        orig_T = T
        T = T + ((-T) % block_size)
    outs, aux, state = cg.render(inputs, T=T, state=state,
                                 batch_shape=batch_shape)
    if orig_T is not None:
        outs = outs[..., :orig_T]
    return outs, aux, state


def to_numpy(tree):
    """A tree of dicts, lists and tensors with every tensor as a NumPy
    array on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def render_file(graph_path: str, in_wavs=None, out_wav: str | None = None,
                seconds: float | None = None, block_size: int = BLOCK_SIZE,
                out_rate: int | None = None, stereo_out: bool = False,
                resample_inputs: bool = False, device="cuda"):
    """Render a saved graph JSON over WAV files on ``device`` (the card by
    default; device="cpu" for the CPU; raises RuntimeError without a CUDA
    device).

    in_wavs -- path, list of paths (one per Input node, ascending id), or
               None (silence / generator-driven graphs need ``seconds``).
    out_rate -- export sample rate: the rendered 48 kHz outputs pass
               through the host sinc-16 resampler (io/playback.host_resample)
               before writing, the offline analog of the reference's
               device-rate output path (devices.rs:516-556).  None/48000
               writes 48 kHz directly.
    stereo_out -- duplicate a mono render to both stereo channels
               (devices.rs:476-480).  Requires exactly one output node.
    resample_inputs -- accept non-48 kHz input WAVs by resampling them to
               48 kHz through the same host sinc-16 on ingest (a
               convenience the reference lacks: its capture is pinned to
               48 kHz, devices.rs:280-286).  Off by default for parity.
    Returns (outputs, aux) as NumPy: the raw 48 kHz [n_out, T] f32 render,
    UNLESS out_rate or stereo_out is set, in which case the export is
    returned instead (resampled to out_rate and/or duplicated to stereo).
    """
    graph = load_graph(graph_path)
    inputs = None
    T = None
    if in_wavs is not None:
        if isinstance(in_wavs, str):
            in_wavs = [in_wavs]
        cols = []
        for p in in_wavs:
            data, rate = wav_io.read_wav(p)
            if rate != wav_io.SAMPLE_RATE:
                if not resample_inputs:
                    raise ValueError(
                        f"{p}: {rate} Hz; resample to 48 kHz first or pass "
                        "resample_inputs=True (the reference pins capture "
                        "at 48 kHz, devices.rs:281)")
                warnings.warn(f"{p}: resampling {rate} Hz -> 48000 Hz on "
                              "ingest (sinc-16)")
                cols.append(host_resample(wav_io.to_mono(data),
                                          wav_io.SAMPLE_RATE / rate))
            else:
                cols.append(wav_io.to_mono(data))
        T = max(len(c) for c in cols)
        inputs = np.stack([np.pad(c, (0, T - len(c))) for c in cols])
    elif seconds is not None:
        T = int(round(seconds * wav_io.SAMPLE_RATE))
    outs, aux, _ = render(graph, inputs, T=T, block_size=block_size,
                          device=device)
    outs, aux = outs.detach().cpu().numpy(), to_numpy(aux)
    export = outs
    export_rate = wav_io.SAMPLE_RATE
    if out_rate is not None and out_rate != wav_io.SAMPLE_RATE:
        ratio = out_rate / wav_io.SAMPLE_RATE
        export = np.stack([host_resample(ch, ratio) for ch in outs]) \
            if outs.shape[0] else outs
        export_rate = int(out_rate)
    if stereo_out:
        if export.shape[0] != 1:
            raise ValueError("stereo_out needs exactly one output node "
                             f"(graph has {export.shape[0]})")
        export = np.concatenate([export, export])   # dup, devices.rs:476-480
    if out_wav is not None and export.shape[0]:
        wav_io.write_wav(out_wav, export, sample_rate=export_rate)
    return (export if (out_rate or stereo_out) else outs), aux
