"""WAV read/write (host side).

The offline analog of the reference's cpal device layer (devices.rs):
sample-format conversion to/from internal f32, and the capture-path
channel handling -- mono passes through, stereo is *summed* (not averaged)
to mono (devices.rs:254, quirk SURVEY.md 2.4 #10).  RIFF parsing in
NumPy (PCM 8/16/24/32 and IEEE float32/64), no external decoders.  When
the host library (io/native.py, native/dsp_host.cpp) is built, it takes
over the decode and encode; the NumPy path here is the fallback and the
semantic definition, and gives the same samples.
"""

from __future__ import annotations

import struct

import numpy as np

SAMPLE_RATE = 48_000


def read_wav(path: str):
    """Returns (data [channels, T] float32 in [-1, 1], sample_rate).  Uses
    the host library's decoder when it is built."""
    from dsp_stuff_tpu_torch.io import native
    if native.available():
        return native.wav_read(path)
    return _read_wav_py(path)


def _read_wav_py(path: str):
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            cid, size = head[:4], struct.unpack("<I", head[4:])[0]
            payload = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    (tag, n_ch, rate, _brate, _align, bits) = struct.unpack("<HHIIHH", fmt[:16])
    if tag == 0xFFFE and len(fmt) >= 40:   # WAVE_FORMAT_EXTENSIBLE
        tag = struct.unpack("<H", fmt[24:26])[0]
    if tag == 3:      # IEEE float
        dt = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(data, dt).astype(np.float32)
    elif tag == 1:    # PCM
        if bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            vals = (raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            vals = np.where(vals & 0x800000, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / 8388608.0
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM width {bits}")
    else:
        raise ValueError(f"unsupported WAV format tag {tag}")
    x = x.reshape(-1, n_ch).T
    return np.ascontiguousarray(x), rate


def write_wav(path: str, data, sample_rate: int = SAMPLE_RATE,
              float_format: bool = True):
    """data: [T] or [channels, T] float32; IEEE float32 or 16-bit PCM.
    Uses the host library's encoder when it is built."""
    from dsp_stuff_tpu_torch.io import native
    if native.available():
        return native.wav_write(path, data, sample_rate, float_format)
    return _write_wav_py(path, data, sample_rate, float_format)


def _write_wav_py(path: str, data, sample_rate: int = SAMPLE_RATE,
                  float_format: bool = True):
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[None]
    n_ch, T = data.shape
    inter = np.ascontiguousarray(data.T)
    if float_format:
        payload = inter.astype("<f4").tobytes()
        bits, tag = 32, 3
    else:
        clipped = np.clip(inter, -1.0, 1.0)
        payload = (clipped * 32767.0).astype("<i2").tobytes()
        bits, tag = 16, 1
    brate = sample_rate * n_ch * bits // 8
    align = n_ch * bits // 8
    fmt = struct.pack("<HHIIHH", tag, n_ch, sample_rate, brate, align, bits)
    with open(path, "wb") as f:
        body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt \
            + b"data" + struct.pack("<I", len(payload)) + payload
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def to_mono(data):
    """Capture-path channel folding: 1ch passthrough, 2ch summed pairwise
    (devices.rs:248-262); >2 channels is a hard error there too
    (devices.rs:346-351)."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        return data
    if data.shape[0] == 1:
        return data[0]
    if data.shape[0] == 2:
        return data[0] + data[1]
    raise ValueError(f"devices with {data.shape[0]} channels are unsupported "
                     "(reference parity: devices.rs:346-351)")
