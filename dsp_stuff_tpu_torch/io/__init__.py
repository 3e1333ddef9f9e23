"""Host-side audio I/O of the port: WAV files (wav.py), the sinc-16
resampler (resample.py), the playback path's resampler and stereo
duplication (playback.py), impulse-response loading for the FIR node
(ir.py) and the ctypes binding to the host library native/dsp_host.cpp
(native.py).  NumPy and C++ only; nothing here touches a device."""
