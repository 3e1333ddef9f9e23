"""Host-side audio I/O of the port: WAV files (wav.py), the sinc-16
resampler (resample.py) and impulse-response loading for the FIR node
(ir.py).  NumPy only; nothing here touches a device."""
