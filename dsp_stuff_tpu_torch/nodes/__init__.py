"""Node library of the port, in the registration order of
nodes/mod.rs:65-90.  Importing this package registers every node type
of the JAX package."""

from dsp_stuff_tpu_torch.nodes import io_nodes    # Input, Output
from dsp_stuff_tpu_torch.nodes import simple      # Gain, Add, Mix, Mux, Demux
from dsp_stuff_tpu_torch.nodes import shapers     # Distort, ..., Muff
from dsp_stuff_tpu_torch.nodes import filters     # BiQuad, ..., Fir
from dsp_stuff_tpu_torch.nodes import delay       # Reverb, Chorus
from dsp_stuff_tpu_torch.nodes import gen         # SignalGen
from dsp_stuff_tpu_torch.nodes import analysis    # WaveView, Spectrogram, Pitch
