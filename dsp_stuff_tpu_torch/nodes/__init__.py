"""Node library of the port: the node types of the bench chain, in the
registration order of nodes/mod.rs:65-90.  Importing this package
registers them; registry.NOT_PORTED names the rest."""

from dsp_stuff_tpu_torch.nodes import io_nodes    # Input, Output
from dsp_stuff_tpu_torch.nodes import simple      # Gain
from dsp_stuff_tpu_torch.nodes import shapers     # Distort, Overdrive, Chebyshev
from dsp_stuff_tpu_torch.nodes import filters     # BiQuad, LowPass, HighPass
from dsp_stuff_tpu_torch.nodes import delay       # Reverb (feedback echo)
