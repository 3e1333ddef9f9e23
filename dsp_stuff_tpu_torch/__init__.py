"""dsp_stuff_tpu_torch -- the PyTorch / CUDA port of dsp_stuff_tpu.

A second package beside the JAX one (which stays the reference): the same
graph JSON, node semantics, precision policies and state handoff, with
tensors on an explicit device and, on an NVIDIA GPU, hand-written CUDA
kernels in place of the JAX package's Pallas TPU kernels.

The port carries the bench chain (input -> gain -> biquad -> overdrive ->
low_pass -> high_pass -> distort -> chebyshev -> reverb -> output) and the
presets config1, config2 and config5 (models/presets.py), feedback cycles
included, with three CUDA kernels: the chain kernel
(csrc/chain_kernel.cu, with the chorus's mtap stage), the cycle kernel
(csrc/cycle_kernel.cu) and the envelope kernel (csrc/envelope_kernel.cu).
ROADMAP.md lists what is still to port.

Public API:
    Graph, load_graph, loads_graph, save_graph, dumps_graph
    compile_graph, CompiledGraph       -- graph -> render program on a device
    render                             -- one-call offline render
    policy, get_policy, set_policy     -- precision policy ('fast', 'parity')
    REGISTRY                           -- the port's node-type registry
"""

from dsp_stuff_tpu_torch.utils.precision import (PrecisionPolicy, get_policy,
                                                 set_policy, policy)
from dsp_stuff_tpu_torch.registry import REGISTRY
from dsp_stuff_tpu_torch.graph import (Graph, load_graph, loads_graph,
                                       save_graph, dumps_graph)
from dsp_stuff_tpu_torch.compiler.compile import compile_graph, CompiledGraph
from dsp_stuff_tpu_torch.runtime.session import render

# Importing the node library registers every ported node type.
import dsp_stuff_tpu_torch.nodes  # noqa: F401

BLOCK_SIZE = 128        # reference block size (node.rs:257 BUF_SIZE)
SAMPLE_RATE = 48_000    # reference fixed rate (devices.rs:281, README.md:48)

__all__ = [
    "Graph", "load_graph", "loads_graph", "save_graph", "dumps_graph",
    "compile_graph", "CompiledGraph", "render",
    "REGISTRY", "PrecisionPolicy", "get_policy", "set_policy", "policy",
    "BLOCK_SIZE", "SAMPLE_RATE",
]
