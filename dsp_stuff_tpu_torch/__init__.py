"""dsp_stuff_tpu_torch -- the PyTorch / CUDA port of dsp_stuff_tpu.

A second package beside the JAX one (which stays the reference): the same
graph JSON, node semantics, precision policies and state handoff, with
tensors on an explicit device and, on an NVIDIA GPU, hand-written CUDA
kernels in place of the JAX package's Pallas TPU kernels.

The port carries every node type of the JAX package, the bench chain
(input -> gain -> biquad -> overdrive -> low_pass -> high_pass -> distort
-> chebyshev -> reverb -> output) and the five presets
(models/presets.py: config3's oversampled shapers, ops/oversample.py;
config4's FIR convolution reverb, ops/fir.py, with impulse responses
loaded from WAV files by io/ir.py), feedback cycles included, gradient
fitting of a graph's sliders (train), and the runtime: WAV rendering
(runtime/session.render_file), the block-by-block streaming session with
its host-side rings and device-rate playback (runtime/stream.py,
io/playback.py, the host library native/dsp_host.cpp through
io/native.py), checkpoints (runtime/checkpoint.py), the command line
(``python -m dsp_stuff_tpu_torch``) and the debug tools (utils/obs.py).
It has five CUDA kernels: the chain kernel (csrc/chain_kernel.cu, with
the chorus's mtap stage), the cycle kernel (csrc/cycle_kernel.cu), the
envelope kernel (csrc/envelope_kernel.cu), the first-order recurrence
kernel (csrc/first_order_kernel.cu: the fitted filters forward and
backward, and muff's tone stack) and the sequential kernel
(csrc/sequential_kernel.cu: the exact policy's recurrences, with a
reverse mode for their gradients).  Every render is differentiable on
the card, its fused chain segments and cycle programs included, and
parallel.mesh splits a batch of streams over several devices.  Every
entry point runs on the card unless the caller passes device="cpu".

Public API:
    Graph, GraphNode, load_graph, loads_graph, save_graph, dumps_graph
    compile_graph, CompiledGraph       -- graph -> render program on a device
    render, render_file                -- one-call offline render (arrays,
                                          WAV files)
    StreamSession                      -- block-by-block streaming
    save_checkpoint, load_checkpoint   -- state + params + graph on disk
    train.fit                          -- fit, make_train_step, make_loss_fn,
                                          make_sharded_train_step
    parallel.mesh                      -- make_mesh, shard_streams,
                                          render_sharded
    policy, get_policy, set_policy     -- precision policy ('fast', 'parity',
                                          'exact')
    REGISTRY, register_node, NodeSpec  -- the port's node-type registry
"""

from dsp_stuff_tpu_torch.utils.precision import (PrecisionPolicy, get_policy,
                                                 set_policy, policy)
from dsp_stuff_tpu_torch.registry import REGISTRY, register_node, NodeSpec
from dsp_stuff_tpu_torch.graph import (Graph, GraphNode, load_graph,
                                       loads_graph, save_graph, dumps_graph)
from dsp_stuff_tpu_torch.compiler.compile import compile_graph, CompiledGraph
from dsp_stuff_tpu_torch.runtime.session import render, render_file
from dsp_stuff_tpu_torch.runtime.stream import StreamSession
from dsp_stuff_tpu_torch.runtime.checkpoint import (save_checkpoint,
                                                    load_checkpoint)

# Importing the node library registers every ported node type.
import dsp_stuff_tpu_torch.nodes  # noqa: F401
from dsp_stuff_tpu_torch import parallel, train

BLOCK_SIZE = 128        # reference block size (node.rs:257 BUF_SIZE)
SAMPLE_RATE = 48_000    # reference fixed rate (devices.rs:281, README.md:48)

__all__ = [
    "Graph", "GraphNode", "load_graph", "loads_graph", "save_graph",
    "dumps_graph", "compile_graph", "CompiledGraph", "render", "render_file",
    "StreamSession", "save_checkpoint", "load_checkpoint", "train",
    "parallel",
    "REGISTRY", "register_node", "NodeSpec", "PrecisionPolicy",
    "get_policy", "set_policy", "policy",
    "BLOCK_SIZE", "SAMPLE_RATE",
]
