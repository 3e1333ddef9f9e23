"""Carry render state and parameters between the JAX package and the port.

Both packages key a compiled graph's state and parameters by
``str(node_id)``, each entry the node's own dict, with the same keys; a
feedback SCC's previous-block outputs sit under ``__cycle__<min id>``,
keyed ``"<node id>:<port>"``.  Lockstep counters (the reverb ring's
``pos``, the chorus clock ``t0``, the FIR's ``n_seen``) are integer
scalars there and Python ints here; the FIR's float64 histories hold f32
values and come across as f32.
Graphs cross with ``dumps_graph`` / ``loads_graph``, which keep node ids.
The JAX side hands over plain NumPy trees (``jax.tree.map(np.asarray,
state)``); nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf_to_torch(v, device):
    a = np.asarray(v)
    if np.issubdtype(a.dtype, np.integer):
        if a.ndim:
            raise ValueError(f"integer state arrays are not part of the "
                             f"port's state, got shape {a.shape}")
        return int(a)           # lockstep counters (reverb pos, chorus t0)
    # float64 leaks from the JAX package's x64 mode come back as f32
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _tree(tree, leaf):
    return {str(k): (None if entry is None
                     else {kk: leaf(vv) for kk, vv in entry.items()})
            for k, entry in tree.items()}


def state_from_jax(tree: dict, device) -> dict:
    """The port's state from a JAX ``CompiledGraph`` state tree (NumPy
    leaves): float arrays become f32 tensors on ``device``, integer
    scalars Python ints."""
    return _tree(tree, lambda v: _leaf_to_torch(v, device))


def params_from_jax(tree: dict, device, requires_grad: bool = False) -> dict:
    """The port's params from a JAX ``CompiledGraph.init_params()`` tree
    (NumPy leaves): f32 scalar leaf tensors on ``device``, as
    ``CompiledGraph.init_params`` makes them, so a fit in either package
    can start from the same numbers."""
    return _tree(tree, lambda v: torch.tensor(
        np.asarray(v, np.float32), device=device,
        requires_grad=requires_grad))


def state_to_numpy(state: dict) -> dict:
    """The port's state as a NumPy tree in the JAX package's layout
    (tensors -> float32 arrays, ints -> int32 scalars)."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.int32(v)
    return _tree(state, leaf)
