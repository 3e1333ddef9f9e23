"""Data parallelism over streams: the port of dsp_stuff_tpu/parallel/mesh.py.

The reference is single-process, and so is the JAX package: one controller
drives a mesh of devices, the stream axis sharded across it, and no
collective runs in the forward render because streams are independent.
The port keeps that shape in one process over a list of devices (a
``Mesh``): ``render_sharded`` splits the leading stream axis into one
shard a device and renders each shard with the graph compiled for that
device.  The gradient reduction of train/fit.make_sharded_train_step sums
the shards' gradients onto the first device in shard order.  A device may
appear more than once (two shards of one card).  A multi-process version
(``torch.distributed``, one process a card) is left for a box with more
than one card.

Lockstep state leaves (the reverb's write position ``pos`` and the
chorus's sample clock ``t0``, Python ints) are shared by every stream:
they come back once, taken from shard 0 and checked equal across shards,
as the JAX package returns them unbatched.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from dsp_stuff_tpu_torch.compiler.compile import (CompiledGraph,
                                                  _resolve_device,
                                                  compile_graph)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices the stream axis is split over."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None) -> Mesh:
    """A mesh of ``devices`` (names or torch.devices; repeats allowed),
    by default every visible CUDA device; raises without one unless the
    devices are given (``devices=["cpu"] * 8`` for a CPU mesh)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices= "
                "(e.g. [\"cpu\"] * 8) for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(_resolve_device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: the mesh needs at least one device")
    return Mesh(devices)


def shard_bounds(S: int, mesh: Mesh) -> list:
    """[(lo, hi)] of each shard's streams: S divides evenly over the mesh,
    as the JAX package requires."""
    if S % mesh.size:
        raise ValueError(f"{S} streams do not divide over a mesh of "
                         f"{mesh.size} devices")
    n = S // mesh.size
    return [(i * n, (i + 1) * n) for i in range(mesh.size)]


def shard_streams(arr, mesh: Mesh) -> list:
    """``[S, ...]`` split along its first axis, shard i on mesh device i."""
    arr = torch.as_tensor(arr)
    return [arr[lo:hi].to(d) for (lo, hi), d in
            zip(shard_bounds(arr.shape[0], mesh), mesh.devices)]


_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def compiled_for(cg: CompiledGraph, device) -> CompiledGraph:
    """``cg``'s graph compiled for ``device`` (``cg`` itself on its own
    device), compiled once a device."""
    device = _resolve_device(device)
    if device == cg.device:
        return cg
    per = _REPLICAS.setdefault(cg, {})
    if device not in per:
        per[device] = compile_graph(cg.graph, cg.block_size, device=device)
    return per[device]


def state_to(state: dict, device) -> dict:
    """A state dict with every tensor moved to ``device`` (lockstep ints
    as they are)."""
    return {k: ({kk: (v.to(device) if isinstance(v, torch.Tensor) else v)
                 for kk, v in st.items()} if isinstance(st, dict) else st)
            for k, st in state.items()}


def _same(parts, what: str):
    """The one value every shard returned for a lockstep leaf."""
    for p in parts[1:]:
        same = (torch.equal(p.to(parts[0].device), parts[0])
                if isinstance(p, torch.Tensor) else p == parts[0])
        if not same:
            raise RuntimeError(f"render_sharded: shards disagree on the "
                               f"lockstep value {what}")
    return parts[0]


def _merge(parts, sizes, device, what: str = "output"):
    """The shards' results as one.  ``render(batch_shape=(n,))`` batches
    every tensor it returns (outputs, aux and state), so a tensor
    concatenates along its first axis on ``device``; anything else is a
    lockstep Python value, the same in every shard."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _merge([p[k] for p in parts], sizes, device,
                          f"{what}[{k!r}]") for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_merge(list(z), sizes, device, f"{what}[{i}]")
                           for i, z in enumerate(zip(*parts)))
    if not isinstance(first, torch.Tensor):
        return _same(parts, what)
    for p, n in zip(parts, sizes):
        if not p.dim() or p.shape[0] != n:
            raise RuntimeError(f"render_sharded: {what} of shape "
                               f"{tuple(p.shape)} is not batched over the "
                               f"shard's {n} streams")
    return torch.cat([p.to(device) for p in parts], dim=0)


def render_sharded(compiled: CompiledGraph, inputs, mesh: Mesh | None = None,
                   T: int | None = None):
    """Batched render with the leading stream axis split over the mesh,
    each shard from the graph's initial state.

    inputs -- [S, n_inputs, T] (S divisible by the mesh size), or
              {input id: [S, T]}
    Returns (outs [S, n_out, T], aux, state) on ``compiled``'s device, as
    ``compiled.render(inputs, batch_shape=(S,))`` returns them; every
    shard runs on its own device with the graph compiled for it."""
    mesh = mesh or make_mesh()
    if isinstance(inputs, dict):
        ext = {str(k): torch.as_tensor(v) for k, v in inputs.items()}
        S = next(iter(ext.values())).shape[0]
    else:
        inputs = torch.as_tensor(inputs)
        S = inputs.shape[0]
    bounds = shard_bounds(S, mesh)
    results = []
    for (lo, hi), dev in zip(bounds, mesh.devices):
        cg = compiled_for(compiled, dev)
        part = ({k: v[lo:hi].to(dev) for k, v in ext.items()}
                if isinstance(inputs, dict)
                else inputs[lo:hi].to(dtype=torch.float32, device=dev))
        results.append(cg.render(part, T=T, batch_shape=(hi - lo,)))
    sizes = [hi - lo for lo, hi in bounds]
    outs, aux, st = (_merge([r[i] for r in results], sizes, compiled.device,
                            name)
                     for i, name in enumerate(("outs", "aux", "state")))
    return outs, aux, st
