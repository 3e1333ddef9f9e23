"""Differentiable parameter fitting: optimize a graph's sliders by gradient.

The port of dsp_stuff_tpu/train/fit.py.  The compiled graph exposes its
non-static sliders as {node_id: {param: 0-d tensor}}
(``CompiledGraph.init_params``); the loss renders the graph with those
tensors as overrides and measures the distance to a target, and autograd
carries the gradient back to every slider.  Overridden nodes leave the
fused chain, cascade and cycle paths (as in the JAX package), so a fit of
every slider runs node by node; on a CUDA device the low_pass / high_pass solves run
the first-order kernel forward and backward, and the envelope the
envelope kernel forward and the first-order kernel backward.

Batch is a plain leading dimension of the inputs and the target: the loss
is the mean over streams of each stream's distance, as the JAX package's
vmapped loss computes it.  ``make_sharded_train_step`` splits that batch
over a parallel.mesh ``Mesh`` of devices in one process.  Gradients flow
through the fused paths too (their autograd Functions, ops/chain_segment.py
and ops/cycle_segment.py, whose backwards are the reverse chain and cycle
kernels), so a fit of some sliders keeps the rest on the chain and cycle
kernels, and under ``exact`` through the sequential
kernel's reverse mode.  A feedback cycle that runs the per-node scan (a
fit overrides its members' sliders) is differentiated through its loop
over buffers (compiler/cycle_loop.py), on the card as captured CUDA
graphs in both directions: the optimizer's in-place updates and
``clamp_params`` move the override values, which the loop binds as data,
so a later step captures nothing.  ``adam`` is optax.adam's update (same
b1, b2, eps and bias correction) as a ``torch.optim.Adam`` factory.
"""

from __future__ import annotations

from typing import Callable

import torch

from dsp_stuff_tpu_torch.compiler.compile import CompiledGraph


def clamp_params(cg: CompiledGraph, params: dict) -> dict:
    """Project each slider back into its [lo, hi] range (the UI invariant:
    the reference's sliders are range-clamped), in place and outside
    autograd.  Returns ``params``."""
    with torch.no_grad():
        for nid_s, entry in params.items():
            spec = cg.graph.nodes[int(nid_s)].spec
            for name, v in entry.items():
                v.clamp_(spec.param(name).lo, spec.param(name).hi)
    return params


def mse_loss(y, target):
    """Mean squared error of each stream: y, target [..., n_out, T] ->
    [...]."""
    return torch.mean((y - target) ** 2, dim=(-2, -1))


def spectral_loss(y, target, fft_size: int = 1024):
    """Log-magnitude STFT distance of each stream ([..., n_out, T] ->
    [...]): far better conditioned than MSE for fitting nonlinear shapers
    (phase-insensitive).  T must be a multiple of ``fft_size``."""
    win = torch.hann_window(fft_size, periodic=False, dtype=y.dtype,
                            device=y.device)

    def mag(x):
        frames = x.reshape(*x.shape[:-1], -1, fft_size)
        return torch.abs(torch.fft.rfft(frames * win, dim=-1))
    eps = 1e-6
    return torch.mean((torch.log(mag(y) + eps)
                       - torch.log(mag(target) + eps)) ** 2, dim=(-3, -2, -1))


def make_loss_fn(cg: CompiledGraph, distance: Callable = mse_loss):
    """loss(params, state, ext, target) -> 0-d tensor.

    ``ext`` {input_id: [..., T]} and ``target`` [..., n_out, T] are tensors
    on the graph's device with the same leading batch dimensions;
    ``distance`` maps (y, target) to one value per stream."""

    def loss(params, state, ext, target):
        _, outs, _ = cg.fn(state, ext, params)
        y = torch.stack([outs[i] for i in cg.output_ids], dim=-2)
        return torch.mean(distance(y, target))

    return loss


def adam(learning_rate: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Callable:
    """optax.adam as a factory of ``torch.optim.Adam``: the same
    bias-corrected update, lr * m_hat / (sqrt(v_hat) + eps)."""
    def make(tensors):
        return torch.optim.Adam(tensors, lr=learning_rate, betas=(b1, b2),
                                eps=eps)
    return make


def _leaves(params: dict) -> list:
    return [v for _, entry in sorted(params.items())
            for _, v in sorted(entry.items())]


def make_train_step(cg: CompiledGraph, optimizer: Callable | None = None,
                    distance: Callable = mse_loss):
    """Returns (step, init_opt_state):

        opt_state = init_opt_state(params)    # a torch optimizer
        step(params, opt_state, state, ext, target)
            -> (params, opt_state, loss)

    ``params`` holds leaf tensors that require grad; ``step`` updates them
    in place (one Adam step, then ``clamp_params``) and returns the loss
    before the update, detached.  ``optimizer`` is a factory like
    ``adam(...)`` (default ``adam(1e-2)``, as optax.adam(1e-2))."""
    make_opt = optimizer or adam(1e-2)
    loss_fn = make_loss_fn(cg, distance)

    def init_opt_state(params):
        return make_opt(_leaves(params))

    def step(params, opt_state, state, ext, target):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, state, ext, target)
        loss.backward()
        opt_state.step()
        clamp_params(cg, params)
        return params, opt_state, loss.detach()

    return step, init_opt_state


def make_sharded_train_step(cg: CompiledGraph, mesh,
                            optimizer: Callable | None = None,
                            distance: Callable = mse_loss):
    """The training step over a parallel.mesh ``Mesh``: data parallel over
    streams, as the JAX package's make_sharded_train_step is (there XLA
    inserts the gradient all-reduce from the shardings).

    Returns (step, init_opt_state), called as make_train_step's are, with
    ext {input_id: [S, T]} and target [S, n_out, T] (S divisible by the
    mesh size) anywhere, and ``params`` leaf tensors on the mesh's first
    device.  Each step copies the parameters to every shard's device as
    they stand at its start (a caller may edit them, or pass another dict
    with its own optimizer, between steps), renders each
    shard's streams with the graph compiled for its device and weights the
    shard's loss by its share of the streams (so the sum is the mean over
    all streams), sums the shards' gradients onto the first device in
    shard order (deterministic), steps the optimizer there and clamps.
    Returns the loss before the update, detached, on the first device."""
    from dsp_stuff_tpu_torch.parallel.mesh import (compiled_for, shard_bounds,
                                                   state_to)
    make_opt = optimizer or adam(1e-2)
    first = mesh.devices[0]
    shards = [(d, make_loss_fn(compiled_for(cg, d), distance))
              for d in mesh.devices]

    def init_opt_state(params):
        return make_opt(_leaves(params))

    def step(params, opt_state, state, ext, target):
        leaves = _leaves(params)
        if any(v.device != first for v in leaves):
            raise ValueError(f"make_sharded_train_step: the parameters must "
                             f"lie on the mesh's first device {first}")
        S = target.shape[0]
        total = None
        grads = None
        for (lo, hi), (dev, loss_fn) in zip(shard_bounds(S, mesh), shards):
            p = {n: {k: v.detach().to(dev).requires_grad_(True)
                     for k, v in e.items()} for n, e in params.items()}
            loss = loss_fn(p, state_to(state, dev),
                           {k: v[lo:hi].to(dev) for k, v in ext.items()},
                           target[lo:hi].to(dev)) * ((hi - lo) / S)
            g = torch.autograd.grad(loss, _leaves(p))
            loss = loss.detach().to(first)
            total = loss if total is None else total + loss
            g = [gi.to(first) for gi in g]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        for v, g in zip(leaves, grads):
            v.grad = g
        opt_state.step()
        clamp_params(cg, params)
        return params, opt_state, total

    return step, init_opt_state


def fit(cg: CompiledGraph, ext, target, *, steps: int = 200,
        optimizer: Callable | None = None, distance: Callable = mse_loss,
        params=None, verbose: bool = False):
    """Fit the graph's sliders so its render of ``ext`` matches ``target``.

    ext    -- {input_node_id(str): [..., T]} external inputs (batch leading)
    target -- [..., n_out, T] desired output
    params -- starting sliders (default ``cg.init_params()``); copied, not
              changed
    Returns (params, losses [steps]): the fitted sliders, detached 0-d
    tensors on the graph's device, and each step's loss before its
    update."""
    start = params if params is not None else cg.init_params()
    params = {n: {k: cg._on_device(v, f"params[{n!r}][{k!r}]")
                  .detach().clone().requires_grad_(True)
                  for k, v in entry.items()}
              for n, entry in start.items()}
    ext = {str(k): cg._on_device(v, f"input {k!r}") for k, v in ext.items()}
    target = cg._on_device(target, "target")
    state = cg.init_state()
    step, init_opt_state = make_train_step(cg, optimizer, distance)
    opt_state = init_opt_state(params)
    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, state, ext, target)
        losses.append(float(loss))
        if verbose and (i % max(steps // 10, 1) == 0):
            print(f"step {i:4d}  loss {losses[-1]:.3e}")
    return ({n: {k: v.detach() for k, v in entry.items()}
             for n, entry in params.items()}, losses)
