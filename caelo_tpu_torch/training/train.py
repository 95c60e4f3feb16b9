"""Unsupervised training steps for both auto-encoders (port of
``caelo_tpu/training/train.py``).

Replaces the reference's Keras training (``AE4SphericalRingPC.py:117-170``:
MSE/Adam; ``AE4VoxelPatch.py:163-235``: BCE) with a ``torch.optim.Adam``
step per batch, at optax's ``adam`` defaults.

Over a mesh of ranks (``parallel/mesh.py``), ``make_sharded_train_step``
is the data-parallel step (the batch over ``"data"``, gradients averaged
by an all-reduce) and ``shard_train_state`` optionally splits the patch
AE's dense layers over ``"model"`` (tensor parallelism, Megatron-style:
``fn1`` and ``fn4`` by output features, ``fn2`` and ``fn3`` by input
features).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard
from torch.nn import functional as F

from ..parallel.mesh import (all_reduce_sum, axis, block, broadcast_module,
                             data_sharding, shard_rows)


class TrainState(NamedTuple):
    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def adam(params, lr: float = 1e-3) -> torch.optim.Adam:
    """Adam at ``optax.adam``'s defaults: b1 0.9, b2 0.999, eps 1e-8 added
    outside the square root."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def respond_loss(model: nn.Module, batch: torch.Tensor) -> torch.Tensor:
    """MSE reconstruction (``AE4SphericalRingPC.py:150``) of ``(N, 3, H,
    W)`` ring-image batches."""
    return torch.mean((model(batch) - batch) ** 2)


def patch_loss(model: nn.Module, batch: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of ``(N, 16, 16, 16)`` occupancy patches
    (``AE4VoxelPatch.py:213``), from logits as
    ``optax.sigmoid_binary_cross_entropy`` computes it."""
    return F.binary_cross_entropy_with_logits(model(batch), batch)


def create_train_state(model: nn.Module,
                       optimizer: torch.optim.Optimizer | None = None
                       ) -> TrainState:
    """``model`` with its optimizer (default ``adam(lr=1e-3)``) at step 0."""
    if optimizer is None:
        optimizer = adam(model.parameters())
    return TrainState(model, optimizer, 0)


def make_train_step(loss_fn: Callable) -> Callable:
    """``step(state, batch) -> (state, loss)``: one gradient step of
    ``loss_fn(module, batch)`` on the state's module, in place; the loss is
    returned on the device, so a step needs no host synchronisation."""
    def step(state: TrainState, batch: torch.Tensor):
        state.module.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.module, batch)
        loss.backward()
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach()

    return step


# ------------------------------------------------------------------ sharding
def _tp_spec_for_path(path: str):
    """Tensor-parallel placement of the parameter named ``path`` over the
    ``"model"`` dimension: the wide dense layers of the patch AE split,
    everything else replicated.  ``nn.Linear`` weights are ``(out, in)``:
    ``fn1`` and ``fn4`` split their outputs (weight and bias rows,
    ``Shard(0)``), ``fn2`` and ``fn3`` their inputs (weight columns,
    ``Shard(1)``; the bias, added after the sum, replicated)."""
    names = path.split(".")
    if len(names) >= 2 and names[-1] in ("weight", "bias"):
        if names[-2] in ("fn1", "fn4"):
            return Shard(0)
        if names[-2] in ("fn2", "fn3") and names[-1] == "weight":
            return Shard(1)
    return Replicate()


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group (the
    input is replicated, each rank's gradient covers its shard)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _SumOverModel(torch.autograd.Function):
    """Partial sums added over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOverModel(torch.autograd.Function):
    """Last-axis blocks concatenated over the model group; the backward
    keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.cols = block(x.shape[-1] * size, index, size)
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.cols].contiguous(), None, None, None


class _ParallelLinear(nn.Module):
    """``linear``'s shard on this rank of the model group, a drop-in for it
    (replicated input and output): column-parallel (``Shard(0)``: local
    output features, gathered) or row-parallel (``Shard(1)``: local input
    features, the partial products summed, then the bias)."""

    def __init__(self, linear: nn.Linear, placement, group, index, size):
        super().__init__()
        self.group, self.index, self.size = group, index, size
        self.column = placement == Shard(0)
        rows = block(linear.out_features, index, size)
        self.cols = block(linear.in_features, index, size)
        w = linear.weight.detach()
        self.weight = nn.Parameter((w[rows] if self.column
                                    else w[:, self.cols]).clone())
        b = linear.bias.detach()
        self.bias = nn.Parameter((b[rows] if self.column else b).clone())

    def forward(self, x):
        x = _CopyToModel.apply(x, self.group)
        if self.column:
            y = F.linear(x, self.weight, self.bias)
            return _GatherOverModel.apply(y, self.group, self.index,
                                          self.size)
        y = _SumOverModel.apply(F.linear(x[..., self.cols], self.weight),
                                self.group)
        return y + self.bias


def shard_train_state(state: TrainState, mesh,
                      tensor_parallel: bool = False) -> TrainState:
    """Place the state on the mesh: the module's parameters and buffers
    replicated from the mesh's first rank, or, with ``tensor_parallel``,
    the patch AE's dense layers split over ``"model"`` by
    ``_tp_spec_for_path`` (the optimizer then holds the shards, its
    moments sliced alike).  Every rank of the mesh calls it."""
    module = state.module
    for name in ("model", "data"):
        broadcast_module(module, axis(mesh, name)[0])
    if not tensor_parallel:
        return state
    group, index, size = axis(mesh, "model")
    old = dict(module.named_parameters())
    for name, child in list(module.named_modules()):
        placement = _tp_spec_for_path(f"{name}.weight")
        if isinstance(child, nn.Linear) and placement != Replicate():
            parent, _, attr = name.rpartition(".")
            setattr(module.get_submodule(parent), attr, _ParallelLinear(
                child, placement, group, index, size))
    opt = state.optimizer
    new_opt = type(opt)(module.parameters(), **opt.defaults)
    new_opt.param_groups[0].update(
        {k: v for k, v in opt.param_groups[0].items() if k != "params"})
    for name, p in module.named_parameters():
        moments = opt.state.get(old[name])
        if moments:
            new_opt.state[p] = {k: _slice_like(v, p, old[name], name, index,
                                               size)
                                for k, v in moments.items()}
    return TrainState(module, new_opt, state.step)


def _slice_like(v, p, full, name, index, size):
    """An optimizer moment ``v`` of the full parameter ``full``, cut as
    ``full`` was cut into ``p``."""
    if not isinstance(v, torch.Tensor) or v.shape != full.shape or (
            p.shape == full.shape):
        return v
    dim = _tp_spec_for_path(name).dim
    return v.narrow(dim, block(v.shape[dim], index, size).start,
                    p.shape[dim]).clone()


def make_sharded_train_step(loss_fn: Callable, mesh):
    """The data-parallel (+ tensor-parallel, as ``shard_train_state``
    placed the module) step: ``step(state, batch) -> (state, loss)``,
    every rank of the mesh passing the same global ``batch`` and each data
    rank taking its contiguous block of it, the gradients averaged over
    ``"data"`` by an all-reduce, and ``loss`` the global batch's mean
    (equal blocks).  The optimizer is the state's, as in
    ``make_train_step``.  Returns ``(step, batch_placement)``, the DTensor
    placements of the batch over the mesh (JAX's ``batch_sharding``)."""
    group, _, n = axis(mesh)

    def step(state: TrainState, batch):
        local = shard_rows(batch, mesh)
        state.module.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.module, local)
        loss.backward()
        with torch.no_grad():
            for p in state.module.parameters():
                if p.grad is not None:
                    p.grad.copy_(all_reduce_sum(p.grad, group) / n)
        state.optimizer.step()
        loss = all_reduce_sum(loss.detach(), group) / n
        return state._replace(step=state.step + 1), loss

    return step, data_sharding(mesh)
