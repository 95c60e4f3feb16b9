"""Unsupervised training steps for both auto-encoders (port of
``caelo_tpu/training/train.py``).

Replaces the reference's Keras training (``AE4SphericalRingPC.py:117-170``:
MSE/Adam; ``AE4VoxelPatch.py:163-235``: BCE) with a ``torch.optim.Adam``
step per batch, at optax's ``adam`` defaults.  One device; the data- and
tensor-parallel step of the JAX module belongs to the multi-GPU slice.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn
from torch.nn import functional as F


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


def shard_train_state(*args, **kwargs):
    raise NotImplementedError(
        "the sharded train state is not ported yet: it comes with the "
        "multi-GPU slice (slice H of ROADMAP.md)")


def make_sharded_train_step(*args, **kwargs):
    raise NotImplementedError(
        "the sharded train step is not ported yet: it comes with the "
        "multi-GPU slice (slice H of ROADMAP.md)")
