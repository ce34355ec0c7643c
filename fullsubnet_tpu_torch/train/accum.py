"""Gradient accumulation (counterpart of ``fullsubnet_tpu/train/accum.py``).

A step over G equal, contiguous microbatches: each runs forward and
backward, the gradients sum in fp32 (the master weights' dtype) in each
parameter's ``.grad`` and are divided by G, and the loss is the mean of
the microbatches' losses. Equal microbatches keep the mean-reduced loss
and gradients those of the whole batch, up to the order of the sums.
Which rows form microbatch k is the Trainer's (``Trainer.loss_and_grads``).

The JAX package's "0 = auto" split (its v5e capacity picker) is not
ported: here 0, like 1, means one microbatch.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch


def largest_compatible_accum(requested: int, batch: int, data_div: int = 1) -> int:
    """Largest g <= requested with batch % (g * data_div) == 0 (>= 1).

    Used when a configured split meets a batch it does not divide: the
    nearest smaller split keeps the intent of the setting instead of
    running the step whole."""
    data_div = max(int(data_div), 1)
    g = max(1, min(int(requested), batch // data_div or 1))
    while g > 1 and batch % (g * data_div) != 0:
        g -= 1
    return g


def accumulated_loss(loss_fn: Callable[[int], torch.Tensor],
                     params: Sequence[torch.nn.Parameter], g_accum: int) -> torch.Tensor:
    """Run ``loss_fn(k)`` (microbatch k's loss) and its backward for k < G;
    leave the mean of the G gradients in each parameter's ``.grad`` and
    return the mean loss (detached, fp32). The gradients sum in the
    parameters' own dtype, fp32 for the masters, in microbatch order, as
    the JAX scan sums them."""
    for p in params:
        p.grad = None
    total = None
    for k in range(g_accum):
        loss = loss_fn(k)
        loss.backward()
        loss = loss.detach().float()
        total = loss if total is None else total + loss
    if g_accum > 1:
        for p in params:
            if p.grad is not None:
                p.grad.div_(g_accum)
        total = total / g_accum
    return total
