"""The reference's arithmetic, named by a precision: a dict with
``products``, the type each matrix product's operands are rounded to, and
optionally ``cast``, the type the training policy casts the trained
weights and the input magnitude to (``use_amp``'s bf16), the gradient
passing through the cast unchanged.

``fp32`` products are float32 with TF32 switched off (see
:func:`strict_fp32`); ``tf32`` rounds both operands to TF32's 10-bit
mantissa, as the tensor cores do with TF32 on; ``bf16`` to bfloat16; ``fp8``
to float8 e4m3 scaled by the operand's largest magnitude, and the gradient
operands of the backward products to e5m2, as fp8 training does. Every sum
is float32, so each runs the same on the CPU and the card. A configuration
states one precision; its control is the same one type further down.
"""

from __future__ import annotations

import contextlib

import torch

@contextlib.contextmanager
def strict_fp32():
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN inside the
    block, as it was after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().float().clamp(min=1e-30)
    return (x.float() * scale).to(dtype).float() / scale


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    return _round_fp8(x, torch.float8_e4m3fn)


def round_e5m2(x: torch.Tensor) -> torch.Tensor:
    return _round_fp8(x, torch.float8_e5m2)


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd, rnd_grad):
        qa, qb = rnd(a), rnd(b)
        ctx.save_for_backward(qa, qb)
        ctx.rnd_grad = rnd_grad
        return qa @ qb

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        qg = ctx.rnd_grad(grad)
        return qg @ qb.T, qa.T @ qg, None, None


_ROUNDING = {"tf32": (round_tf32, round_tf32), "bf16": (round_bf16, round_bf16),
             "fp8": (round_e4m3, round_e5m2)}
_CAST = {None: lambda x: x, "bf16": round_bf16, "fp8": round_e4m3}


def cast(x: torch.Tensor, dtype: str | None) -> torch.Tensor:
    """``x`` rounded to the policy's ``dtype`` (None: as it is), the gradient
    passing through unchanged, as through the training policy's cast."""
    if dtype is None:
        return x
    return x + (_CAST[dtype](x.detach()) - x.detach())


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """[N, K] x [K, M] with the operands rounded to ``precision``: "fp32"
    (as they are), "tf32", "bf16" or "fp8"."""
    if precision == "fp32":
        return a @ b
    return _RoundedMatmul.apply(a, b, *_ROUNDING[precision])
