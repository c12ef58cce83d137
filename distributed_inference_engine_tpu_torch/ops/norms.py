"""Normalization (port of ``ops/norms.py``): fp32 reductions whatever the
activation dtype, cast back at the end."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Llama-style RMSNorm over the trailing dim, in the JAX op order:
    mean of squares, ``x * (1 / sqrt(ms + eps))``, times the scale."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * (1.0 / torch.sqrt(ms + eps))
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """GPT-2-style LayerNorm over the trailing dim, in the JAX op order:
    mean, mean of squared deviations, ``(x - mean) / sqrt(var + eps)``,
    times the scale plus the bias, all in fp32."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)
