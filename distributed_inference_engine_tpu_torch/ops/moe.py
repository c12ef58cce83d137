"""Mixture-of-experts MLP, the serving path (port of ``ops/moe.py``).

``moe_mlp`` is the JAX function's drop-free inference form (``exact=True``):

- the router runs in fp32, ``x.float() @ w_router.float()``, then softmax;
- each row keeps its top ``experts_per_token`` experts, their gates
  renormalised to sum to one (``gate / max(sum, 1e-9)``, Mixtral's
  convention); on an exact tie the lower expert index wins, as
  ``lax.top_k`` orders it (a stable descending sort: ``torch.topk`` on
  the card promises no order among equal values);
- every expert runs over every row, the rows flattened to ``[n, D]``:
  ``act(x W_gate) * x W_up`` then ``W_down`` (swiglu; any other MLP runs
  ungated gelu on ``x W_up``, as in JAX);
- the combine sums each expert's output, weighted by its ``[n, E]`` gate
  column, in fp32 and rounds to the activation dtype once.

The experts run one at a time into the fp32 sum, where the JAX function
materialises ``[E, n, F]`` for gate, up and their product: at the mixed
step's or an admission's thousands of rows that is gigabytes. Each
expert's product takes ``matmul_any`` on its 2-D view of the layer's
stacked expert weight (``w[e]``), so a quantized expert goes to the int4
kernel or the int8 widening like any dense projection. Every shape is
static and nothing is read on the host, so a decode chunk or a mixed step
with experts is captured in one CUDA graph.

Running every expert over every row costs ``n_experts /
experts_per_token`` times the routed FLOPs (4x at Mixtral's 8 and 2). At
decode the expert weights' bytes dominate either way; a routed, grouped
expert GEMM for the mixed step and the admission prefill is later work.

Not ported: the capacity-bounded GShard dispatch (``exact=False``, the
training path) and the Switch load-balance loss; both come with training
(ROADMAP.md A13). ``moe_capacity`` is the JAX static capacity rule.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .quant import matmul_any


def moe_capacity(n_tokens: int, n_experts: int, experts_per_token: int,
                 capacity_factor: float) -> int:
    """Static per-expert capacity for a batch of ``n_tokens`` tokens."""
    c = math.ceil(n_tokens * experts_per_token / n_experts * capacity_factor)
    return max(int(c), experts_per_token)


def route(w_router: torch.Tensor, xf: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of ``xf [n, D]`` -> (probs [n, E] fp32, renormalised gates
    [n, k], expert indices [n, k] int64): the top ``k`` by probability,
    the lower index first among equal ones (``lax.top_k``'s order)."""
    logits = xf.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def moe_mlp(spec, blk: Dict[str, Any], x: torch.Tensor,
            exact: bool = True) -> torch.Tensor:
    """MoE feed-forward over ``x [B, T, D]`` -> ``[B, T, D]`` in x's dtype
    (the JAX function's first output with ``exact=True``)."""
    if not exact:
        raise NotImplementedError(
            "the capacity-bounded MoE dispatch (exact=False, training) is "
            "not ported to PyTorch yet (ROADMAP.md A13)")
    b, t, d = x.shape
    n_exp = spec.n_experts
    xf = x.reshape(b * t, d)
    _, gate, idx = route(blk["w_router"], xf, spec.experts_per_token)
    # [n, E] gate weights: a row's k gates at its experts, zero elsewhere
    weights = torch.zeros((xf.shape[0], n_exp), dtype=torch.float32,
                          device=x.device).scatter_(1, idx, gate)
    out = torch.zeros((xf.shape[0], d), dtype=torch.float32,
                      device=x.device)
    for e in range(n_exp):
        if spec.mlp == "swiglu":
            g = matmul_any(xf, blk["w_gate"][e])
            u = matmul_any(xf, blk["w_up"][e])
            h = F.silu(g.float()).to(x.dtype) * u
        else:
            u = matmul_any(xf, blk["w_up"][e])
            h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
        y = matmul_any(h, blk["w_down"][e])
        out.addcmul_(weights[:, e:e + 1], y.float())
    return out.to(x.dtype).reshape(b, t, d)
