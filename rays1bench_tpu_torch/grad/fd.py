"""Finite-difference gradient check (rays1bench_tpu/grad/fd.py; BASELINE.json:
"FD-verified gradients" with respect to sphere centers, radii, albedos)."""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch


def fd_check(f: Callable, params: Dict[str, torch.Tensor],
             coords: Sequence[Tuple[str, int]], eps: float = 1e-3):
    """Compare torch.autograd.grad of f at params against central
    differences.

    Args:
      f: scalar function of a dict of tensors.
      params: the point to check at.
      coords: (param_name, flat_index) coordinates to probe.
      eps: central-difference step, added to the float32 coordinate (and
        rounded to float32), as the JAX package perturbs its numpy copy.

    Returns a list of (name, idx, analytic, numeric, abs_err, rel_err)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    grads = torch.autograd.grad(f(leaves), list(leaves.values()),
                                allow_unused=True)
    g = dict(zip(leaves, grads))

    def eval_at(name, idx, delta):
        pert = params[name].detach().clone()
        pert.view(-1)[idx] += delta
        with torch.no_grad():
            return float(f(dict(params, **{name: pert})))

    rows = []
    for name, idx in coords:
        numeric = (eval_at(name, idx, +eps) - eval_at(name, idx, -eps)) \
            / (2 * eps)
        analytic = 0.0 if g[name] is None else float(g[name].view(-1)[idx])
        abs_err = abs(analytic - numeric)
        denom = max(abs(analytic), abs(numeric), 1e-12)
        rows.append((name, idx, analytic, numeric, abs_err, abs_err / denom))
    return rows
