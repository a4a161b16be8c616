"""Checkpoint / resume of the inverse-rendering fit, in the JAX package's
.npz layout (rays1bench_tpu/grad/checkpoint.py), read and written with numpy
only.

The file holds `step` (the fit's step counter), `param::<name>` for each
parameter, and optax Adam's state as flattened leaves `opt::0..` with their
tree description `opt::treedef`: leaf 0 is Adam's update count (int32), then
the first moments `mu` and the second moments `nu`, each in sorted parameter
order. They map onto torch.optim.Adam's per-parameter `step`, `exp_avg` and
`exp_avg_sq`, bits unchanged, so a fit the JAX package checkpointed resumes
here and one checkpointed here resumes there (the port writes the tree
description the JAX package checks).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def _treedef(names) -> str:
    """The tree description the JAX package stores for optax.adam's state
    over a dict of these parameter names."""
    d = "{" + ", ".join(f"'{n}': *" for n in sorted(names)) + "}"
    return (f"PyTreeDef((CustomNode(namedtuple[ScaleByAdamState], "
            f"[*, {d}, {d}]), CustomNode(namedtuple[EmptyState], [])))")


def save(path: str, params: Dict[str, torch.Tensor],
         optimizer: torch.optim.Adam, step: int) -> None:
    """Atomically write (params, Adam state, step) to `path` (.npz)."""
    names = sorted(params)
    out = {"step": np.asarray(step)}
    for name, value in params.items():
        out[f"param::{name}"] = value.detach().cpu().numpy()
    states = [optimizer.state.get(params[n], {}) for n in names]
    count = int(states[0]["step"]) if states and states[0] else 0
    moment = lambda st, key, n: (st[key].detach().cpu().numpy() if st else
                                 np.zeros(params[n].shape, np.float32))
    leaves = ([np.asarray(count, np.int32)]
              + [moment(st, "exp_avg", n) for st, n in zip(states, names)]
              + [moment(st, "exp_avg_sq", n) for st, n in zip(states, names)])
    out["opt::treedef"] = np.frombuffer(_treedef(names).encode(),
                                        dtype=np.uint8)
    for i, leaf in enumerate(leaves):
        out[f"opt::{i}"] = leaf
    tmp = path + ".tmp"
    np.savez(tmp, **out)
    os.replace(tmp + ".npz", path)


def restore(path: str, params: Dict[str, torch.Tensor],
            optimizer: torch.optim.Adam) -> int:
    """Load a checkpoint into `params` (in place) and `optimizer`'s state;
    returns the stored step count.

    Refuses a file whose parameter names, or whose count of optimizer
    leaves (1 + 2 per parameter for Adam), do not match: restoring another
    optimizer's state would otherwise put its leaves in the wrong slots."""
    names = sorted(params)
    with np.load(path) as data:
        stored = sorted(k[len("param::"):] for k in data.files
                        if k.startswith("param::"))
        n_leaves = sum(1 for k in data.files
                       if k.startswith("opt::") and k != "opt::treedef")
        if stored != names or n_leaves != 1 + 2 * len(names):
            raise ValueError(
                f"checkpoint {path} holds parameters {stored} and "
                f"{n_leaves} optimizer leaves; restoring Adam over {names} "
                f"needs {1 + 2 * len(names)}")
        leaf = lambda i, p: torch.from_numpy(data[f"opt::{i}"]).to(p.device)
        count = float(data["opt::0"])
        with torch.no_grad():
            for k, n in enumerate(names):
                p = params[n]
                p.copy_(torch.from_numpy(data[f"param::{n}"]))
                optimizer.state[p] = {
                    "step": torch.tensor(count, dtype=torch.float32),
                    "exp_avg": leaf(1 + k, p),
                    "exp_avg_sq": leaf(1 + len(names) + k, p)}
        return int(data["step"])
