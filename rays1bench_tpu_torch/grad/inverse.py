"""Inverse rendering: Adam-fit scene parameters to a target image through the
gradient path (rays1bench_tpu/grad/inverse.py, hard silhouettes).

The hit topology is fixed under differentiation (the megakernel forward
records it, grad/mega.py), so gradients flow through hit distances, normals
and material columns, not through which sphere is hit. One training step is
the topology kernel, the fused backward kernel, autograd's chain onto the
scene leaves, and one torch.optim.Adam step with optax's defaults (betas
0.9 / 0.999, eps 1e-8). JAX's `scan_steps` (several steps per dispatch
through lax.scan) becomes the plain loop of fit_scene.

Not ported yet, each raising NotImplementedError with its ROADMAP item:
engine="pipeline" (the XLA fixed-trip renderer with the Pallas index
intersector), a device mesh (the sharded fused gradient), and fit_camera
(the differentiable camera constructor). Soft silhouettes are refused by
RenderConfig itself.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.core.device import resolve, to_device
from rays1bench_tpu_torch.grad import checkpoint as ckpt
from rays1bench_tpu_torch.grad.mega import render_image_mega
from rays1bench_tpu_torch.kernels.mega_backward import supported
from rays1bench_tpu_torch.render.camera import Camera
from rays1bench_tpu_torch.scene.soa_spheres import SphereSOA


@dataclasses.dataclass(frozen=True)
class InverseConfig:
    """Optimization hyperparameters for fit_scene."""
    learning_rate: float = 2e-2
    steps: int = 200
    # Which SphereSOA float columns are optimized; the rest stay fixed.
    optimize: Tuple[str, ...] = ("center_x", "center_y", "center_z",
                                 "radius", "albedo_x", "albedo_y", "albedo_z")
    # Optional sphere-row mask: only these rows of the optimized columns
    # receive updates (None = all rows).
    rows: Optional[Tuple[int, ...]] = None
    # Per-column overrides of `rows`; columns absent here fall back to it.
    rows_by: Optional[Tuple[Tuple[str, Tuple[int, ...]], ...]] = None


def _grad_cfg(cfg: RenderConfig) -> RenderConfig:
    """The gradient path's config: the fixed-trip loop (the replay is
    fixed-trip by construction)."""
    return cfg.replace(early_exit=False) if cfg.early_exit else cfg


def params_of(spheres: SphereSOA, names: Tuple[str, ...]
              ) -> Dict[str, torch.Tensor]:
    """The parameter dict: a leaf copy of each named column, requiring
    grad."""
    return {n: getattr(spheres, n).detach().clone().requires_grad_(True)
            for n in names}


def with_params(spheres: SphereSOA, params: Dict[str, torch.Tensor]
                ) -> SphereSOA:
    return dataclasses.replace(spheres, **params)


def _pick_engine(spheres: SphereSOA, cfg: RenderConfig, mesh,
                 engine: str) -> str:
    """Resolve engine="auto": "mega" (the topology kernel forward and the
    fused kernel backward) on every device; on the CPU it runs the plain
    versions."""
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh (the sharded fused gradient) is not ported: "
            "ROADMAP.md, queue 1, items 3 and 7")
    if engine == "pipeline":
        raise NotImplementedError(
            "engine='pipeline' (the fixed-trip renderer with the Pallas "
            "index intersector) is not ported: ROADMAP.md, queue 1, items 3 "
            "and 6, and queue 2, item 4")
    if engine not in ("auto", "mega"):
        raise ValueError(f"unknown engine {engine!r}")
    if not supported(spheres.count, cfg):
        raise ValueError(f"the fused backward does not take {spheres.count} "
                         f"rows at max_bounces={cfg.max_bounces} "
                         f"(kernels/mega_backward.supported)")
    return "mega"


def render_for_loss(spheres: SphereSOA, camera: Camera, cfg: RenderConfig,
                    mesh=None, engine: str = "auto") -> torch.Tensor:
    """Differentiable linear-radiance render. Its value comes from the
    topology kernel, whose albedos are 8-bit (megakernel.pack_spheres):
    render the target through the same engine."""
    _pick_engine(spheres, cfg, mesh, engine)
    img, _ = render_image_mega(spheres, camera, _grad_cfg(cfg))
    return img


def image_loss(params: Dict[str, torch.Tensor], spheres: SphereSOA,
               camera: Camera, target: torch.Tensor, cfg: RenderConfig,
               mesh=None, engine: str = "auto") -> torch.Tensor:
    """MSE in linear radiance between a render with `params` applied and the
    target image."""
    return _mse(render_for_loss(with_params(spheres, params), camera, cfg,
                                mesh, engine), target)


def _mse(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((img - target) ** 2)


def _no_mark():
    pass


def make_train_step(spheres_template: SphereSOA, camera: Camera,
                    cfg: RenderConfig, inv: InverseConfig,
                    params: Dict[str, torch.Tensor], mesh=None,
                    engine: str = "auto"):
    """Build (step, optimizer) over the parameter dict, whose tensors the
    step updates in place. step(target, mark) -> the loss before the update
    (a 0-dim tensor); mark() is called before the forward and after the
    forward, the loss, the backward and the Adam update (bench.grad
    records a CUDA event there). Row masks zero the gradient of rows outside
    inv.rows / inv.rows_by before Adam sees it, as the JAX step does."""
    optimizer = torch.optim.Adam(list(params.values()),
                                 lr=inv.learning_rate, eps=1e-8)
    n_rows = spheres_template.count
    device = spheres_template.center_x.device

    def to_mask(rows):
        m = torch.zeros(n_rows, dtype=torch.float32, device=device)
        m[list(rows)] = 1.0
        return m

    by = dict(inv.rows_by or ())
    masks = {}
    for name in inv.optimize:
        rows = by.get(name, inv.rows)
        if rows is not None:
            masks[name] = to_mask(rows)

    def step(target, mark=_no_mark):
        optimizer.zero_grad(set_to_none=True)
        mark()
        img = render_for_loss(with_params(spheres_template, params), camera,
                              cfg, mesh, engine)
        mark()
        loss = _mse(img, target)
        mark()
        loss.backward()
        for name, m in masks.items():
            params[name].grad.mul_(m)
        mark()
        optimizer.step()
        mark()
        return loss.detach()

    return step, optimizer


def fit_scene(spheres0: SphereSOA, camera: Camera, target: torch.Tensor,
              cfg: RenderConfig, inv: Optional[InverseConfig] = None,
              mesh=None, verbose: bool = False,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 50, engine: str = "auto",
              device="cuda"):
    """Adam-fit scene parameters to a target image on `device` (the scene,
    camera and target are moved there; with no card the default raises).

    With checkpoint_path set, the parameters, Adam's state and the step
    count are saved every `checkpoint_every` steps and at the end, in the
    JAX package's .npz layout (grad/checkpoint.py), and the fit resumes from
    an existing checkpoint, one the JAX package wrote included. Returns
    (fitted SphereSOA, list of per-step losses)."""
    device = resolve(device)
    spheres0 = to_device(spheres0, device)
    camera = to_device(camera, device)
    target = target.to(device)
    inv = inv or InverseConfig()
    params = params_of(spheres0, inv.optimize)
    step, optimizer = make_train_step(spheres0, camera, cfg, inv, params,
                                      mesh, engine)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        start = ckpt.restore(checkpoint_path, params, optimizer)
        if verbose:
            print(f"resumed from {checkpoint_path} at step {start}")
    losses = []
    for i in range(start, inv.steps):
        losses.append(float(step(target)))
        if verbose and (i % 10 == 0 or i == inv.steps - 1):
            print(f"step {i:4d}  loss {losses[-1]:.6g}")
        if checkpoint_path and ((i + 1) % checkpoint_every == 0
                                or i + 1 == inv.steps):
            ckpt.save(checkpoint_path, params, optimizer, i + 1)
    fitted = {k: v.detach() for k, v in params.items()}
    return with_params(spheres0, fitted), losses


def fit_camera(*args, **kwargs):
    """Adam-fit camera parameters: not ported yet."""
    raise NotImplementedError(
        "fit_camera (and the differentiable render/camera.build_camera) is "
        "not ported: ROADMAP.md, queue 1, item 3")
