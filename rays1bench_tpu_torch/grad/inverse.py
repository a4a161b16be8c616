"""Inverse rendering: Adam-fit scene parameters to a target image through the
gradient path (rays1bench_tpu/grad/inverse.py).

The hit topology is fixed under differentiation, so gradients flow through
hit distances, normals and material columns, not through which sphere is
hit. With cfg.soft_silhouette > 0 the soft-silhouette renderer also gives
silhouettes a derivative, which is what moves centers and radii; its render
is stochastic, so the loss becomes the cross-seed U-statistic (image_loss).
Two engines, as in the JAX package:
- "mega": the topology kernel forward and the fused backward kernel
  (grad/mega.py); its image carries the kernel's 8-bit albedos.
- "pipeline": the plain fixed-trip renderer (render/pipeline.render_image)
  with the closest-hit index kernel as its sweep (cfg.pallas_intersect,
  which _grad_cfg turns on) and autograd over the O(N) chain, each bounce
  checkpointed when the frame has more than one chunk; exact albedos.
One training step is the forward, the loss, the backward and one
torch.optim.Adam step with optax's defaults (betas 0.9 / 0.999, eps 1e-8).
JAX's `scan_steps` (several steps per dispatch through lax.scan) becomes
the plain loop of fit_scene.

With a device mesh (parallel/mesh.py; every rank runs the same step on
its replica of the parameters), "mega" takes the sharded fused path
(grad/mega.render_image_mega_sharded) and "pipeline" the sharded plain
render (parallel/shard.render_image_sharded); each sums the gradient over
the ranks with one all_reduce, so the replicas stay equal.

fit_camera fits the camera's lookfrom and/or vfov instead of the scene,
through the differentiable render/camera.build_camera.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch

from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.core.device import resolve, to_device
from rays1bench_tpu_torch.grad import checkpoint as ckpt
from rays1bench_tpu_torch.grad.mega import (render_image_mega,
                                            render_image_mega_sharded)
from rays1bench_tpu_torch.kernels.mega_backward import supported
from rays1bench_tpu_torch.parallel.shard import render_image_sharded
from rays1bench_tpu_torch.render.camera import (Camera, CameraSpec,
                                                build_camera)
from rays1bench_tpu_torch.render.pipeline import render_image
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
    """The gradient path's config: the fixed-trip loop (autograd needs every
    bounce, and the replay is fixed-trip by construction), and the
    closest-hit index kernel as the pipeline's sweep unless the caller chose
    (pallas_intersect None -> True)."""
    if cfg.early_exit:
        cfg = cfg.replace(early_exit=False)
    if cfg.pallas_intersect is None:
        cfg = cfg.replace(pallas_intersect=True)
    return cfg


def params_of(spheres: SphereSOA, names: Tuple[str, ...]
              ) -> Dict[str, torch.Tensor]:
    """The parameter dict: a leaf copy of each named column, requiring
    grad."""
    return {n: getattr(spheres, n).detach().clone().requires_grad_(True)
            for n in names}


def with_params(spheres: SphereSOA, params: Dict[str, torch.Tensor]
                ) -> SphereSOA:
    return dataclasses.replace(spheres, **params)


def _pick_engine(spheres: SphereSOA, cfg: RenderConfig, engine: str) -> str:
    """Resolve engine="auto": "mega" where the fused backward takes the
    scene (kernels/mega_backward.supported: up to 2,755 rows and 50
    bounces), else "pipeline", as the JAX package's _pick_engine does with
    fused_supported, with or without a mesh. An explicit "mega" on a scene
    it cannot take raises. Unlike the JAX package, auto stays on "mega" on
    the CPU as well: JAX sends the CPU to the pipeline only so that its
    Pallas interpret mode stays opt-in, and the port's CPU path is plain
    torch either way."""
    if engine not in ("auto", "mega", "pipeline"):
        raise ValueError(f"unknown engine {engine!r}")
    fits = supported(spheres.count, cfg)
    if engine == "mega" and not fits:
        raise ValueError(f"the fused backward does not take {spheres.count} "
                         f"rows at max_bounces={cfg.max_bounces} "
                         f"(kernels/mega_backward.supported); use "
                         f"engine='pipeline'")
    if engine == "auto":
        return "mega" if fits else "pipeline"
    return engine


def render_for_loss(spheres: SphereSOA, camera: Camera, cfg: RenderConfig,
                    mesh=None, engine: str = "auto") -> torch.Tensor:
    """Differentiable linear-radiance render. Through "mega" its value comes
    from the topology kernel, whose albedos are 8-bit
    (megakernel.pack_spheres); through "pipeline" the albedos are exact.
    Render the target through the same engine. With a mesh (its 1-D
    "rays" axis) the render is sharded over its ranks and whole on every
    rank."""
    mega = _pick_engine(spheres, cfg, engine) == "mega"
    if mesh is not None:
        render = render_image_mega_sharded if mega else render_image_sharded
        img, _ = render(spheres, camera, _grad_cfg(cfg), mesh)
    else:
        render = render_image_mega if mega else render_image
        img, _ = render(spheres, camera, _grad_cfg(cfg))
    return img


def image_loss(params: Dict[str, torch.Tensor], spheres: SphereSOA,
               camera: Camera, target: torch.Tensor, cfg: RenderConfig,
               mesh=None, engine: str = "auto") -> torch.Tensor:
    """MSE in linear radiance between a render with `params` applied and the
    target image.

    With cfg.soft_silhouette > 0 the render is a stochastic estimator, and
    E[(img - target)^2] = (E[img] - target)^2 + Var(img): the variance
    term's gradient pushes silhouettes away from high-contrast backgrounds
    whatever the target. The loss is then the U-statistic of two
    independent renders, the second at seed + 101,
    mean((imgA - target) * (imgB - target)), whose expectation is the
    squared bias alone (rays1bench_tpu/grad/inverse.py:138-166)."""
    sph = with_params(spheres, params)
    return _loss_of([render_for_loss(sph, camera, c, mesh, engine)
                     for c in _loss_cfgs(cfg)], target)


def _loss_cfgs(cfg: RenderConfig):
    """The renders the loss takes: cfg, and under soft silhouettes a second
    at seed + 101."""
    if not cfg.soft_silhouette:
        return (cfg,)
    return (cfg, cfg.replace(seed=cfg.seed + 101))


def _loss_of(imgs, target: torch.Tensor) -> torch.Tensor:
    if len(imgs) == 1:
        return torch.mean((imgs[0] - target) ** 2)
    return torch.mean((imgs[0] - target) * (imgs[1] - target))


def _no_mark():
    pass


def make_train_step(spheres_template: SphereSOA, camera: Camera,
                    cfg: RenderConfig, inv: InverseConfig,
                    params: Dict[str, torch.Tensor], mesh=None,
                    engine: str = "auto"):
    """Build (step, optimizer) over the parameter dict, whose tensors the
    step updates in place. step(target, mark) -> the loss before the update
    (a 0-dim tensor); mark() is called before the forward and after the
    forward (two renders under soft silhouettes), the loss, the backward
    and the Adam update (bench.grad records a CUDA event there). Row masks
    zero the gradient of rows outside inv.rows / inv.rows_by before Adam
    sees it, as the JAX step does."""
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
        spheres = with_params(spheres_template, params)
        imgs = [render_for_loss(spheres, camera, c, mesh, engine)
                for c in _loss_cfgs(cfg)]
        mark()
        loss = _loss_of(imgs, target)
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


def fit_camera(spheres: SphereSOA, spec: CameraSpec, target: torch.Tensor,
               cfg: RenderConfig, learning_rate: float = 5e-3,
               steps: int = 100, optimize: Tuple[str, ...] = ("lookfrom",),
               engine: str = "auto", verbose: bool = False, mesh=None,
               device="cuda"):
    """Adam-fit camera parameters, lookfrom and/or vfov, to a target image
    on `device` (rays1bench_tpu/grad/inverse.py:280-326). The scene is
    fixed; `spec` gives the starting guess and the parameters that stay
    (lookat, vup, aperture, focus_dist, aspect). Each step rebuilds the
    camera from the leaves with render/camera.build_camera, renders through
    render_for_loss (with a mesh, its sharded render), takes the plain MSE
    (not the U-statistic, as in the JAX package) and one torch.optim.Adam step
    with optax's defaults. Gradients flow image -> rays -> basis -> leaves:
    on "mega" kernel B's ray cotangents carry them through raygen's
    autograd.

    Deviation from the JAX package: `optimize` defaults to ("lookfrom",),
    not ("lookfrom", "vfov"). Fitted together, the two share a near-null
    dolly-zoom direction (moving lookfrom along the view axis trades
    against vfov at almost the same image), so the joint fit from one view
    is ill-posed; passing both is still accepted.

    Returns ({name: fitted float32 tensor}, list of per-step losses)."""
    unknown = set(optimize) - {"lookfrom", "vfov"}
    if unknown:
        raise ValueError(f"fit_camera fits lookfrom and vfov, not "
                         f"{sorted(unknown)}")
    device = resolve(device)
    spheres = to_device(spheres, device)
    target = target.to(device)
    start = {"lookfrom": spec.lookfrom, "vfov": spec.vfov}
    params = {k: torch.tensor(start[k], dtype=torch.float32, device=device,
                              requires_grad=True) for k in optimize}
    fixed = {k: torch.tensor(v, dtype=torch.float32, device=device)
             for k, v in start.items() if k not in params}
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate,
                                 eps=1e-8)
    losses = []
    for i in range(steps):
        optimizer.zero_grad(set_to_none=True)
        full = dict(fixed, **params)
        camera = build_camera(full["lookfrom"], spec.lookat, spec.vup,
                              full["vfov"], spec.aspect, spec.aperture,
                              spec.focus_dist, device)
        img = render_for_loss(spheres, camera, cfg, mesh, engine)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        optimizer.step()
        losses.append(float(loss.detach()))
        if verbose and (i % 10 == 0 or i == steps - 1):
            print(f"camera step {i:4d}  loss {losses[-1]:.6g}")
    return {k: v.detach() for k, v in params.items()}, losses
