"""Faults planted under the timed path, to show that the check catches them:
each is a context manager that breaks one thing in the program for as long
as it is open. The CPU tests run every cell through each fault it can have;
calibrate.py reads the fit's faults on the card at the cell's own size,
where a training cell's limits are held against them.

Renders: "half" renders each pixel with half of its samples and takes the
mean over those; "pixel" alters one pixel of the image where it is made;
"count" counts 1% more rays than the frame traced. The fit: "unchanged" is a step that
leaves the parameters as they were; "half" takes the loss over half of the
image; "loss" alters the loss where it is produced. Four cards: "exchange"
keeps only the rank's own band of the gathered image.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def render_fault(fault: str):
    from rays1bench_tpu_torch.kernels import pipeline
    real = pipeline.render_image_megakernel

    def broken(soa, camera, cfg, n_real=None, respawn=True, wavefront=None):
        if fault == "half":
            return real(soa, camera, cfg.replace(spp=cfg.spp // 2), n_real,
                        respawn, wavefront)
        img, total = real(soa, camera, cfg, n_real, respawn, wavefront)
        if fault == "pixel":
            img = img.clone()
            img[3, 5, 1] += 0.25
        elif fault == "count":
            total = total + total // 100
        return img, total

    with mock.patch.object(pipeline, "render_image_megakernel", broken):
        yield


@contextlib.contextmanager
def fit_fault(fault: str):
    from rays1bench_tpu_torch.grad import inverse
    if fault == "unchanged":
        real_step = torch.optim.Adam.step

        def step(self, *a, **k):
            params = [p for g in self.param_groups for p in g["params"]]
            before = [p.detach().clone() for p in params]
            out = real_step(self, *a, **k)
            with torch.no_grad():
                for p, b in zip(params, before):
                    p.copy_(b)
            return out

        patch = mock.patch.object(torch.optim.Adam, "step", step)
    elif fault == "half":
        patch = mock.patch.object(
            inverse, "_loss_of", lambda imgs, target: torch.mean(
                (imgs[0] - target)[: target.shape[0] // 2] ** 2))
    elif fault == "loss":
        real_loss = inverse._loss_of
        patch = mock.patch.object(
            inverse, "_loss_of",
            lambda imgs, target: real_loss(imgs, target) * 1.01)
    else:
        raise ValueError(f"no fit fault {fault!r}")
    with patch:
        yield


@contextlib.contextmanager
def exchange_fault():
    from rays1bench_tpu_torch.parallel import shard
    real = shard.all_gather

    def own_part_only(local, mesh):
        parts = real(local, mesh).clone()
        keep = torch.zeros(parts.shape[0], dtype=torch.bool)
        keep[torch.distributed.get_rank()] = True
        parts[~keep] = 0
        return parts

    with mock.patch.object(shard, "all_gather", own_part_only):
        yield


RENDER = ("half", "pixel", "count")
FIT = ("unchanged", "half", "loss")
FAULTS = {"render": (render_fault, RENDER), "fit": (fit_fault, FIT),
          "sharded": (lambda fault: exchange_fault(), ("exchange",))}
