"""The plain reference of the albedo fit: three steps of the fit recipe,
independent of the program.

The scatter of a path does not depend on any albedo (render.py): a path's
rows, and the sky colour that ends it, are fixed by the geometry and the
RNG lattice. So the reference traces every primary ray of the frame once
(render.trace_rays with record=True) and then writes each render as
sky * prod(albedo of the row hit at each bounce that continued), in bounce
order, and the image as the mean over samples.

The recipe's semantics, as the program states them for its "mega" engine:
the image's value is the render with the kernels' 8-bit albedos, the
gradient is the derivative of the render at the exact albedos (the
fixed-topology replay), the loss is the mean squared error against a
target rendered the same way from the true albedos, and the update is Adam
with lr, betas (0.9, 0.999) and eps 1e-8. Adam is written out here.

Returns per step the loss, the first step's gradient and the albedos after
the steps, as {leaf: tensor} over the leaves albedo_x, albedo_y, albedo_z.
"""

from __future__ import annotations

import torch

from port_bench.reference import render

LEAVES = ("albedo_x", "albedo_y", "albedo_z")
BETAS = (0.9, 0.999)
EPS = 1e-8


def _quantized(a):
    return torch.round(torch.clamp(a.float(), 0.0, 1.0) * 255.0) \
        * render.f32(1 / 255)


def fit_reference(cols, true_albedo, start_albedo, cam_spec, width, height,
                  spp, seed, max_bounces, lr, steps=3, device="cpu",
                  dtype=torch.float32):
    """true_albedo, start_albedo: float32 arrays (3, S). Returns dict with
    losses [steps floats], grad1 {leaf: tensor[S]}, params {leaf:
    tensor[S]} after `steps` steps, start {leaf: tensor[S]}, rays (the
    frame's ray count, int)."""
    tab = render.table(cols, device, dtype)
    cam = render.camera(cam_spec, width / height, device, dtype)
    n = width * height * spp
    ray_id = torch.arange(n, dtype=torch.int64, device=device)
    _, count, rows, sky = render.trace_rays(tab, cam, ray_id, width, height,
                                            spp, seed, max_bounces,
                                            dtype=dtype, record=True)
    rays = int(count.sum(dtype=torch.int64))
    one = torch.ones(3, 1, dtype=dtype, device=device)

    def image(albedo):
        ext = torch.cat([albedo, one], dim=1)
        att = torch.ones(3, n, dtype=dtype, device=device)
        for b in range(max_bounces + 1):
            att = att * ext[:, rows[b]]
        rad = att.t() * sky
        return rad.reshape(height, width, spp, 3).mean(dim=2)

    def q(a):
        return _quantized(a).to(dtype)

    target = image(q(torch.as_tensor(true_albedo, device=device)))
    a = torch.as_tensor(start_albedo, device=device).to(dtype)
    start = a.clone()
    m = torch.zeros_like(a)
    v = torch.zeros_like(a)
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        leaf = a.clone().requires_grad_(True)
        exact = image(leaf)
        with torch.no_grad():
            value = image(q(leaf))
        img = exact + (value - exact).detach()
        loss = torch.mean((img - target) ** 2)
        g, = torch.autograd.grad(loss, leaf)
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = g.clone()
        with torch.no_grad():
            m = BETAS[0] * m + (1 - BETAS[0]) * g
            v = BETAS[1] * v + (1 - BETAS[1]) * g * g
            bc1 = 1 - BETAS[0] ** t
            bc2 = 1 - BETAS[1] ** t
            denom = torch.sqrt(v) / (bc2 ** 0.5) + EPS
            a = a - (lr / bc1) * (m / denom)
    split = lambda x: {k: x[i].float() for i, k in enumerate(LEAVES)}
    return dict(losses=losses, grad1=split(grad1), params=split(a),
                start=split(start), rays=rays)
