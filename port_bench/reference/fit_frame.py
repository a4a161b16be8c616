"""The plain reference of the albedo fit at a whole frame's size, computed
in blocks of whole pixels.

The semantics are reference/fit.py's: the image's value is the render with
the kernels' 8-bit albedos, the gradient is the derivative of the render at
the exact albedos, the loss is the mean squared error against a target
rendered the same way from the true albedos, and the update is Adam with
lr, betas (0.9, 0.999) and eps 1e-8, written out. Only the bookkeeping
differs, so that a frame of tens of millions of paths fits on one card:

- each block of `block_pixels` whole pixels is traced once
  (render.trace_rays with record=True), and of its rows only the bounces
  at which a path continued are kept, as (path, row) lists a bounce. A
  path continues at bounce b only if it continued at every bounce before,
  so the list of a bounce lies inside the one before it;
- a render multiplies a path's attenuation by the albedo of each kept row
  in bounce order, as reference/fit.py does (its other factors are the
  extra column's 1, which changes no bit), then by the sky colour, and
  takes the mean over the pixel's samples;
- the gradient of a row's albedo sums the cotangents of every path that
  continued from that row in float64, then rounds to the precision of
  the rest (`Rows`): torch's own backward of an index sums a row's
  duplicates one after another in the table's precision, and the ground
  is hit by over a million paths of a block, whose terms of either sign
  such a running float32 sum gets wrong by up to a percent of the row's
  gradient;
- the loss and its gradient are sums over pixels: each step renders one
  block at a time under autograd, adds its share of the mean to the loss
  and its gradient to the leaf, and frees the block's graph.

At float32 with TF32 off (no matrix product runs here, so that changes
nothing but keeps the precision the configuration states). Returns what
reference/fit.py's fit_reference returns.
"""

from __future__ import annotations

import torch

from port_bench.reference import fit, render

# Pixels a block: 2,097,152 paths a block at 32 spp.
BLOCK_PIXELS = 1 << 16
# Primary rays traced together on a card (render.trace_rays's chunk): a
# larger chunk launches fewer of the trace's small per-bounce operations.
CUDA_CHUNK = 1 << 20


class Rows(torch.autograd.Function):
    """table[row] for a table (S, 3) and row int64[k], whose backward sums
    the cotangents of each row in float64."""

    @staticmethod
    def forward(ctx, table, row):
        ctx.save_for_backward(row)
        ctx.rows = table.shape[0]
        return table[row]

    @staticmethod
    def backward(ctx, ct):
        row, = ctx.saved_tensors
        acc = torch.zeros((ctx.rows, ct.shape[1]), dtype=torch.float64,
                          device=ct.device)
        return acc.index_add_(0, row, ct.double()).to(ct.dtype), None


def trace_block(tab, cam, lo, hi, width, height, spp, seed, max_bounces,
                dtype):
    """Pixels [lo, hi) traced once: (events [(path int64[k], row
    int64[k])] per bounce at which some path continued, sky dtype[n, 3],
    rays int) over the block's n = (hi - lo) * spp paths, in ray-id
    order."""
    dev = tab["cx"].device
    ray_id = torch.arange(lo * spp, hi * spp, dtype=torch.int64, device=dev)
    chunk = CUDA_CHUNK if ray_id.is_cuda else 1 << 17
    _, count, rows, sky = render.trace_rays(
        tab, cam, ray_id, width, height, spp, seed, max_bounces, dtype=dtype,
        record=True, chunk=chunk)
    s_rows = tab["cx"].shape[0]
    events = []
    for b in range(max_bounces + 1):
        path = (rows[b] != s_rows).nonzero()[:, 0]
        if path.numel() == 0:
            break
        events.append((path, rows[b][path]))
    return events, sky, int(count.sum(dtype=torch.int64))


def block_image(albedo, events, sky, spp):
    """The block's image (pixels, 3): each path's attenuation, the albedo
    (3, S) of its kept rows multiplied in bounce order, times its sky
    colour, averaged over each pixel's samples."""
    alb = albedo.t()
    att = torch.ones_like(sky)
    for path, row in events:
        att = att.index_put((path,), att[path] * Rows.apply(alb, row))
    return (att * sky).reshape(-1, spp, 3).mean(dim=1)


def fit_reference(cols, true_albedo, start_albedo, cam_spec, width, height,
                  spp, seed, max_bounces, lr, steps=3, device="cpu",
                  dtype=torch.float32, block_pixels=BLOCK_PIXELS):
    """reference/fit.py's fit_reference over blocks of block_pixels
    pixels: dict with losses [steps floats], grad1 {leaf: tensor[S]},
    params {leaf: tensor[S]} after `steps` steps, start {leaf: tensor[S]},
    rays (the frame's ray count, int)."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        return _fit(cols, true_albedo, start_albedo, cam_spec, width, height,
                    spp, seed, max_bounces, lr, steps, device, dtype,
                    block_pixels)
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b


def _fit(cols, true_albedo, start_albedo, cam_spec, width, height, spp, seed,
         max_bounces, lr, steps, device, dtype, block_pixels):
    tab = render.table(cols, device, dtype)
    cam = render.camera(cam_spec, width / height, device, dtype)
    pixels = width * height
    blocks, rays = [], 0
    for lo in range(0, pixels, block_pixels):
        hi = min(lo + block_pixels, pixels)
        events, sky, n = trace_block(tab, cam, lo, hi, width, height, spp,
                                     seed, max_bounces, dtype)
        blocks.append((events, sky))
        rays += n
    quantized = lambda a: fit._quantized(a).to(dtype)
    true_q = quantized(torch.as_tensor(true_albedo, device=device))
    with torch.no_grad():
        targets = [block_image(true_q, ev, sky, spp) for ev, sky in blocks]
    numel = pixels * 3
    a = torch.as_tensor(start_albedo, device=device).to(dtype)
    start = a.clone()
    m = torch.zeros_like(a)
    v = torch.zeros_like(a)
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        leaf = a.clone().requires_grad_(True)
        value_albedo = quantized(leaf.detach())
        loss = torch.zeros((), dtype=dtype, device=device)
        for (events, sky), target in zip(blocks, targets):
            exact = block_image(leaf, events, sky, spp)
            with torch.no_grad():
                value = block_image(value_albedo, events, sky, spp)
            img = exact + (value - exact).detach()
            part = torch.sum((img - target) ** 2) / numel
            if part.requires_grad:      # some path of the block hit a row
                part.backward()
            loss = loss + part.detach()
        g = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        losses.append(float(loss))
        if grad1 is None:
            grad1 = g.clone()
        with torch.no_grad():
            m = fit.BETAS[0] * m + (1 - fit.BETAS[0]) * g
            v = fit.BETAS[1] * v + (1 - fit.BETAS[1]) * g * g
            bc1 = 1 - fit.BETAS[0] ** t
            bc2 = 1 - fit.BETAS[1] ** t
            denom = torch.sqrt(v) / (bc2 ** 0.5) + fit.EPS
            a = a - (lr / bc1) * (m / denom)
    split = lambda x: {k: x[i].float() for i, k in enumerate(fit.LEAVES)}
    return dict(losses=losses, grad1=split(grad1), params=split(a),
                start=split(start), rays=rays)
