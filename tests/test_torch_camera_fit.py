"""Parity of the port's differentiable camera (render/camera.build_camera)
and camera fit (grad/inverse.fit_camera) with the JAX package's on the CPU.

Inputs are seeded with numpy and go through both packages; fit_camera's
renders pass `engine` explicitly, since "auto" routes the CPU differently
(the JAX package to "pipeline", the port to "mega"). JAX's Pallas kernels
run in interpret mode, as its own tests run them. Tolerances and why:
- build_camera: origin, u, v, horizontal, vertical and lens_radius within
  2 ulp of the JAX package's (tan is rounded from float64 in the port; XLA's
  is within an ulp of it); lower_left, a sum of four terms that cancel,
  within 2 ulp of its largest term. The gradient of a seeded scalar of the
  basis with respect to lookfrom and vfov within 1e-5 of jax.grad's, over
  its max abs value.
- fit_camera, small scene at 64x32 @ 2 spp @ 3 b, three Adam steps on each
  engine and each leaf: losses within LOSS_TOL relative and leaves within
  PARAM_TOL absolute, the bounds tests/test_torch_pipeline_grad.py holds
  fit_scene to (measured: losses 8.2e-7, leaves 6.0e-8 against a 5e-3
  step).
- fit_camera pinned to JAX's trajectory, same recipe, each engine and
  leaf: PIN_STEPS (20) steps' losses within LOSS_TOL relative and the
  last leaf within PIN_TOL of one Adam step (lr). The two fits part later,
  when a pixel flips in one and not yet in the other: the losses first
  differ by more than 1e-4 at step 40 ("pipeline", lookfrom), 34 ("mega",
  lookfrom) and 36 (vfov, both). Until step 19, measured: losses within
  1.9e-6 relative; at step 19 the lookfrom leaves within 1.9e-5 (0.4% of
  a step) and vfov within 1.3e-4 degrees (0.3%).
- The loss's gradient in the leaf against jax.grad of the JAX fit's
  loss_fn (grad/inverse.py:301-307), at the points of JAX's trajectory:
  at the moved start within START_TOL (2e-4) relative to its max abs
  value (measured 5.1e-5 to 7.1e-5; one ulp of the leaf moves JAX's own
  gradient by 5.3e-5 to 6.6e-5), and after each of the next five steps
  within STEP_TOL (5e-3; measured 2.6e-5 to 3.0e-3). The largest gap,
  vfov after three steps, is one pixel of the 2,048 (99.7% of it, with
  the hit topology shared): its primary ray grazes sphere 3 (discriminant
  8.2e-6 of b^2, which float32 keeps to two digits), and every other row
  of the image agrees within 5e-10 of a 3e-5 gradient. There JAX's own
  gradient, eager against jitted, differs by 4.8e-3. A gradient off by a
  factor, which Adam's steps would not show, fails the check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rays1bench_tpu.core.config import RenderConfig as JConfig
from rays1bench_tpu.grad import inverse as jinverse
from rays1bench_tpu.render.camera import build_camera as jbuild_camera
from rays1bench_tpu.scene import builders as jbuilders
from rays1bench_tpu_torch.bench import camfit
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad import inverse
from rays1bench_tpu_torch.render.camera import build_camera
from rays1bench_tpu_torch.scene import builders as tbuilders

torch.set_num_threads(1)

ULP_TOL = 2
GRAD_TOL = 1e-5
LOSS_TOL = 1e-5
PARAM_TOL = 1e-5
PIN_STEPS = 20
PIN_TOL = 0.02
START_TOL = 2e-4
STEP_TOL = 5e-3
GRAD_POINTS = 6
FIELDS = ("origin", "lower_left", "horizontal", "vertical", "u", "v",
          "lens_radius")
RECIPE = dict(width=64, height=32, spp=2, max_bounces=3, seed=3,
              early_exit=False, ray_chunk=4096)


def jax_moved(jspec, moved, leaf):
    """The JAX CameraSpec with the port's moved leaf."""
    return dataclasses.replace(jspec, **{leaf: getattr(moved, leaf)})


def ordered(a):
    """float32 bits as integers ordered like the floats (-0 and +0 both 0),
    so that a difference counts ulps."""
    i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def ulps(a, b):
    return int(np.abs(ordered(a) - ordered(b)).max())


def cameras(n, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.uniform(-10, 10, 3).astype(np.float32),
               rng.uniform(-3, 3, 3).astype(np.float32), (0.0, 1.0, 0.0),
               float(rng.uniform(20, 90)), float(rng.uniform(1, 2.5)),
               float(rng.uniform(0, 0.2)), float(rng.uniform(0.5, 12)))


def test_build_camera_matches_jax_within_two_ulp():
    for args in cameras(100):
        want, got = jbuild_camera(*args), build_camera(*args)
        for f in FIELDS:
            g = getattr(got, f)
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            if f != "lower_left":
                assert ulps(g.numpy(), getattr(want, f)) <= ULP_TOL, f
        lookfrom, _, _, _, _, _, fd = args
        largest = max(np.abs(lookfrom).max(), fd,
                      np.abs(np.asarray(want.horizontal)).max() / 2,
                      np.abs(np.asarray(want.vertical)).max() / 2)
        gap = np.abs(got.lower_left.numpy() - np.asarray(want.lower_left))
        assert gap.max() <= ULP_TOL * np.spacing(np.float32(largest))


def test_build_camera_gradient_matches_jax():
    rng = np.random.default_rng(1)
    for args in cameras(20, seed=2):
        lookfrom, lookat, vup, vfov, aspect, aperture, fd = args
        weights = {f: rng.normal(size=3).astype(np.float32)
                   for f in FIELDS[:-1]}

        def jscalar(lf, vf):
            cam = jbuild_camera(lf, lookat, vup, vf, aspect, aperture, fd)
            return sum(jnp.sum(getattr(cam, f) * w)
                       for f, w in weights.items())

        jg = jax.grad(jscalar, argnums=(0, 1))(jnp.asarray(lookfrom),
                                               jnp.float32(vfov))
        lf = torch.tensor(lookfrom, requires_grad=True)
        vf = torch.tensor(vfov, dtype=torch.float32, requires_grad=True)
        cam = build_camera(lf, lookat, vup, vf, aspect, aperture, fd)
        sum(torch.sum(getattr(cam, f) * torch.from_numpy(w))
            for f, w in weights.items()).backward()
        for g, w in ((lf.grad, jg[0]), (vf.grad, jg[1])):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= \
                GRAD_TOL * np.abs(w).max()


@pytest.mark.parametrize("engine", ["pipeline", "mega"])
@pytest.mark.parametrize("leaf", ["lookfrom", "vfov"])
def test_fit_camera_three_steps_match_jax(engine, leaf):
    lr, move = camfit.CASES[leaf][:2]
    jcfg, cfg = JConfig(**RECIPE), RenderConfig(**RECIPE)
    jscene = jbuilders.create_small_scene(jcfg.aspect, pad_multiple=8)
    scene = tbuilders.create_small_scene(cfg.aspect, pad_multiple=8,
                                         device="cpu")
    spec = scene.camera
    moved = camfit.moved(spec, leaf, move)
    jtarget = jinverse.render_for_loss(jscene.spheres, jscene.camera.build(),
                                       jcfg, engine=engine)
    jfitted, jlosses = jinverse.fit_camera(
        jscene.spheres, jax_moved(jscene.camera, moved, leaf), jtarget,
        jcfg, learning_rate=lr, steps=3, optimize=(leaf,), engine=engine)
    with torch.no_grad():
        target = inverse.render_for_loss(scene.spheres, spec.build("cpu"),
                                         cfg, engine=engine)
    fitted, losses = inverse.fit_camera(
        scene.spheres, moved, target, cfg,
        learning_rate=lr, steps=3, optimize=(leaf,), engine=engine,
        device="cpu")
    assert list(fitted) == [leaf] and len(losses) == 3
    assert np.allclose(losses, jlosses, rtol=LOSS_TOL, atol=0)
    assert np.abs(fitted[leaf].numpy() - np.asarray(jfitted[leaf])).max() \
        <= PARAM_TOL
    assert losses[-1] < losses[0]


def test_fit_camera_defaults_and_checks():
    """The default fits lookfrom alone (the joint fit with vfov is the
    ill-posed dolly zoom); both are still accepted; anything else raises;
    the default device is the card."""
    cfg = RenderConfig(width=8, height=4, spp=1, max_bounces=2)
    scene = tbuilders.create_small_scene(cfg.aspect, pad_multiple=8,
                                         device="cpu")
    target = torch.zeros((cfg.height, cfg.width, 3))
    fitted, losses = inverse.fit_camera(scene.spheres, scene.camera, target,
                                        cfg, steps=1, device="cpu")
    assert list(fitted) == ["lookfrom"] and len(losses) == 1
    fitted, _ = inverse.fit_camera(scene.spheres, scene.camera, target, cfg,
                                   steps=1, optimize=("lookfrom", "vfov"),
                                   device="cpu")
    assert sorted(fitted) == ["lookfrom", "vfov"]
    with pytest.raises(ValueError, match="aperture"):
        inverse.fit_camera(scene.spheres, scene.camera, target, cfg,
                           steps=1, optimize=("aperture",), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            inverse.fit_camera(scene.spheres, scene.camera, target, cfg,
                               steps=1)


def recipe_pair(engine):
    """The recipe's frame in both packages: (JAX config, scene, target;
    the port's config, scene, target), each target the true camera's
    render through `engine`."""
    jcfg, cfg = JConfig(**RECIPE), RenderConfig(**RECIPE)
    jscene = jbuilders.create_small_scene(jcfg.aspect, pad_multiple=8)
    scene = tbuilders.create_small_scene(cfg.aspect, pad_multiple=8,
                                         device="cpu")
    jtarget = jinverse.render_for_loss(jscene.spheres, jscene.camera.build(),
                                       jcfg, engine=engine)
    with torch.no_grad():
        target = inverse.render_for_loss(scene.spheres,
                                         scene.camera.build("cpu"), cfg,
                                         engine=engine)
    return jcfg, jscene, jtarget, cfg, scene, target


@pytest.mark.parametrize("engine", ["pipeline", "mega"])
@pytest.mark.parametrize("leaf", ["lookfrom", "vfov"])
def test_fit_camera_follows_jax_until_the_fits_part(engine, leaf):
    lr, move = camfit.CASES[leaf][:2]
    jcfg, jscene, jtarget, cfg, scene, target = recipe_pair(engine)
    moved = camfit.moved(scene.camera, leaf, move)
    jfitted, jlosses = jinverse.fit_camera(
        jscene.spheres, jax_moved(jscene.camera, moved, leaf), jtarget,
        jcfg, learning_rate=lr, steps=PIN_STEPS, optimize=(leaf,),
        engine=engine)
    fitted, losses = inverse.fit_camera(
        scene.spheres, moved, target, cfg, learning_rate=lr,
        steps=PIN_STEPS, optimize=(leaf,), engine=engine, device="cpu")
    assert np.allclose(losses, jlosses, rtol=LOSS_TOL, atol=0)
    gap = np.abs(fitted[leaf].numpy() - np.asarray(jfitted[leaf])).max()
    assert gap <= PIN_TOL * lr, gap
    assert min(losses) < 0.5 * losses[0]


@pytest.mark.parametrize("engine", ["pipeline", "mega"])
@pytest.mark.parametrize("leaf", ["lookfrom", "vfov"])
def test_camera_gradient_matches_jax_grad(engine, leaf):
    import optax

    lr, move = camfit.CASES[leaf][:2]
    jcfg, jscene, jtarget, cfg, scene, target = recipe_pair(engine)
    spec = jax_moved(jscene.camera, camfit.moved(scene.camera, leaf, move),
                     leaf)
    fixed = {"lookfrom": jnp.asarray(spec.lookfrom, jnp.float32),
             "vfov": jnp.asarray(spec.vfov, jnp.float32)}

    def loss_fn(p):  # the JAX fit's (rays1bench_tpu/grad/inverse.py:301)
        full = dict(fixed, **p)
        cam = jbuild_camera(full["lookfrom"], spec.lookat, spec.vup,
                            full["vfov"], spec.aspect, spec.aperture,
                            spec.focus_dist)
        img = jinverse.render_for_loss(jscene.spheres, cam, jcfg, None,
                                       engine)
        return jnp.mean((img - jtarget) ** 2)

    optimizer = optax.adam(lr)

    @jax.jit
    def step(params, opt_state):
        grads = jax.grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, grads

    params = {leaf: fixed[leaf]}
    opt_state = optimizer.init(params)
    for k in range(GRAD_POINTS):
        at = np.asarray(params[leaf])
        params, opt_state, jgrads = step(params, opt_state)
        want = np.asarray(jgrads[leaf])
        got = torch.tensor(at, requires_grad=True)
        full = {"lookfrom": torch.tensor(spec.lookfrom), "vfov":
                torch.tensor(spec.vfov, dtype=torch.float32), leaf: got}
        cam = build_camera(full["lookfrom"], spec.lookat, spec.vup,
                           full["vfov"], spec.aspect, spec.aperture,
                           spec.focus_dist)
        img = inverse.render_for_loss(scene.spheres, cam, cfg, None, engine)
        torch.mean((img - target) ** 2).backward()
        gap = np.abs(got.grad.numpy() - want).max() / np.abs(want).max()
        assert gap <= (START_TOL if k == 0 else STEP_TOL), (k, gap)


# Run as a script, `PYTHONPATH=. python tests/test_torch_camera_fit.py MODE`,
# this file prints the readings the tolerances above and PERF.md §6 (PR 9)
# quote, on the CPU:
#   --side ENGINE LEAF STEPS   both fits step by step: the loss's relative
#                              gap, the leaves' gap and the gradients' gap,
#                              and the first step where the losses part;
#   --at ENGINE LEAF POINTS    along JAX's trajectory, the port's gradient at
#                              JAX's leaf against jax.grad, beside JAX's own
#                              gradient moved by one ulp of each coordinate;
#   --split LEAF STEP [--size W H SPP B]
#                              "pipeline" at JAX's point STEP: the gap with
#                              each package's own sweep and with the hit
#                              topology shared, the image row and pixel that
#                              carry it, and that pixel's rays;
#   --cd W H                   at W x H @ 4 @ 10, the moved lookfrom: both
#                              packages' hard gradient and JAX's central
#                              differences of the loss (eps 1e-3).


def _jax_points(engine, leaf, jcfg, jscene, jtarget, spec, steps):
    """JAX's fit (the fit's loss_fn and optax.adam) for `steps` steps:
    [(leaf value before the step, loss, gradient)], and the jitted
    value_and_grad of the loss."""
    import optax

    lr = camfit.CASES[leaf][0]
    fixed = {"lookfrom": jnp.asarray(spec.lookfrom, jnp.float32),
             "vfov": jnp.asarray(spec.vfov, jnp.float32)}

    def loss_fn(p):
        full = dict(fixed, **{leaf: p})
        cam = jbuild_camera(full["lookfrom"], spec.lookat, spec.vup,
                            full["vfov"], spec.aspect, spec.aperture,
                            spec.focus_dist)
        img = jinverse.render_for_loss(jscene.spheres, cam, jcfg, None,
                                       engine)
        return jnp.mean((img - jtarget) ** 2)

    optimizer = optax.adam(lr)

    @jax.jit
    def step(p, opt_state):
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = optimizer.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss, g

    p, out = fixed[leaf], []
    opt_state = optimizer.init(p)
    for _ in range(steps):
        at = np.asarray(p)
        p, opt_state, loss, g = step(p, opt_state)
        out.append((at, float(loss), np.asarray(g)))
    return out, jax.jit(jax.value_and_grad(loss_fn))


def _port_grad(scene, spec, target, cfg, engine, leaf, at, topology=None,
               mask=None):
    """The port's (loss, gradient in `leaf`) at the value `at`; with a
    topology, the replay at it (render_image(topology=...)); with a mask,
    of the loss summed over the mask's pixels over the image's size."""
    from rays1bench_tpu_torch.render.pipeline import render_image

    got = torch.tensor(at, requires_grad=True)
    full = {"lookfrom": torch.tensor(spec.lookfrom),
            "vfov": torch.tensor(spec.vfov, dtype=torch.float32), leaf: got}
    cam = build_camera(full["lookfrom"], spec.lookat, spec.vup, full["vfov"],
                       spec.aspect, spec.aperture, spec.focus_dist)
    if topology is None:
        img = inverse.render_for_loss(scene.spheres, cam, cfg, None, engine)
    else:
        img, _ = render_image(scene.spheres, cam,
                              cfg.replace(pallas_intersect=False),
                              topology=torch.from_numpy(topology))
    sq = (img - target) ** 2
    loss = sq.mean() if mask is None else \
        (torch.from_numpy(mask)[:, :, None] * sq).sum() / sq.numel()
    loss.backward()
    return float(loss.detach()), got.grad.numpy().copy()


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _side(engine, leaf, steps):
    jcfg, jscene, jtarget, cfg, scene, target = recipe_pair(engine)
    lr, move = camfit.CASES[leaf][:2]
    spec = jax_moved(jscene.camera, camfit.moved(scene.camera, leaf, move),
                     leaf)
    points, _ = _jax_points(engine, leaf, jcfg, jscene, jtarget, spec, steps)
    p = torch.tensor(points[0][0], requires_grad=True)
    opt = torch.optim.Adam([p], lr=lr, eps=1e-8)
    parted = None
    for i, (at, jloss, jg) in enumerate(points):
        loss, g = _port_grad(scene, spec, target, cfg, engine, leaf,
                             p.detach().numpy())
        gap = abs(loss - jloss) / jloss
        if parted is None and gap > 1e-4:
            parted = i
        print(f"{engine} {leaf} step {i}: loss gap {gap:.2e}, leaf gap "
              f"{np.abs(p.detach().numpy() - at).max():.2e}, gradient gap "
              f"{_rel(g, jg):.2e}", flush=True)
        p.grad = torch.from_numpy(np.asarray(g, np.float32))
        opt.step()
    print(f"{engine} {leaf}: the losses part (gap above 1e-4) at step "
          f"{parted}", flush=True)


def _at(engine, leaf, n):
    jcfg, jscene, jtarget, cfg, scene, target = recipe_pair(engine)
    spec = jax_moved(jscene.camera, camfit.moved(scene.camera, leaf,
                                                 camfit.CASES[leaf][1]), leaf)
    points, vg = _jax_points(engine, leaf, jcfg, jscene, jtarget, spec, n)
    for i, (at, _, jg) in enumerate(points):
        _, g = _port_grad(scene, spec, target, cfg, engine, leaf, at)
        spread = 0.0
        for k in range(at.size):
            for d in (np.inf, -np.inf):
                q = np.atleast_1d(at).copy()
                q[k] = np.nextafter(q[k], np.float32(d))
                q = q.reshape(np.shape(at))
                spread = max(spread, _rel(np.asarray(vg(jnp.asarray(q))[1]),
                                          jg))
        print(f"{engine} {leaf} point {i}: the port's gradient against "
              f"jax.grad {_rel(g, jg):.2e}; JAX's own one ulp away "
              f"{spread:.2e}", flush=True)


def _split(leaf, step, size):
    from rays1bench_tpu.render.pipeline import render_image as jrender
    from rays1bench_tpu_torch.kernels.pipeline import render_image_topology

    w, h, spp, mb = size
    kw = dict(RECIPE, width=w, height=h, spp=spp, max_bounces=mb)
    if (w, h) != (64, 32):
        del kw["ray_chunk"]  # the recipe's 4,096; larger frames the default
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    jscene = jbuilders.create_small_scene(jcfg.aspect, pad_multiple=8)
    scene = tbuilders.create_small_scene(cfg.aspect, pad_multiple=8,
                                         device="cpu")
    jtarget = jinverse.render_for_loss(jscene.spheres, jscene.camera.build(),
                                       jcfg, engine="pipeline")
    target = torch.from_numpy(np.array(jtarget))
    spec = jax_moved(jscene.camera, camfit.moved(
        scene.camera, leaf, camfit.CASES[leaf][1]), leaf)
    points, _ = _jax_points("pipeline", leaf, jcfg, jscene, jtarget, spec,
                            step + 1)
    at, _, jg = points[step]
    full = {"lookfrom": torch.tensor(spec.lookfrom),
            "vfov": torch.tensor(spec.vfov, dtype=torch.float32),
            leaf: torch.tensor(at)}
    cam = build_camera(full["lookfrom"], spec.lookat, spec.vup, full["vfov"],
                       spec.aspect, spec.aperture, spec.focus_dist)
    with torch.no_grad():
        _, _, topo = render_image_topology(scene.spheres, cam, cfg)
    topo = topo.numpy()
    rcfg = jcfg.replace(pallas_intersect=False)

    def loss(p, mask):
        fullj = {"lookfrom": jnp.asarray(spec.lookfrom, jnp.float32),
                 "vfov": jnp.float32(spec.vfov), leaf: p}
        c = jbuild_camera(fullj["lookfrom"], spec.lookat, spec.vup,
                          fullj["vfov"], spec.aspect, spec.aperture,
                          spec.focus_dist)
        img, _ = jrender(jscene.spheres, c, rcfg, topology=jnp.asarray(topo))
        return jnp.sum(mask[:, :, None] * (img - jtarget) ** 2) / img.size

    jitted = jax.jit(jax.grad(loss))
    jgrad = lambda mask: np.asarray(jitted(jnp.asarray(at), mask))
    ones = np.ones((h, w), np.float32)
    _, own = _port_grad(scene, spec, target, cfg, "pipeline", leaf, at)
    shared_j = jgrad(ones)
    eager = np.asarray(jax.grad(loss)(jnp.asarray(at), ones))
    _, shared = _port_grad(scene, spec, target, cfg, "pipeline", leaf, at,
                           topo, ones)
    print(f"{w}x{h} @ {spp} @ {mb}, {leaf}, JAX's point {step}: own sweeps "
          f"{_rel(own, jg):.3g}; JAX with the port's topology against its "
          f"own sweep {_rel(shared_j, jg):.3g}, eager against jitted "
          f"{_rel(eager, shared_j):.3g}; shared topology "
          f"{_rel(shared, shared_j):.3g} (port {shared.tolist()}, JAX "
          f"{shared_j.tolist()})", flush=True)
    row = lambda r: (np.arange(h)[:, None] == r) * ones
    rows = [np.abs(jgrad(row(r)) - _port_grad(
        scene, spec, target, cfg, "pipeline", leaf, at, topo, row(r))[1]).max()
        for r in range(h)]
    r = int(np.argmax(rows))
    total = np.abs(shared - shared_j).max()
    print(f"row {r} carries {rows[r] / total:.4f} of the gap; the next "
          f"rows' gaps {sorted(rows)[-4:-1]}", flush=True)
    pix = lambda x: row(r) * (np.arange(w)[None] == x)
    cols = [np.abs(jgrad(pix(x)) - _port_grad(
        scene, spec, target, cfg, "pipeline", leaf, at, topo, pix(x))[1]).max()
        for x in range(w)]
    x = int(np.argmax(cols))
    print(f"pixel ({r}, {x}) carries {cols[x] / total:.4f}; the next "
          f"pixel's {sorted(cols)[-2] / total:.2e}", flush=True)
    from rays1bench_tpu_torch.kernels.pipeline import frame_ray_ids
    from rays1bench_tpu_torch.render.pipeline import (
        primary_rays_from_ids)
    ray_id = frame_ray_ids(cfg, "cpu")
    rays = primary_rays_from_ids(cam, cfg, ray_id)
    s = scene.spheres
    for rid in range((r * w + x) * spp, (r * w + x + 1) * spp):
        first = int(topo[0, rid])
        line = f"ray {rid}: topology {topo[:, rid].tolist()}"
        if first >= 0:
            o = np.array([float(rays[i][rid]) for i in range(3)])
            d = np.array([float(rays[i][rid]) for i in range(3, 6)])
            oc = o - np.array([float(s.center_x[first]),
                               float(s.center_y[first]),
                               float(s.center_z[first])])
            b = oc @ d
            disc = b * b - (oc @ oc - float(s.radius[first]) ** 2)
            line += (f"; its primary hit on row {first}: discriminant "
                     f"{disc:.4g}, {disc / b / b:.3g} of b^2")
        print(line, flush=True)


def _cd(w, h):
    kw = dict(width=w, height=h, spp=4, max_bounces=10, seed=3,
              early_exit=False)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    jscene = jbuilders.create_small_scene(jcfg.aspect, pad_multiple=8)
    scene = tbuilders.create_small_scene(cfg.aspect, pad_multiple=8,
                                         device="cpu")
    jtarget = jinverse.render_for_loss(jscene.spheres, jscene.camera.build(),
                                       jcfg, engine="pipeline")
    with torch.no_grad():
        target = inverse.render_for_loss(scene.spheres,
                                         scene.camera.build("cpu"), cfg,
                                         engine="pipeline")
    moved = camfit.moved(scene.camera, "lookfrom",
                         camfit.CASES["lookfrom"][1])
    spec = jax_moved(jscene.camera, moved, "lookfrom")
    _, vg = _jax_points("pipeline", "lookfrom", jcfg, jscene, jtarget, spec,
                        0)
    at = np.asarray(spec.lookfrom, np.float32)
    loss, jg = vg(jnp.asarray(at))
    cd = []
    for k in range(3):
        e = np.zeros(3, np.float32)
        e[k] = 1e-3
        cd.append((float(vg(jnp.asarray(at + e))[0])
                   - float(vg(jnp.asarray(at - e))[0])) / 2e-3)
    _, g = _port_grad(scene, moved, target, cfg, "pipeline", "lookfrom", at)
    print(f"{w}x{h} @ 4 @ 10, moved lookfrom: loss {float(loss):.6g}; "
          f"JAX's gradient {np.asarray(jg).tolist()}, the port's "
          f"{g.tolist()}; JAX's central differences {cd}", flush=True)


if __name__ == "__main__":
    import argparse

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--side", nargs=3, metavar=("ENGINE", "LEAF", "STEPS"))
    mode.add_argument("--at", nargs=3, metavar=("ENGINE", "LEAF", "POINTS"))
    mode.add_argument("--split", nargs=2, metavar=("LEAF", "STEP"))
    mode.add_argument("--cd", nargs=2, type=int, metavar=("W", "H"))
    ap.add_argument("--size", nargs=4, type=int, default=(64, 32, 2, 3),
                    metavar=("W", "H", "SPP", "B"))
    args = ap.parse_args()
    if args.side:
        _side(args.side[0], args.side[1], int(args.side[2]))
    elif args.at:
        _at(args.at[0], args.at[1], int(args.at[2]))
    elif args.split:
        _split(args.split[0], int(args.split[1]), args.size)
    else:
        _cd(*args.cd)
