"""Parity of the port's gradient slice (rays1bench_tpu_torch.grad) with the
JAX package's on the CPU: render_image_mega's value and gradients, three
steps of the Adam fit, and a fit carried across through a JAX checkpoint.
Also: the entry points run on the card unless the caller asks for the CPU,
the unported modes raise, and engine="pipeline" and auto's route to it
work (tests/test_torch_pipeline_grad.py holds that engine to JAX).

JAX's Pallas kernels run in interpret mode (fused=True, interpret=True), as
tests/test_grad.py runs them. Scene and camera leaves go across as numpy
(scene/convert.py). Tolerances and why:
- Slice (small scene, 64x32 @ 2 spp @ 5 b): the image is held to the render
  slice's bound (tests/test_torch_render.py), mean abs gap <= 1e-3
  (measured 2.2e-8); each of the nine scene columns' and seven camera
  fields' gradients to max abs gap <= 2e-3 of the
  field's max abs value, the JAX package's fused-vs-replay bound
  (tests/test_grad.py:390); measured worst 1.7e-4 (fuzz), 1.9e-4 (u). The
  gap is XLA's rsqrt and FMA drift carried through the chain.
- Fit (small scene, 32x16 @ 2 spp @ 3 b, three Adam steps on the albedos,
  lr 1e-2): losses within LOSS_TOL relative (measured 1.1e-7) and params
  within PARAM_TOL absolute (measured 2.4e-7, against a 1e-2 step).
- Checkpoints: bits unchanged in both directions; one step after resuming
  within the fit's tolerances.
"""

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rays1bench_tpu.core.config import RenderConfig as JConfig
from rays1bench_tpu.grad import checkpoint as jckpt
from rays1bench_tpu.grad import inverse as jinverse
from rays1bench_tpu.grad.mega import render_image_mega as jrender_image_mega
from rays1bench_tpu.scene import builders as jbuilders
from rays1bench_tpu_torch.core.config import RenderConfig
from rays1bench_tpu_torch.grad import checkpoint as ckpt
from rays1bench_tpu_torch.grad import inverse
from rays1bench_tpu_torch.grad.mega import render_image_mega
from rays1bench_tpu_torch.render.camera import Camera, CameraSpec
from rays1bench_tpu_torch.render.pipeline import render_image
from rays1bench_tpu_torch.scene import builders as tbuilders
from rays1bench_tpu_torch.scene import convert
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS, SphereSOABuilder

torch.set_num_threads(1)

IMG_TOL = 1e-3
REL_TOL = 2e-3
LOSS_TOL = 1e-5
PARAM_TOL = 1e-5
SCENE_COLUMNS = ("center_x", "center_y", "center_z", "radius", "albedo_x",
                 "albedo_y", "albedo_z", "fuzz", "ref_idx")
ALBEDOS = ("albedo_x", "albedo_y", "albedo_z")


def leaves(obj, names):
    return {n: np.array(getattr(obj, n)) for n in names}


def rel_gap(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def port_scene(jsoa, jcam):
    return (convert.soa_from_numpy(leaves(jsoa, COLUMNS), "cpu"),
            convert.camera_from_numpy(leaves(jcam, convert.CAMERA_FIELDS),
                                      "cpu"))


def test_slice_value_and_gradients_match_jax():
    kw = dict(width=64, height=32, spp=2, max_bounces=5, seed=7,
              early_exit=False)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    jscene = jbuilders.create_small_scene(jcfg.aspect, pad_multiple=8)
    jcam = jscene.camera.build()
    p0 = jinverse.params_of(jscene.spheres, SCENE_COLUMNS)
    p0["center_x"] = p0["center_x"].at[0].add(0.04)
    p0["radius"] = p0["radius"].at[0].add(-0.02)

    def jloss(p, cam):
        img, _ = jrender_image_mega(jinverse.with_params(jscene.spheres, p),
                                    cam, jcfg, interpret=True, fused=True)
        return jnp.mean((img - 0.3) ** 2), img

    import jax
    (_, jimg), (jgp, jgc) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p0, jcam)

    soa, cam = port_scene(jscene.spheres, jcam)
    params = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in p0.items()}
    cam_leaves = {f: getattr(cam, f).clone().requires_grad_(True)
                  for f in convert.CAMERA_FIELDS}
    img, _ = render_image_mega(inverse.with_params(soa, params),
                               Camera(**cam_leaves), cfg)
    torch.mean((img - 0.3) ** 2).backward()

    assert np.abs(img.detach().numpy() - np.asarray(jimg)).mean() <= IMG_TOL
    for k in SCENE_COLUMNS:
        g = params[k].grad.numpy()
        assert rel_gap(g, np.asarray(jgp[k])) <= REL_TOL, k
        assert np.isfinite(g).all() and np.abs(g[jscene.n_real:]).max() == 0
    for f in convert.CAMERA_FIELDS:
        g = cam_leaves[f].grad.numpy()
        assert rel_gap(g, np.asarray(getattr(jgc, f))) <= REL_TOL, f


def test_fused_backward_matches_the_replay_backward():
    """fused=True (the fused backward's plain version) and fused=False
    (autograd over render_image(topology=...)) differentiate the same
    replay: on the CPU they agree to rounding (measured: equal)."""
    cfg = RenderConfig(width=24, height=16, spp=2, max_bounces=4, seed=3,
                       early_exit=False)
    scene = tbuilders.create_medium_scene(cfg.aspect, pad_multiple=8,
                                          device="cpu")
    cam = scene.camera.build("cpu")
    grads = {}
    for fused in (True, False):
        params = inverse.params_of(scene.spheres, SCENE_COLUMNS)
        origin = cam.origin.clone().requires_grad_(True)
        img, n = render_image_mega(inverse.with_params(scene.spheres, params),
                                   dataclasses.replace(cam, origin=origin),
                                   cfg, fused=fused)
        torch.mean((img - 0.3) ** 2).backward()
        grads[fused] = {**{k: v.grad for k, v in params.items()},
                        "origin": origin.grad}
    for k, g in grads[True].items():
        assert rel_gap(g.numpy(), grads[False][k].numpy()) <= 1e-6, k
    assert int(n) > cfg.num_primary_rays


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """Three Adam steps of the JAX fit on the albedos (medium-fit recipe:
    RandomState(11) factors 0.6 + 0.9 * rand on the real rows, clipped),
    checkpointed at the end, and its inputs."""
    kw = dict(width=32, height=16, spp=2, max_bounces=3, seed=5,
              early_exit=False)
    jcfg = JConfig(**kw)
    jscene = jbuilders.create_small_scene(jcfg.aspect, pad_multiple=8)
    jcam = jscene.camera.build()
    target = jinverse.render_for_loss(jscene.spheres, jcam, jcfg,
                                      engine="mega")
    fac = 0.6 + 0.9 * np.random.RandomState(11).rand(3, jscene.spheres.count)
    fac[:, jscene.n_real:] = 1.0
    pert = dataclasses.replace(jscene.spheres, **{
        c: jnp.clip(getattr(jscene.spheres, c) * fac[k], 0, 1)
        for k, c in enumerate(ALBEDOS)})
    inv = jinverse.InverseConfig(learning_rate=1e-2, steps=3,
                                 optimize=ALBEDOS)
    path = str(tmp_path_factory.mktemp("jax_fit") / "fit.npz")
    fitted, losses = jinverse.fit_scene(pert, jcam, target, jcfg, inv,
                                        engine="mega", checkpoint_path=path)
    soa, cam = port_scene(pert, jcam)
    return dict(jcfg=jcfg, cfg=RenderConfig(**kw), jcam=jcam, pert=pert,
                target=np.array(target), fitted=fitted, losses=losses,
                path=path, soa=soa, cam=cam,
                inv=inverse.InverseConfig(learning_rate=1e-2, steps=3,
                                          optimize=ALBEDOS))


def test_fit_scene_matches_jax(jax_fit):
    f = jax_fit
    fitted, losses = inverse.fit_scene(f["soa"], f["cam"],
                                       torch.from_numpy(f["target"]),
                                       f["cfg"], f["inv"], device="cpu")
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert np.allclose(losses, f["losses"], rtol=LOSS_TOL, atol=0)
    for c in ALBEDOS:
        got = getattr(fitted, c).numpy()
        assert np.abs(got - np.asarray(getattr(f["fitted"], c))).max() \
            <= PARAM_TOL, c
    assert torch.equal(fitted.center_x, f["soa"].center_x)


def port_adam(soa, names, lr=1e-2):
    params = inverse.params_of(soa, names)
    return params, torch.optim.Adam(list(params.values()), lr=lr, eps=1e-8)


def test_resume_from_a_jax_checkpoint(jax_fit, tmp_path):
    """A fit the JAX package checkpointed resumes in the port: params and
    Adam moments come out bit-equal, and one more step on each side
    agrees."""
    f = jax_fit
    params, opt = port_adam(f["soa"], ALBEDOS)
    assert ckpt.restore(f["path"], params, opt) == 3
    with np.load(f["path"]) as data:
        for k, c in enumerate(ALBEDOS):
            p = params[c]
            assert np.array_equal(p.detach().numpy(), data[f"param::{c}"])
            assert np.array_equal(
                p.detach().numpy(), np.asarray(getattr(f["fitted"], c)))
            st = opt.state[p]
            assert np.array_equal(st["exp_avg"].numpy(),
                                  data[f"opt::{1 + k}"])
            assert np.array_equal(st["exp_avg_sq"].numpy(),
                                  data[f"opt::{4 + k}"])
            assert float(st["step"]) == 3.0 == float(data["opt::0"])

    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    shutil.copy(f["path"], jpath)
    shutil.copy(f["path"], tpath)
    inv4 = dataclasses.replace(f["inv"], steps=4)
    jfitted, jlosses = jinverse.fit_scene(
        f["pert"], f["jcam"], jnp.asarray(f["target"]), f["jcfg"],
        jinverse.InverseConfig(learning_rate=1e-2, steps=4, optimize=ALBEDOS),
        engine="mega", checkpoint_path=jpath)
    fitted, losses = inverse.fit_scene(
        f["soa"], f["cam"], torch.from_numpy(f["target"]), f["cfg"], inv4,
        checkpoint_path=tpath, device="cpu")
    assert len(losses) == len(jlosses) == 1
    assert np.allclose(losses, jlosses, rtol=LOSS_TOL, atol=0)
    for c in ALBEDOS:
        assert np.abs(getattr(fitted, c).numpy()
                      - np.asarray(getattr(jfitted, c))).max() <= PARAM_TOL


def test_checkpoint_round_trips_and_refuses_a_mismatch(jax_fit, tmp_path):
    """The port's save -> restore keeps every bit, the JAX package restores
    the port's file, and a file with the wrong parameters or optimizer
    leaves is refused."""
    f = jax_fit
    params, opt = port_adam(f["soa"], ALBEDOS)
    ckpt.restore(f["path"], params, opt)
    path = str(tmp_path / "port.npz")
    ckpt.save(path, params, opt, 3)
    again, opt2 = port_adam(f["soa"], ALBEDOS)
    assert ckpt.restore(path, again, opt2) == 3
    for c in ALBEDOS:
        assert torch.equal(again[c], params[c])
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt2.state[again[c]][key],
                               opt.state[params[c]][key])

    jparams = {c: jnp.asarray(params[c].detach().numpy()) for c in ALBEDOS}
    jp, jstate, step = jckpt.restore(path,
                                     optax.adam(1e-2).init(jparams))
    assert step == 3
    with np.load(f["path"]) as want:
        for c in ALBEDOS:
            assert np.array_equal(np.asarray(jp[c]), want[f"param::{c}"])
        assert np.array_equal(np.asarray(jstate[0].count), want["opt::0"])
        for k, c in enumerate(ALBEDOS):
            assert np.array_equal(np.asarray(jstate[0].mu[c]),
                                  want[f"opt::{1 + k}"])
            assert np.array_equal(np.asarray(jstate[0].nu[c]),
                                  want[f"opt::{4 + k}"])

    other, opt3 = port_adam(f["soa"], ("albedo_x", "albedo_y"))
    with pytest.raises(ValueError, match="optimizer leaves"):
        ckpt.restore(path, other, opt3)
    with np.load(path) as data:
        extra = dict(data)
    extra["opt::7"] = np.zeros(3, np.float32)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **extra)
    with pytest.raises(ValueError, match="optimizer leaves"):
        ckpt.restore(bad, params, opt)


def test_fit_scene_row_masks_freeze_other_rows():
    cfg = RenderConfig(width=16, height=8, spp=1, max_bounces=3,
                       early_exit=False)
    scene = tbuilders.create_small_scene(cfg.aspect, pad_multiple=8,
                                         device="cpu")
    cam = scene.camera.build("cpu")
    target = torch.full((8, 16, 3), 0.2)
    inv = inverse.InverseConfig(learning_rate=1e-2, steps=2,
                                optimize=ALBEDOS, rows=(0,),
                                rows_by=(("albedo_z", (1, 2)),))
    fitted, losses = inverse.fit_scene(scene.spheres, cam, target, cfg, inv,
                                       device="cpu")
    moved = lambda c: (getattr(fitted, c) != getattr(scene.spheres, c))
    assert moved("albedo_x")[0] and not moved("albedo_x")[1:].any()
    assert not moved("albedo_z")[0] and not moved("albedo_z")[3:].any()
    assert len(losses) == 2


def test_entry_points_run_on_the_card_unless_asked():
    """With no device argument the entry points put their tensors on the
    card, and raise where torch sees none; device="cpu" runs them here."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    cfg = RenderConfig(width=8, height=4, spp=1, max_bounces=2)
    spec = CameraSpec(lookfrom=(0, 0, 1), lookat=(0, 0, 0))
    for call in (lambda: tbuilders.create_small_scene(2.0),
                 lambda: tbuilders.SCENES["medium"](2.0, pad_multiple=8),
                 lambda: SphereSOABuilder().finalize(8),
                 spec.build,
                 lambda: convert.soa_from_numpy(
                     leaves(jbuilders.create_small_scene(2.0).spheres,
                            COLUMNS))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    scene = tbuilders.create_small_scene(2.0, pad_multiple=8, device="cpu")
    cam = spec.build("cpu")
    target = torch.zeros((4, 8, 3))
    inv = inverse.InverseConfig(steps=1, optimize=ALBEDOS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inverse.fit_scene(scene.spheres, cam, target, cfg, inv)
    fitted, losses = inverse.fit_scene(scene.spheres, cam, target, cfg, inv,
                                       device="cpu")
    assert fitted.albedo_x.device.type == "cpu" and len(losses) == 1


def test_unported_modes_raise_with_their_roadmap_item(tmp_path):
    """fit_camera raises. A mesh is ported (parallel/, here a group of one
    gloo rank): fit_scene(mesh=...) fits, and each engine's render on it is
    the one without a mesh (tests/test_torch_shard_grad.py holds four
    ranks to one). engine="pipeline" is ported: it renders the plain
    pipeline with the index sweep. A scene the fused backward cannot take
    (51 bounces) now goes to the pipeline under auto; an explicit "mega"
    still raises there. Soft silhouettes are ported: the config takes them
    and engine="mega" renders them."""
    import torch.distributed as dist

    from rays1bench_tpu_torch.parallel.mesh import make_mesh

    cfg = RenderConfig(width=8, height=4, spp=1, max_bounces=2)
    scene = tbuilders.create_small_scene(2.0, pad_multiple=8, device="cpu")
    cam = scene.camera.build("cpu")
    want, _ = render_image(scene.spheres, cam,
                           cfg.replace(early_exit=False,
                                       pallas_intersect=True))
    img = inverse.render_for_loss(scene.spheres, cam, cfg, engine="pipeline")
    assert torch.equal(img, want)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device="cpu")
        for engine in ("pipeline", "mega"):
            assert torch.equal(
                inverse.render_for_loss(scene.spheres, cam, cfg, mesh,
                                        engine),
                inverse.render_for_loss(scene.spheres, cam, cfg,
                                        engine=engine)), engine
        inv = inverse.InverseConfig(steps=2, optimize=ALBEDOS)
        target = torch.zeros((cfg.height, cfg.width, 3))
        fitted, losses = inverse.fit_scene(scene.spheres, cam, target, cfg,
                                           inv, mesh=mesh, device="cpu")
        _, want_losses = inverse.fit_scene(scene.spheres, cam, target, cfg,
                                           inv, device="cpu")
        assert losses == want_losses and losses[1] < losses[0]
    finally:
        dist.destroy_process_group()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        inverse.fit_camera(scene.spheres, scene.camera, None, cfg)
    deep = cfg.replace(max_bounces=51)
    want, _ = render_image(scene.spheres, cam,
                           deep.replace(early_exit=False,
                                        pallas_intersect=True))
    assert torch.equal(inverse.render_for_loss(scene.spheres, cam, deep),
                       want)
    with pytest.raises(ValueError, match="supported"):
        inverse.render_for_loss(scene.spheres, cam, deep, engine="mega")
    soft = cfg.replace(soft_silhouette=0.01)
    assert soft.soft_silhouette == 0.01
    want, _ = render_image_mega(scene.spheres, cam, inverse._grad_cfg(soft))
    img = inverse.render_for_loss(scene.spheres, cam, soft, engine="mega")
    assert torch.equal(img, want) and torch.isfinite(img).all()


def test_bench_grad_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    from rays1bench_tpu_torch.bench import grad as bench_grad
    with pytest.raises(SystemExit, match="CUDA"):
        bench_grad.main(["--scene", "small"])


def test_bench_grad_names_the_kernels_in_a_trace():
    """The profiler split finds the port's kernels by name, the template
    instantiations of the hard and soft modes included, and not torch's."""
    from rays1bench_tpu_torch.bench.grad import KERNELS, is_kernel
    events = {
        "oneshot": "void (anonymous namespace)::oneshot_kernel<true>(float "
                   "const*, int, float const*",
        "mega_backward": "void (anonymous namespace)::backward_kernel<false>"
                         "(float const*, int, float const",
        "intersect_index": "(anonymous namespace)::index_kernel(float const*,"
                           " int, float const*)"}
    for kernel, function in KERNELS.items():
        for other, name in events.items():
            assert is_kernel(name, function) == (other == kernel)
    torch_own = ("void at::native::indexing_backward_kernel<float, 4>(long "
                 "const*)")
    assert not any(is_kernel(torch_own, f) for f in KERNELS.values())
