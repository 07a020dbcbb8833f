"""The port's differentiable mode against the JAX reference: torch autograd
through path_tracer.render and volume_pt.render (differentiable=True and
"remat") against jax.grad of the same renders on the same scene arrays,
seeds and streams; finite differences in the port alone with common random
numbers; "remat" against plain (values bit-equal, gradients within rtol
1e-6, fewer saved bytes); the "pallas" routes; a forward render that
refuses a gradient and keeps its image bit for bit; the inverse-rendering
entry; and, one case per site, the reference's detach sites (each port
function's gradient against jax.grad / jax.jvp of the reference's).

Tolerances: gradients against JAX's AD rtol 1e-3 (path tracer; the k_d
table atol 1e-6 too) and rtol 5e-3, atol 1e-5 (volume path tracer); the
differentiable renders' images at the composed holds' per-lane contract
(rtol 1e-4, atol 1e-5 on >= 95 % of lanes, means within 1e-3 relative);
the detach sites rtol 1e-3 with an atol of 1e-4 of the gradient's largest
entry or 1e-6, whichever is larger (a missing detach moves a gradient by
O(1))."""

import dataclasses
import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch import inverse_render
from cuda_pt_torch.bsdf import eval as t_eval
from cuda_pt_torch.core.config import MaxDepthParams as TMD
from cuda_pt_torch.emitters import emitters as t_em
from cuda_pt_torch.media import grid as t_grid
from cuda_pt_torch.media import homogeneous as t_homo
from cuda_pt_torch.media import phase as t_phase
from cuda_pt_torch.models import light_tracer as t_lt
from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.models import volume_pt as t_vpt
from cuda_pt_torch.ops import traverse_kernel as t_tk
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_tpu.bsdf import eval as j_eval
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.emitters import emitters as j_em
from cuda_pt_tpu.media import grid as j_grid
from cuda_pt_tpu.media import homogeneous as j_homo
from cuda_pt_tpu.media import phase as j_phase
from cuda_pt_tpu.models import light_tracer as j_lt
from cuda_pt_tpu.models import path_tracer as j_pt
from cuda_pt_tpu.models import volume_pt as j_vpt
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import types as JT
from cuda_pt_tpu.scene.builder import BSDFSpec, MediumSpec, SceneBuilder
from test_torch_bridge import flatten_jax_camera, flatten_jax_scene, numpy_bvh_builds
from test_torch_bsdf_emitters import scenes  # noqa: F401  (module fixture)
from test_torch_grid import _sides
from test_torch_media import _media, _phase_inputs

RTOL_PT, RTOL_VPT, ATOL_VPT = 1e-3, 5e-3, 1e-5
LANE_RTOL, LANE_ATOL, MIN_LANES, MEAN_REL = 1e-4, 1e-5, 0.95, 1e-3
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_forward_s3.npz")


def _bridge(sj, cj):
    return bridge.scene_from_numpy(flatten_jax_scene(sj)), bridge.camera_from_numpy(
        flatten_jax_camera(cj))


def _set_row(x: torch.Tensor, i: int, v: torch.Tensor) -> torch.Tensor:
    """x with row i replaced by v, attached to v."""
    return torch.cat([x[:i], v.expand(x.shape[1:])[None], x[i + 1:]])


def _with(scene, table: str, **fields):
    return dataclasses.replace(scene, **{table: dataclasses.replace(getattr(scene, table),
                                                                    **fields)})


def _lanes_hold(img_t, img_j):
    img_t, img_j = np.asarray(img_t), np.asarray(img_j)
    ok = np.isclose(img_t, img_j, rtol=LANE_RTOL, atol=LANE_ATOL).all(axis=-1).mean()
    assert ok >= MIN_LANES, ok
    assert abs(img_t.mean() - img_j.mean()) <= MEAN_REL * abs(img_j.mean())


def medium_cube(w=10):
    """tests/test_gradients_fd.py::test_grad_homogeneous_sigma_matches_fd's
    scene: the cornell box holding a cube of null faces filled with a
    homogeneous medium (JAX)."""
    _, cam, bld = j_ts.cornell_box(width=w, height=w)
    b = SceneBuilder()
    b.bsdfs = list(bld.bsdfs)
    b.emitters = list(bld.emitters)
    fwd = b.add_bsdf(BSDFSpec(btype=JT.BSDF_FORWARD))
    med = b.add_medium(MediumSpec(sigma_a=(0.1, 0.1, 0.1), sigma_s=(0.8, 0.8, 0.8), scale=1.0))
    for ob in bld.objects:
        b.objects.append(ob)
    q = j_ts.quad
    cube = np.concatenate([
        q([0.2, 0.05, 0.2], [0.8, 0.05, 0.2], [0.8, 0.65, 0.2], [0.2, 0.65, 0.2]),
        q([0.8, 0.05, 0.8], [0.2, 0.05, 0.8], [0.2, 0.65, 0.8], [0.8, 0.65, 0.8]),
        q([0.2, 0.05, 0.8], [0.2, 0.05, 0.2], [0.2, 0.65, 0.2], [0.2, 0.65, 0.8]),
        q([0.8, 0.05, 0.2], [0.8, 0.05, 0.8], [0.8, 0.65, 0.8], [0.8, 0.65, 0.2]),
        q([0.2, 0.65, 0.2], [0.8, 0.65, 0.2], [0.8, 0.65, 0.8], [0.2, 0.65, 0.8]),
        q([0.2, 0.05, 0.8], [0.8, 0.05, 0.8], [0.8, 0.05, 0.2], [0.2, 0.05, 0.2])], axis=0)
    b.add_mesh(cube, fwd, medium_in=med, cullable=True)
    return b.compile(), cam


# ---------------------------------------------------------------------------
# gradients against JAX's AD: one jitted reference per scene
# ---------------------------------------------------------------------------


def _reference(render_j, params_j: tuple, target: np.ndarray | None = None):
    """jit(render_j) at params_j -> (image, d mean(image) / d params, and
    with a target d mean((image - target)^2) / d params): one forward and
    one or two cotangents."""

    @jax.jit
    def run(params):
        img, vjp = jax.vjp(lambda *p: render_j(*p), *params)
        n = img.size
        mse = () if target is None else (vjp(2.0 * (img - jnp.asarray(target)) / n),)
        return (img, vjp(jnp.ones_like(img) / n)) + mse

    img, *grads = run(params_j)
    return [np.asarray(img)] + [[np.asarray(g) for g in gs] for gs in grads]


def _port(render_t, params: tuple, target: np.ndarray | None = None):
    """The port's counterpart of _reference: leaves with requires_grad."""
    leaves = [torch.tensor(np.asarray(p), requires_grad=True) for p in params]
    img = render_t(*leaves)
    out = [img.detach().numpy(), [g.numpy() for g in torch.autograd.grad(
        img.mean(), leaves, retain_graph=target is not None)]]
    if target is not None:
        out.append([g.numpy() for g in torch.autograd.grad(
            torch.mean((img - torch.as_tensor(target)) ** 2), leaves)])
    return out


@pytest.fixture(scope="module")
def pt_cornell():
    """cornell 12x12, max_depth 3, 4 spp, seed 3: the emitter scaler of the
    ceiling light and the whole k_d table (row 0 the white walls)."""
    sj, cj, _ = j_ts.cornell_box(width=12, height=12)
    st, ct = _bridge(sj, cj)
    md_j, md_t = JMD(max_depth=3), TMD(max_depth=3)
    params = (np.float32(12.0), np.asarray(sj.bsdfs.k_d))
    target = np.random.default_rng(0).uniform(0.0, 0.6, (12, 12, 3)).astype(np.float32)

    def render_j(s, kd):
        sc = sj.replace(emitters=sj.emitters.replace(scaler=sj.emitters.scaler.at[1].set(s)),
                        bsdfs=sj.bsdfs.replace(k_d=kd))
        return j_pt.render(sc, cj, md_j, spp=4, seed=3, use_bvh=False, differentiable=True)

    def render_t(s, kd):
        sc = _with(_with(st, "emitters", scaler=_set_row(st.emitters.scaler, 1, s)), "bsdfs",
                   k_d=kd)
        return t_pt.render(sc, ct, md_t, 4, seed=3, use_bvh=False, differentiable=True)

    return _reference(render_j, params, target), _port(render_t, params, target)


@pytest.fixture(scope="module")
def pt_furnace():
    """The envmap furnace (albedo 0.6) 10x10, max_depth 4, 4 spp, seed 1:
    the envmap's scaler."""
    sj, cj, _ = j_ts.furnace(width=10, height=10, albedo=0.6)
    st, ct = _bridge(sj, cj)
    eid = int(sj.env_emitter)

    def render_j(s):
        sc = sj.replace(emitters=sj.emitters.replace(scaler=sj.emitters.scaler.at[eid].set(s)))
        return j_pt.render(sc, cj, JMD(max_depth=4, max_diffuse=4), spp=4, seed=1,
                           use_bvh=False, differentiable=True)

    def render_t(s):
        sc = _with(st, "emitters", scaler=_set_row(st.emitters.scaler, eid, s))
        return t_pt.render(sc, ct, TMD(max_depth=4, max_diffuse=4), 4, seed=1, use_bvh=False,
                           differentiable=True)

    params = (np.float32(1.0),)
    return _reference(render_j, params), _port(render_t, params)


@pytest.fixture(scope="module")
def vpt_cube():
    """medium_cube 10x10, MaxDepthParams(max_depth=4, max_volume=3), 4 spp,
    seed 2: the ceiling light's scaler and the medium's scale."""
    sj, cj = medium_cube(10)
    st, ct = _bridge(sj, cj)
    md_j, md_t = JMD(max_depth=4, max_volume=3), TMD(max_depth=4, max_volume=3)

    def render_j(s, scale):
        sc = sj.replace(emitters=sj.emitters.replace(scaler=sj.emitters.scaler.at[1].set(s)),
                        media=sj.media.replace(scale=sj.media.scale.at[0].set(scale)))
        return j_vpt.render(sc, cj, md_j, spp=4, seed=2, use_bvh=False, differentiable=True)

    def render_t(s, scale):
        sc = _with(_with(st, "emitters", scaler=_set_row(st.emitters.scaler, 1, s)), "media",
                   scale=_set_row(st.media.scale, 0, scale))
        return t_vpt.render(sc, ct, md_t, 4, seed=2, use_bvh=False, differentiable=True)

    params = (np.float32(12.0), np.float32(1.0))
    return _reference(render_j, params), _port(render_t, params)


@pytest.mark.parametrize("case", ["emitter_scaler", "albedo_row0", "kd_table", "env_scaler",
                                  "vpt_emitter_scaler", "vpt_medium_scale"])
def test_gradients_match_jax(case, request):
    """d mean(image) / d parameter (the k_d table: d mean((image -
    target)^2) / d k_d, every row) against jax.grad of the reference."""
    fixture, idx, loss = {
        "emitter_scaler": ("pt_cornell", 0, 1), "albedo_row0": ("pt_cornell", 1, 1),
        "kd_table": ("pt_cornell", 1, 2), "env_scaler": ("pt_furnace", 0, 1),
        "vpt_emitter_scaler": ("vpt_cube", 0, 1), "vpt_medium_scale": ("vpt_cube", 1, 1)}[case]
    ref, port = request.getfixturevalue(fixture)
    g_j, g_t = ref[loss][idx], port[loss][idx]
    if case == "albedo_row0":  # k_d[0] = (a, a, a): d/da sums the row
        g_j, g_t = g_j[0].sum(), g_t[0].sum()
    assert np.isfinite(g_t).all() and np.abs(g_t).max() > 0.0
    if fixture == "vpt_cube":
        np.testing.assert_allclose(g_t, g_j, rtol=RTOL_VPT, atol=ATOL_VPT)
    else:
        np.testing.assert_allclose(g_t, g_j, rtol=RTOL_PT, atol=1e-6 if case == "kd_table" else 0)


@pytest.mark.parametrize("fixture", ["pt_cornell", "pt_furnace", "vpt_cube"])
def test_differentiable_images_match_jax(fixture, request):
    ref, port = request.getfixturevalue(fixture)
    _lanes_hold(port[0], ref[0])


# ---------------------------------------------------------------------------
# the port alone: finite differences, remat, memory
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cbox():
    scene, cam, _ = t_ts.cornell_box(12, 12)
    return scene, cam, TMD(max_depth=3)


def _render_scaler(scene, cam, md, s, spp=4, seed=3, diff=True):
    sc = _with(scene, "emitters", scaler=_set_row(scene.emitters.scaler, 1, s))
    return t_pt.render(sc, cam, md, spp, seed=seed, use_bvh=False, differentiable=diff)


def _render_albedo(scene, cam, md, a, spp=4, seed=5, diff=True):
    sc = _with(scene, "bsdfs", k_d=_set_row(scene.bsdfs.k_d, 0, a))
    return t_pt.render(sc, cam, md, spp, seed=seed, use_bvh=False, differentiable=diff)


@pytest.mark.parametrize("case,p0,eps,rtol", [("emitter_scaler", 12.0, 0.5, 2e-3),
                                              ("albedo", 0.73, 1e-3, 2e-2)])
def test_gradient_matches_finite_differences(cbox, case, p0, eps, rtol):
    """The reference's _fd_check on the port: autograd against central
    differences with common random numbers (the same streams at p0 +- eps)."""
    render = _render_scaler if case == "emitter_scaler" else _render_albedo

    def f(p):
        return render(*cbox, p).mean()

    p = torch.tensor(p0, requires_grad=True)
    (g_ad,) = torch.autograd.grad(f(p), p)
    with torch.no_grad():
        g_fd = (f(torch.tensor(p0 + eps)) - f(torch.tensor(p0 - eps))) / (2 * eps)
    assert np.isfinite(float(g_ad)) and float(g_fd) != 0.0
    np.testing.assert_allclose(float(g_ad), float(g_fd), rtol=rtol, atol=1e-4)


def _value_and_grad(render, p0, diff):
    p = torch.tensor(p0, requires_grad=True)
    v = render(p, diff)
    (g,) = torch.autograd.grad(v.mean(), p)
    return v.detach(), float(g)


@pytest.mark.parametrize("tracer", ["pt", "vpt"])
def test_remat_matches_plain(cbox, tracer):
    """differentiable="remat" is the same estimator: the image bit for bit,
    the gradient within rtol 1e-6 (emitter scaler, cornell, 2 spp)."""
    scene, cam, md = cbox
    if tracer == "pt":
        def render(s, diff):
            return _render_scaler(scene, cam, md, s, spp=2, diff=diff)
    else:
        sv, cv, _ = t_ts.cornell_vpt(8, 8)

        def render(s, diff):
            sc = _with(sv, "emitters", scaler=_set_row(sv.emitters.scaler, 1, s))
            return t_vpt.render(sc, cv, md, 2, seed=4, use_bvh=False, differentiable=diff)

    v_plain, g_plain = _value_and_grad(render, 10.0, True)
    v_remat, g_remat = _value_and_grad(render, 10.0, "remat")
    assert torch.equal(v_plain, v_remat)
    assert g_plain != 0.0
    np.testing.assert_allclose(g_remat, g_plain, rtol=1e-6)


def test_remat_saves_less():
    """The bytes autograd saves for the backward pass of an image loss
    (mean((pt.render - target)^2), cornell 16x16, max_depth 6), counted by
    a saved_tensors_hooks pack hook around its forward: under "remat" the
    checkpoints keep the render's activations out, so 4 spp save under half
    of plain's, and 16 spp under 1.5x of 4 spp's."""
    scene, cam, _ = t_ts.cornell_box(16, 16)
    md = TMD(max_depth=6)
    target = torch.full((16, 16, 3), 0.3)

    def saved_bytes(diff, spp):
        total = [0]

        def pack(x):
            total[0] += x.numel() * x.element_size()
            return x

        s = torch.tensor(12.0, requires_grad=True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            img = _render_scaler(scene, cam, md, s, spp=spp, diff=diff)
            loss = torch.mean((img - target) ** 2)
        loss.backward()
        assert np.isfinite(float(s.grad)) and float(s.grad) != 0.0
        return total[0]

    plain4 = saved_bytes(True, 4)
    remat4 = saved_bytes("remat", 4)
    remat16 = saved_bytes("remat", 16)
    assert 0 < remat4 and remat4 * 2 < plain4, (remat4, plain4)
    assert remat16 < remat4 * 1.5, (remat16, remat4)


# ---------------------------------------------------------------------------
# the "pallas" routes, forward mode, the entry
# ---------------------------------------------------------------------------


def test_pt_pallas_warns_and_equals_xla():
    """A differentiable path-traced render under traversal "pallas" warns
    and walks with "xla": the gradient equals the "xla" render's exactly
    (tests/test_round3_fixes.py::test_pallas_differentiable_falls_back_with_warning)."""
    scene, cam, _ = t_ts.cornell_box(6, 6)
    md = TMD(max_depth=3)

    def grad(trav):
        a = torch.tensor(0.5, requires_grad=True)
        sc = dataclasses.replace(_with(scene, "bsdfs", k_d=_set_row(scene.bsdfs.k_d, 0, a)),
                                 traversal=trav)
        img = t_pt.render(sc, cam, md, 2, seed=3, use_bvh=True, differentiable=True)
        (g,) = torch.autograd.grad(img.mean(), a)
        return float(g)

    with pytest.warns(UserWarning, match="pallas"):
        g_pal = grad("pallas")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g_xla = grad("xla")
    assert np.isfinite(g_pal) and g_pal != 0.0
    assert g_pal == g_xla


def test_vpt_pallas_walks_k1_detached(monkeypatch):
    """A differentiable volume path-traced render under "pallas" walks on
    K1 (its plain version here), with no fall-back and its inputs detached;
    the medium-scale gradient equals the "xla" walk's within rtol 1e-4
    (cornell_vpt 8x8, use_bvh=True)."""
    scene, cam, _ = t_ts.cornell_vpt(8, 8)
    md = TMD(max_depth=3)
    calls = []
    walk = t_tk.traverse_forest

    def spy(forest, o, d, *a, **kw):
        calls.append(o.requires_grad or d.requires_grad)
        return walk(forest, o, d, *a, **kw)

    monkeypatch.setattr(t_tk, "traverse_forest", spy)

    def grad(trav):
        sc = torch.tensor(1.0, requires_grad=True)
        sv = dataclasses.replace(_with(scene, "media", scale=_set_row(scene.media.scale, 0, sc)),
                                 traversal=trav)
        img = t_vpt.render(sv, cam, md, 2, seed=4, use_bvh=True, differentiable="remat")
        (g,) = torch.autograd.grad(img.mean(), sc)
        return img.detach(), float(g)

    img_x, g_x = grad("xla")
    assert not calls
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no fall-back warning
        img_p, g_p = grad("pallas")
    assert calls and not any(calls)
    assert g_x != 0.0
    np.testing.assert_allclose(img_p.numpy(), img_x.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_p, g_x, rtol=1e-4)


def test_forward_render_refuses_gradient_and_keeps_image(monkeypatch):
    """A forward render builds no graph, so .backward() raises (as jax.grad
    through the reference's while_loop does), and its images equal, bit for
    bit, those the forward-only port rendered (tests/golden, read only; its
    scenes were compiled on the NumPy BVH path, which they take here)."""
    numpy_bvh_builds(monkeypatch)
    gold = np.load(GOLDEN)
    scene, cam, _ = t_ts.cornell_box(16, 16)
    a = torch.tensor(0.73, requires_grad=True)
    img = t_pt.render(_with(scene, "bsdfs", k_d=_set_row(scene.bsdfs.k_d, 0, a)), cam,
                      TMD(max_depth=4), 4, seed=3)
    assert not img.requires_grad
    with pytest.raises(RuntimeError):
        img.mean().backward()
    np.testing.assert_array_equal(img.numpy(), gold["pt_cornell_16_s3"])
    sv, cv, _ = t_ts.nested_media(8, 8)
    np.testing.assert_array_equal(t_vpt.render(sv, cv, TMD(max_depth=4), 2, seed=5).numpy(),
                                  gold["vpt_nested_8_s5"])
    sk, ck, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    sk.traversal = "pallas"
    np.testing.assert_array_equal(t_pt.render(sk, ck, TMD(max_depth=3), 1, seed=2).numpy(),
                                  gold["pt_kitchen_pallas_8_s2"])


def test_inverse_render_entry_recovers_emitter(tmp_path):
    """python -m cuda_pt_torch.inverse_render --param emitter --steps 15
    --res 8 --device cpu exits 0 with recovered true, as
    tests/test_round2_fixes.py::test_inverse_render_script_smoke runs the
    reference's script at 25 steps and 16x16 (15 steps at 8x8 keep the
    test near 15 s here; the error has fallen to 0.28 of its start by
    then); its first step's gradient equals pt.render's on the same seed
    (plain mode, rtol 1e-6)."""
    import contextlib
    import io
    import json

    grads = []
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = inverse_render.main(["--param", "emitter", "--steps", "15", "--res", "8",
                                  "--device", "cpu", "--out", str(tmp_path)],
                                 on_step=lambda rec: grads.append(rec["grad"].clone()))
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and last["recovered"] is True, out.getvalue()
    assert (tmp_path / "final.png").exists() and len(grads) == 15

    prob = inverse_render.make_problem("emitter", 8, "cpu")
    target = prob.render(prob.apply(prob.scene, prob.theta_true), inverse_render.TARGET_SEED, 32,
                         False)
    theta = prob.theta0.clone().requires_grad_(True)
    img = prob.render(prob.apply(prob.scene, theta), 1, 8, True)
    (g,) = torch.autograd.grad(torch.mean((img - target) ** 2), theta)
    np.testing.assert_allclose(grads[0].numpy(), g.numpy(), rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# the detach sites, one case each: the port function's gradient against the
# reference function's on the same inputs
# ---------------------------------------------------------------------------


def _site_homogeneous(_):
    """homogeneous.sample_distance: t and the channel's sigma_t detached,
    the weights attached (d / d media.scale)."""
    jm, tm, mid, t_surf, u = _media(5)
    rs = np.random.default_rng(1)
    cw, ct_ = rs.normal(size=(mid.shape[0], 3)), rs.normal(size=mid.shape[0])
    scale0 = np.asarray(jm.scale)

    def f_j(scale):
        out = j_homo.sample_distance(jm.replace(scale=scale), jnp.asarray(mid),
                                     jnp.asarray(t_surf), jnp.asarray(u))
        return jnp.sum(out["weight"] * cw) + jnp.sum(out["t"] * ct_)

    scale = torch.tensor(scale0, requires_grad=True)
    out = t_homo.sample_distance(dataclasses.replace(tm, scale=scale), torch.as_tensor(mid),
                                 torch.as_tensor(t_surf), torch.as_tensor(u))
    loss = (out["weight"] * torch.as_tensor(cw, dtype=torch.float32)).sum() + (
        out["t"] * torch.as_tensor(ct_, dtype=torch.float32)).sum()
    return torch.autograd.grad(loss, scale), [jax.jit(jax.grad(f_j))(jnp.asarray(scale0))]


def _site_grid(fn):
    """media/grid.py's tracking loops (d / d the density grid and the media's
    density scales): the steps,
    the collision test and the roulette read detached values, the weights
    (delta tracking's sigma / majorant over its detached probability,
    ratio and residual tracking's transmittance) stay attached. The
    transmittance cases walk segments four times as long, and residual
    tracking a control density a tenth of the mean, so their roulettes
    run."""

    def run(_):
        jx, tx, lj, lt = _sides(3)
        c = np.random.default_rng(2).normal(size=(lt["o"].shape[0], 3)).astype(np.float32)
        dens0, scale0 = np.asarray(jx.grids.density), np.asarray(jx.media.scale)
        ctrl = 0.1 if fn == "transmittance_grid_residual" else 1.0

        def call(mod, x, lanes, grids, scale):
            side = types.SimpleNamespace(grids=grids, media=types.SimpleNamespace(
                **{**vars(x.media), "scale": scale}))
            if fn == "sample_distance_grid":
                out, _ = mod.sample_distance_grid(side, lanes["mid"], lanes["o"], lanes["d"],
                                                  lanes["dist"] + 0.5, lanes["rng"],
                                                  lanes["active"])
                return out["weight"], out["t"]
            tr, _ = getattr(mod, fn)(side, lanes["mid"], lanes["o"], lanes["d"],
                                     lanes["dist"] * 4.0, lanes["rng"], lanes["active"])
            return tr[:, None], None

        def f_j(dens, scale):
            grids = jx.grids.replace(density=dens, avg_density=jx.grids.avg_density * ctrl)
            w, t = call(j_grid, jx, lj, grids, scale)
            loss = jnp.sum(w * c[:, :w.shape[1]])
            return loss if t is None else loss + jnp.sum(t * c[:, 0])

        leaves = [torch.tensor(x, requires_grad=True) for x in (dens0, scale0)]
        w, t = call(t_grid, tx, lt, dataclasses.replace(
            tx.grids, density=leaves[0], avg_density=tx.grids.avg_density * ctrl), leaves[1])
        ct = torch.as_tensor(c)
        loss = (w * ct[:, :w.shape[1]]).sum()
        if t is not None:
            loss = loss + (t * ct[:, 0]).sum()
        return (torch.autograd.grad(loss, leaves),
                jax.jit(jax.grad(f_j, argnums=(0, 1)))(jnp.asarray(dens0), jnp.asarray(scale0)))

    return run


def _site_phase(_):
    """phase_sample: the sampled direction detached, the pdf attached
    (d / d g, g2, w of a dual-lobe HG)."""
    ptype, g, g2, w, d_in, _, rs = _phase_inputs(JT.PHASE_DUAL_HG, 4)
    # off the small-|g| branch and its neighbourhood, where d/dg is rounding noise
    g, g2 = (np.where(np.abs(x) < 0.05, np.float32(0.3), x) for x in (g, g2))
    u2 = rs.uniform(0.0, 1.0, (g.shape[0], 2)).astype(np.float32)
    u1 = rs.uniform(0.0, 1.0, g.shape[0]).astype(np.float32)
    cd, cp = rs.normal(size=(g.shape[0], 3)), rs.normal(size=g.shape[0])

    def f_j(g_, g2_, w_):
        d, pdf = j_phase.phase_sample(jnp.asarray(ptype), g_, g2_, w_, jnp.asarray(d_in),
                                      jnp.asarray(u2), jnp.asarray(u1))
        return jnp.sum(d * cd) + jnp.sum(pdf * cp)

    leaves = [torch.tensor(x, requires_grad=True) for x in (g, g2, w)]
    d, pdf = t_phase.phase_sample(torch.as_tensor(ptype), *leaves, torch.as_tensor(d_in),
                                  torch.as_tensor(u2), torch.as_tensor(u1))
    loss = (d * torch.as_tensor(cd, dtype=torch.float32)).sum() + (
        pdf * torch.as_tensor(cp, dtype=torch.float32)).sum()
    return (torch.autograd.grad(loss, leaves),
            jax.jit(jax.grad(f_j, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (g, g2, w))))


def _site_emitter(scenes):
    """sample_emitter: dir, dist and pdf detached, le attached (d / d the
    shading points and the emitters' scalers; area, area-spot, point and
    envmap lights)."""
    sj, st, _ = scenes
    rs = np.random.default_rng(6)
    B = 256
    p0 = rs.uniform(-0.5, 1.5, (B, 3)).astype(np.float32)
    n = rs.normal(size=(B, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    rng = rs.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)
    c = {k: rs.normal(size=s) for k, s in (("dir", (B, 3)), ("dist", B), ("le", (B, 3)),
                                            ("pdf", B))}
    sc0 = np.asarray(sj.emitters.scaler)

    def f_j(p, sc):
        es, _ = j_em.sample_emitter(sj.replace(emitters=sj.emitters.replace(scaler=sc)), p,
                                    jnp.asarray(n), jnp.asarray(rng))
        return sum(jnp.sum(es[k] * c[k]) for k in c)

    leaves = [torch.tensor(p0, requires_grad=True), torch.tensor(sc0, requires_grad=True)]
    es, _ = t_em.sample_emitter(_with(st, "emitters", scaler=leaves[1]), leaves[0],
                                torch.as_tensor(n), torch.as_tensor(rng.astype(np.int64)))
    loss = sum((es[k] * torch.as_tensor(c[k], dtype=torch.float32)).sum() for k in c)
    return (torch.autograd.grad(loss, leaves),
            jax.jit(jax.grad(f_j, argnums=(0, 1)))(jnp.asarray(p0), jnp.asarray(sc0)))


def _site_bsdf(scenes):
    """sample_bsdf: wi, pdf and the locked dispersion wavelength detached,
    the weight attached. d / d the k_d and k_s tables and the wavelength
    uniform with every family present; d / d the parameter table (the
    roughness columns) with GGX-conductor lanes alone, whose sampled wi and
    pdf read it (with every family present, the reference's roughness and
    ior derivatives are NaN: unselected families' branches)."""
    sj, st, mats = scenes
    rs = np.random.default_rng(7)
    B = 512
    n_s = rs.normal(size=(B, 3)).astype(np.float32)
    n_s /= np.linalg.norm(n_s, axis=1, keepdims=True)
    uv = rs.uniform(-1.5, 2.5, (B, 2)).astype(np.float32)
    wo = rs.normal(size=(B, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    rng = rs.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)
    c = {k: rs.normal(size=s) for k, s in (("wi", (B, 3)), ("weight", (B, 3)), ("pdf", B),
                                            ("wl", B))}
    mixed = rs.choice(np.asarray(list(mats.values()), np.int32), B)
    conductor = np.full(B, mats[JT.BSDF_GGX_CONDUCTOR], np.int32)
    cases = (  # (lanes' materials, table fields, present families)
        (mixed, ("k_d", "k_s"), None),
        (conductor, ("params",), (JT.BSDF_GGX_CONDUCTOR,)))
    got, want = [], []
    for bid, fields, present in cases:
        x0 = [np.asarray(getattr(sj.bsdfs, f)) for f in fields] + [
            rs.uniform(0.0, 1.0, B).astype(np.float32)]

        def f_j(*xs):
            cj = j_eval.make_ctx(sj.replace(bsdfs=sj.bsdfs.replace(**dict(zip(fields, xs)))),
                                 jnp.asarray(bid), jnp.asarray(uv), jnp.asarray(n_s))
            cj = cj if present is None else {**cj, "present": present}
            out, _ = j_eval.sample_bsdf(cj, jnp.asarray(wo), jnp.asarray(rng), wl=jnp.zeros(B),
                                        u_wl=xs[-1])
            return sum(jnp.sum(out[k] * c[k]) for k in c)

        leaves = [torch.tensor(x, requires_grad=True) for x in x0]
        ct = t_eval.make_ctx(_with(st, "bsdfs", **dict(zip(fields, leaves))),
                             torch.as_tensor(bid), torch.as_tensor(uv), torch.as_tensor(n_s))
        ct = ct if present is None else {**ct, "present": present}
        out, _ = t_eval.sample_bsdf(ct, torch.as_tensor(wo), torch.as_tensor(rng.astype(np.int64)),
                                    wl=torch.zeros(B), u_wl=leaves[-1])
        loss = sum((out[k] * torch.as_tensor(c[k], dtype=torch.float32)).sum() for k in c)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        got += [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        want += jax.jit(jax.grad(f_j, argnums=tuple(range(len(x0)))))(*map(jnp.asarray, x0))
    return got, want


def _site_bounce(tracer):
    """The Russian roulette of one bounce after bounce 1: the survival
    probability reads the detached throughput (d / d the incoming
    throughput of cornell's camera rays; the volume path tracer on the
    medium cube)."""

    def run(_):
        if tracer == "pt":
            sj, cj, _ = j_ts.cornell_box(width=8, height=8)
        else:
            sj, cj = medium_cube(8)
        st, ct = _bridge(sj, cj)
        from cuda_pt_tpu.core import camera as j_cam
        from cuda_pt_tpu.core import qmc as j_qmc

        lane = jnp.arange(64, dtype=jnp.int32)
        o, d, rng = j_cam.generate_rays(cj, lane, j_qmc.make_state("pcg", 2, lane, 0))
        rs = np.random.default_rng(8)
        thp0 = rs.uniform(0.02, 0.6, (64, 3)).astype(np.float32)
        c_thp, c_l = rs.normal(size=(64, 3)), rs.normal(size=(64, 3))
        md_j, md_t = JMD(max_depth=4, max_volume=3), TMD(max_depth=4, max_volume=3)

        def f_j(thp):
            if tracer == "pt":
                s = j_pt.init_state(o, d, rng).replace(thp=thp, bounce=jnp.int32(1))
                out = j_pt.pt_bounce(sj, md_j, False, s)
            else:
                s = j_vpt.init_state(sj, o, d, rng).replace(thp=thp, bounce=jnp.int32(1))
                out = j_vpt.vpt_bounce(sj, md_j, False, s)
            return jnp.sum(out.thp * c_thp) + jnp.sum(out.L * c_l)

        thp = torch.tensor(thp0, requires_grad=True)
        args = [torch.tensor(np.asarray(x)) for x in (o, d)]
        rng_t = torch.as_tensor(np.asarray(rng).astype(np.int64))
        if tracer == "pt":
            s = dataclasses.replace(t_pt.init_state(*args, rng_t), thp=thp, bounce=1)
            out = t_pt.pt_bounce(st, md_t, s, use_bvh=False)
        else:
            s = dataclasses.replace(t_vpt.init_state(*args, rng_t), thp=thp, bounce=1)
            out = t_vpt.vpt_bounce(st, md_t, s, use_bvh=False)
        loss = (out.thp * torch.as_tensor(c_thp, dtype=torch.float32)).sum() + (
            out.L * torch.as_tensor(c_l, dtype=torch.float32)).sum()
        return torch.autograd.grad(loss, thp), [jax.jit(jax.grad(f_j))(jnp.asarray(thp0))]

    return run


def _site_light_tracer(_):
    """The light tracer's roulette reads the detached bounce weight and
    throughput: the port's reverse-mode gradient of a weighted image sum in
    the white walls' albedo against the reference's forward-mode
    derivative (jax.jvp; its while_loop has no reverse mode), cornell 8x8,
    max_depth 3."""
    sj, cj, _ = j_ts.cornell_box(width=8, height=8)
    st, ct = _bridge(sj, cj)
    c = np.random.default_rng(9).normal(size=(64, 3)).astype(np.float32)

    def f_j(a):
        kd = sj.bsdfs.k_d.at[0].set(jnp.stack([a, a, a]))
        img = j_lt.render_pass(sj.replace(bsdfs=sj.bsdfs.replace(k_d=kd)), cj, JMD(max_depth=3),
                               1, 0, False)
        return jnp.sum(img * c)

    _, tangent = jax.jit(lambda a: jax.jvp(f_j, (a,), (jnp.float32(1.0),)))(jnp.float32(0.73))
    a = torch.tensor(0.73, requires_grad=True)
    img = t_lt.render_pass(_with(st, "bsdfs", k_d=_set_row(st.bsdfs.k_d, 0, a)), ct,
                           TMD(max_depth=3), 1, 0, False)
    return torch.autograd.grad((img * torch.as_tensor(c)).sum(), a), [tangent]


SITES = {
    "homogeneous_sample_distance": _site_homogeneous,
    "grid_delta_tracking": _site_grid("sample_distance_grid"),
    "grid_ratio_tracking": _site_grid("transmittance_grid"),
    "grid_residual_tracking": _site_grid("transmittance_grid_residual"),
    "phase_sample": _site_phase,
    "sample_emitter": _site_emitter,
    "sample_bsdf": _site_bsdf,
    "pt_roulette": _site_bounce("pt"),
    "vpt_roulette": _site_bounce("vpt"),
    "light_tracer_roulette": _site_light_tracer,
}


@pytest.mark.parametrize("site", list(SITES))
def test_detach_site_gradient_matches_jax(site, scenes):  # noqa: F811
    got, want = SITES[site](scenes)
    assert len(got) == len(want)
    nonzero = False
    for g_t, g_j in zip(got, want):
        g_t, g_j = g_t.numpy(), np.asarray(g_j)
        assert np.isfinite(g_t).all(), site
        nonzero |= bool(np.abs(g_t).max() > 0.0)
        np.testing.assert_allclose(g_t, g_j, rtol=1e-3, atol=1e-4 * max(np.abs(g_j).max(), 0.01),
                                   err_msg=site)
    assert nonzero, site
