"""The matmul-form brute force (cuda_pt_torch/ops/intersect_mxu.py,
traversal="mxu") against the JAX reference's ops/intersect_mxu.py.

Contracts: closest hit and occlusion against JAX's on a mixed triangle and
sphere cloud: hit flags equal on >= 99.5 % of rays, prim ids equal and t
within rtol 1e-5 where both hit; the port's chunk sizes and lane bands
bit-equal to each other; vertex gradients of sum(t) against jax.grad
within rtol 1e-3 / atol 1e-5 on the rays where both packages hit the same
prim (the mask built outside the graph); the Renderer's "mxu" image
against the port's brute force by the reference test's bounds (q99 of
the difference < 2e-2, mean < 1e-3); the global TF32 setting changes
nothing and is restored. One JAX trace: the gradient."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core.config import MaxDepthParams, RenderingConfig
from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.ops import intersect_mxu as t_mxu
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene.xml_parser import ParsedScene
from cuda_pt_tpu.ops import intersect_mxu as j_mxu
from cuda_pt_tpu.scene.builder import BSDFSpec, SceneBuilder
from test_torch_bridge import flatten_jax_scene

HIT_FRAC = 0.995


def _cloud(n_tris=150, n_sph=6, seed=3):
    """The reference test's mixed cloud (JAX builder), and the port's copy."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mat = b.add_bsdf(BSDFSpec())
    center = rng.uniform(-1, 1, size=(n_tris, 1, 3))
    b.add_mesh((center + rng.normal(scale=0.15, size=(n_tris, 3, 3))).astype(np.float32), mat)
    for _ in range(n_sph):
        b.add_sphere(rng.uniform(-1, 1, size=3), 0.2, mat)
    sj = b.compile()
    return sj, bridge.scene_from_numpy(flatten_jax_scene(sj))


def _rays(n=512, seed=11):
    """Origins outside the cloud, directions at it (numpy f32)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-12
    o = (2.5 * u).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, size=(n, 3)) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


T_FAR = 1.2


@pytest.fixture(scope="module")
def cloud():
    """The reference test's cloud (both packages') and rays."""
    sj, st = _cloud()
    o, d = _rays()
    return sj, st, o, d


def test_chunks_and_bands_bit_equal(cloud, monkeypatch):
    """The result does not depend on the chunk (a ray's first minimum, a
    strictly smaller t across chunks) nor on the lane band."""
    _, st, o, d = cloud
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    t_max = torch.full((len(o),), 3.0)
    t_far = torch.full((len(o),), T_FAR)
    whole = t_mxu.closest_hit_mxu(st.geom, o, d, t_max)
    occ = t_mxu.occlusion_mxu(st.geom, o, d, t_far)
    assert whole["hit"].any() and (whole["t"][whole["hit"]] < 3.0).all()
    runs = [(32, t_mxu.BAND_BYTES), (7, t_mxu.BAND_BYTES), (4096, 64 * 4 * 16 * 4096)]
    for chunk, band_bytes in runs:
        monkeypatch.setattr(t_mxu, "BAND_BYTES", band_bytes)
        got = t_mxu.closest_hit_mxu(st.geom, o, d, t_max, chunk=chunk)
        for k in whole:
            assert torch.equal(got[k], whole[k]), (chunk, k)
        assert torch.equal(t_mxu.occlusion_mxu(st.geom, o, d, t_far, chunk=chunk), occ)
    assert t_mxu.band_lanes(4096) == 64


def test_closest_and_occlusion_match_reference(cloud):
    """Against the reference run eagerly, op by op (a jitted one fuses its
    arithmetic and moves t by an ulp or two)."""
    sj, st, o, d = cloud
    want = j_mxu.closest_hit_mxu(sj.geom, jnp.asarray(o), jnp.asarray(d), chunk=4096)
    got = t_mxu.closest_hit_mxu(st.geom, torch.as_tensor(o), torch.as_tensor(d))
    hit_w, hit_g = np.asarray(want["hit"]), got["hit"].numpy()
    assert hit_w.mean() > 0.2 and (hit_w == hit_g).mean() >= HIT_FRAC
    both = hit_w & hit_g
    np.testing.assert_array_equal(got["prim"].numpy()[both], np.asarray(want["prim"])[both])
    np.testing.assert_allclose(got["t"].numpy()[both], np.asarray(want["t"])[both], rtol=1e-5)
    for k in ("b1", "b2"):
        np.testing.assert_allclose(got[k].numpy()[both], np.asarray(want[k])[both], rtol=1e-4,
                                   atol=1e-5)
    t_far = np.full(len(o), T_FAR, np.float32)
    occ_w = np.asarray(j_mxu.occlusion_mxu(sj.geom, jnp.asarray(o), jnp.asarray(d),
                                           jnp.asarray(t_far), chunk=4096))
    occ_g = t_mxu.occlusion_mxu(st.geom, torch.as_tensor(o), torch.as_tensor(d),
                                torch.as_tensor(t_far)).numpy()
    assert occ_w.any() and (occ_w == occ_g).mean() >= HIT_FRAC


def test_vertex_gradients_match_jax():
    """d sum(t) / d (p0, e1, e2) over the rays where both packages hit the
    same prim (the mask built outside the graph), 40 triangles and 2
    spheres, 128 rays; the sphere's safe square root keeps them finite.
    The reference's hits come out of its gradient call (one jitted trace,
    the file's one; called again from its cache only if its hits narrow
    the port's mask)."""
    sj, st = _cloud(n_tris=40, n_sph=2)
    o, d = _rays(128, seed=2)
    leaves = {k: getattr(st.geom, k).clone().requires_grad_(True) for k in ("p0", "e1", "e2")}
    out = t_mxu.closest_hit_mxu(dataclasses.replace(st.geom, **leaves), torch.as_tensor(o),
                                torch.as_tensor(d))

    def loss(p0, e1, e2, mask):
        r = j_mxu.closest_hit_mxu(sj.geom.replace(p0=p0, e1=e1, e2=e2), jnp.asarray(o),
                                  jnp.asarray(d))
        return jnp.sum(jnp.where(mask, r["t"], 0.0)), (r["hit"], r["prim"])

    grad_fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
    mask = out["hit"].numpy()
    while True:
        (_, (hit, prim)), want = grad_fn(sj.geom.p0, sj.geom.e1, sj.geom.e2, jnp.asarray(mask))
        both = mask & np.asarray(hit) & (out["prim"].numpy() == np.asarray(prim))
        if np.array_equal(both, mask):
            break
        mask = both
    assert mask.sum() >= 10
    torch.sum(torch.where(torch.as_tensor(mask), out["t"], 0.0)).backward()
    for k, w in zip(("p0", "e1", "e2"), want):
        grad = leaves[k].grad.numpy()
        assert np.isfinite(grad).all() and np.abs(grad).sum() > 0.0
        np.testing.assert_allclose(grad, np.asarray(w), rtol=1e-3, atol=1e-5, err_msg=k)


def test_walks_take_mxu_at_any_prim_count(cloud):
    """path_tracer routes "mxu" to the matmul form below the brute-force
    bound too, as the reference does, on live lanes only."""
    _, st, o, d = cloud
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    live = torch.ones(len(o), dtype=torch.bool)
    live[::4] = False
    sc = dataclasses.replace(st, traversal="mxu")
    want = t_mxu.closest_hit_mxu(st.geom, o, d)
    for use_bvh in (None, False, True):
        got = t_pt.closest_hit(sc, o, d, live, use_bvh)
        assert torch.equal(got["prim"][live], want["prim"][live])
        assert not got["hit"][~live].any()
    t_far = torch.full((len(o),), T_FAR)
    assert torch.equal(t_pt.occluded(sc, o, d, t_far, live)[live],
                       t_mxu.occlusion_mxu(st.geom, o, d, t_far)[live])


def test_tf32_setting_changes_nothing_and_is_restored(cloud):
    """TF32 allowed through either of torch's switches: the same hits, and
    the switch as it was after the call."""
    _, st, o, d = cloud
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    want = t_mxu.closest_hit_mxu(st.geom, o, d)
    m = torch.backends.cuda.matmul
    tf32 = m.allow_tf32
    try:
        m.allow_tf32 = True
        got = t_mxu.closest_hit_mxu(st.geom, o, d)
        assert m.allow_tf32
    finally:
        m.allow_tf32 = tf32
    for k in want:
        assert torch.equal(got[k], want[k])
    # a process that set the newer switch: reading allow_tf32 raises there,
    # so the block flips fp32_precision (a stand-in module; torch refuses
    # to mix the two switches in one process)

    class Newer:
        fp32_precision = "tf32"

        @property
        def allow_tf32(self):
            raise RuntimeError("mix of the legacy and new APIs")

    newer, seen = Newer(), []
    real = torch.matmul

    def spy(a, b):
        seen.append(newer.fp32_precision)
        return real(a, b)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.backends.cuda, "matmul", newer)
        mp.setattr(torch, "matmul", spy)
        got = t_mxu.closest_hit_mxu(st.geom, o, d)
    assert seen and set(seen) == {"ieee"} and newer.fp32_precision == "tf32"
    for k in want:
        assert torch.equal(got[k], want[k])


def test_renderer_mxu_matches_brute_force_image():
    """Renderer(traversal="mxu") against the composed brute force on the
    same streams (cornell, 32 prims): the reference test's bounds."""
    scene, cam, _ = t_ts.cornell_box(24, 24)
    ps = ParsedScene(scene, cam, RenderingConfig(width=24, height=24,
                                                 md=MaxDepthParams(max_depth=3), seed=4))
    r = Renderer(ps, traversal="mxu", device="cpu")
    assert (r.info()["traversal"], r.info()["driver"]) == ("mxu", "composed")
    img = r.render(2)
    ref = Renderer(ps, traversal="xla", device="cpu").render(2)  # brute force at 32 prims
    diff = np.abs(img - ref)
    assert np.quantile(diff, 0.99) < 2e-2, float(diff.max())
    assert abs(float(img.mean()) - float(ref.mean())) < 1e-3
