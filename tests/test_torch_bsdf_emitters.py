"""Port BSDF (lambertian, specular, translucent) and emitter (area, point)
evaluation, sampling and pdfs against the JAX reference on random inputs
(rtol 1e-5), plus Fresnel terms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.bsdf import eval as t_eval
from cuda_pt_torch.bsdf import fresnel as t_fresnel
from cuda_pt_torch.emitters import emitters as t_em
from cuda_pt_torch.scene import bridge
from cuda_pt_tpu.bsdf import eval as j_eval
from cuda_pt_tpu.bsdf import fresnel as j_fresnel
from cuda_pt_tpu.emitters import emitters as j_em
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import types as JT
from cuda_pt_tpu.scene.builder import BSDFSpec, EmitterSpec, SceneBuilder
from test_torch_bridge import flatten_jax_scene

RTOL, ATOL = 1e-5, 1e-6
B = 512


@pytest.fixture(scope="module")
def scenes():
    """Three BSDF families, an area light (two quads) and a point light."""
    b = SceneBuilder()
    mats = [
        b.add_bsdf(BSDFSpec(k_d=(0.7, 0.5, 0.3))),
        b.add_bsdf(BSDFSpec(btype=JT.BSDF_SPECULAR, k_d=(0.9, 0.8, 0.7))),
        b.add_bsdf(BSDFSpec(btype=JT.BSDF_TRANSLUCENT, k_s=(0.98, 0.97, 0.96), ior=1.45)),
    ]
    area = b.add_emitter(EmitterSpec(etype=JT.EMITTER_AREA, emission=(1.0, 0.9, 0.8), scaler=7.0))
    b.add_emitter(EmitterSpec(etype=JT.EMITTER_POINT, emission=(0.5, 0.6, 0.7), scaler=3.0,
                              pos=(0.2, 1.5, 0.4)))
    b.add_mesh(np.concatenate([
        j_ts.quad([0.3, 2, 0.3], [0.3, 2, 0.7], [0.7, 2, 0.7], [0.7, 2, 0.3]),
        j_ts.quad([0.8, 2, 0.3], [0.8, 2, 0.4], [1.2, 2, 0.4], [1.2, 2, 0.3])]), mats[0],
        emitter_id=area)
    for i, m in enumerate(mats):
        b.add_mesh(j_ts.quad([i, 0, 0], [i + 1, 0, 0], [i + 1, 0, 1], [i, 0, 1]), m)
    sj = b.compile()
    return sj, bridge.scene_from_numpy(flatten_jax_scene(sj))


def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _ctx_pair(scenes, rs):
    sj, st = scenes
    bid = rs.integers(0, 3, B).astype(np.int32)
    n_s = _unit(rs, B)
    uv = rs.random((B, 2)).astype(np.float32)
    cj = j_eval.make_ctx(sj, jnp.asarray(bid), jnp.asarray(uv), jnp.asarray(n_s))
    ct = t_eval.make_ctx(st, torch.as_tensor(bid), torch.as_tensor(uv), torch.as_tensor(n_s))
    return cj, ct


def test_fresnel_terms():
    rs = np.random.default_rng(0)
    c = rs.random(B).astype(np.float32)
    eta = rs.uniform(0.5, 2.5, B).astype(np.float32)
    np.testing.assert_allclose(
        t_fresnel.fresnel_dielectric(torch.as_tensor(c), torch.as_tensor(eta)).numpy(),
        np.asarray(j_fresnel.fresnel_dielectric(jnp.asarray(c), jnp.asarray(eta))),
        rtol=RTOL, atol=ATOL)
    et, k = rs.uniform(0.1, 3, (2, B, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t_fresnel.fresnel_conductor(torch.as_tensor(c), torch.as_tensor(et),
                                    torch.as_tensor(k)).numpy(),
        np.asarray(j_fresnel.fresnel_conductor(jnp.asarray(c), jnp.asarray(et),
                                               jnp.asarray(k))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        t_fresnel.diffuse_fresnel(torch.as_tensor(eta)).numpy(),
        np.asarray(j_fresnel.diffuse_fresnel(jnp.asarray(eta))), rtol=RTOL, atol=ATOL)


def test_eval_bsdf_matches(scenes):
    rs = np.random.default_rng(1)
    cj, ct = _ctx_pair(scenes, rs)
    wo, wi = _unit(rs, B), _unit(rs, B)
    fj, pj = j_eval.eval_bsdf(cj, jnp.asarray(wo), jnp.asarray(wi))
    ft, pt_ = t_eval.eval_bsdf(ct, torch.as_tensor(wo), torch.as_tensor(wi))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pt_.numpy(), np.asarray(pj), rtol=RTOL, atol=ATOL)
    assert (np.asarray(fj) > 0).any()


def test_sample_bsdf_matches(scenes):
    rs = np.random.default_rng(2)
    cj, ct = _ctx_pair(scenes, rs)
    wo = _unit(rs, B)
    rng = rs.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)
    oj, rj = j_eval.sample_bsdf(cj, jnp.asarray(wo), jnp.asarray(rng))
    ot, rt = t_eval.sample_bsdf(ct, torch.as_tensor(wo), torch.as_tensor(rng.astype(np.int64)))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).astype(np.int64))
    for k in ("wi", "weight", "pdf"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k in ("is_delta", "lobe"):
        np.testing.assert_array_equal(ot[k].numpy(), np.asarray(oj[k]), err_msg=k)
    assert len(set(np.asarray(oj["lobe"]).tolist())) == 3  # every lobe drawn


def test_sample_emitter_matches(scenes):
    sj, st = scenes
    rs = np.random.default_rng(3)
    p = rs.uniform(0, 1.5, (B, 3)).astype(np.float32)
    n = _unit(rs, B)
    rng = rs.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)
    ej, rj = j_em.sample_emitter(sj, jnp.asarray(p), jnp.asarray(n), jnp.asarray(rng))
    et, rt = t_em.sample_emitter(st, torch.as_tensor(p), torch.as_tensor(n),
                                 torch.as_tensor(rng.astype(np.int64)))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).astype(np.int64))
    for k in ("dir", "dist", "le", "pdf"):
        np.testing.assert_allclose(et[k].numpy(), np.asarray(ej[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k in ("valid", "delta", "prim", "eid"):
        np.testing.assert_array_equal(et[k].numpy(), np.asarray(ej[k]), err_msg=k)
    assert np.asarray(ej["delta"]).any() and (~np.asarray(ej["delta"])).any()


def test_emitter_hit_terms_match(scenes):
    sj, st = scenes
    rs = np.random.default_rng(4)
    obj = rs.integers(0, 4, B).astype(np.int32)
    t = rs.uniform(0.1, 3, B).astype(np.float32)
    cos_l = rs.uniform(-0.2, 1, B).astype(np.float32)
    eid = np.asarray(sj.objects.emitter_id)[obj]
    lj = j_em.emitter_radiance_hit(sj, jnp.asarray(eid), jnp.zeros((B, 2)), jnp.asarray(cos_l))
    lt = t_em.emitter_radiance_hit(st, torch.as_tensor(eid).long(), torch.as_tensor(cos_l))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
    cc = np.maximum(cos_l, 1e-6)
    pj = j_em.hit_emitter_pdf(sj, jnp.asarray(obj), jnp.asarray(t), jnp.asarray(cc))
    pt_ = t_em.hit_emitter_pdf(st, torch.as_tensor(obj), torch.as_tensor(t), torch.as_tensor(cc))
    np.testing.assert_allclose(pt_.numpy(), np.asarray(pj), rtol=RTOL, atol=ATOL)


def test_unported_families_raise(scenes):
    sj, _ = scenes
    flat = flatten_jax_scene(sj)
    flat["bsdfs.btype"] = np.where(flat["bsdfs.btype"] == 0, JT.BSDF_PLASTIC, flat["bsdfs.btype"])
    flat.pop("present_bsdfs")
    st = bridge.scene_from_numpy(flat)
    with pytest.raises(NotImplementedError):
        t_eval.make_ctx(st, torch.zeros(2, dtype=torch.int64), torch.zeros(2, 2),
                        torch.zeros(2, 3))
