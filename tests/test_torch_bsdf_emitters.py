"""Port BSDFs (all ten families, textured slots), emitters (area, point,
area-spot, envmap; NEE and the light tracer's emission sampling), Fresnel, GGX, spectral and texture functions against
the JAX reference on random inputs (rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.bsdf import eval as t_eval
from cuda_pt_torch.bsdf import fresnel as t_fresnel
from cuda_pt_torch.bsdf import ggx as t_ggx
from cuda_pt_torch.bsdf import spectral as t_spectral
from cuda_pt_torch.emitters import emitters as t_em
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import textures as t_tex
from cuda_pt_tpu.bsdf import eval as j_eval
from cuda_pt_tpu.bsdf import fresnel as j_fresnel
from cuda_pt_tpu.bsdf import ggx as j_ggx
from cuda_pt_tpu.bsdf import spectral as j_spectral
from cuda_pt_tpu.core import rng as j_rng
from cuda_pt_tpu.emitters import emitters as j_em
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import textures as j_tex
from cuda_pt_tpu.scene import types as JT
from cuda_pt_tpu.scene.builder import BSDFSpec, EmitterSpec, SceneBuilder
from test_torch_bridge import flatten_jax_scene

RTOL, ATOL = 1e-5, 1e-6
B = 512
FAMILIES = {
    "lambertian": JT.BSDF_LAMBERTIAN, "specular": JT.BSDF_SPECULAR,
    "translucent": JT.BSDF_TRANSLUCENT, "plastic": JT.BSDF_PLASTIC,
    "plastic_forward": JT.BSDF_PLASTIC_FORWARD, "ggx_conductor": JT.BSDF_GGX_CONDUCTOR,
    "dispersion": JT.BSDF_DISPERSION, "forward": JT.BSDF_FORWARD,
    "ggx_dielectric": JT.BSDF_GGX_DIELECTRIC, "oren_nayar": JT.BSDF_OREN_NAYAR,
}


def _close(got, want, what=""):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got, np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def scenes():
    """One material per family (textured diffuse, specular, glossy, normal
    and roughness slots among them), area, point and area-spot lights and
    a textured envmap with importance tables."""
    b = SceneBuilder()
    checker = b.add_texture(j_ts._checker_texture(n=16, tiles=4))
    noise = b.add_texture(j_ts._noise_texture(n=16))
    sky = b.add_texture(j_ts._sky_hdr(h=16, w=32, sun_lum=4.0))
    specs = {
        JT.BSDF_LAMBERTIAN: dict(k_d=(0.7, 0.5, 0.3), tex_ids=(checker, -1, -1, -1, -1)),
        JT.BSDF_SPECULAR: dict(k_d=(0.9, 0.8, 0.7)),
        JT.BSDF_TRANSLUCENT: dict(k_s=(0.98, 0.97, 0.96), ior=1.45),
        JT.BSDF_PLASTIC: dict(k_d=(0.1, 0.3, 0.65), k_s=(1.0, 0.9, 0.8), ior=1.5,
                              thickness=0.2, k=(0.3, 0.2, 0.1),
                              tex_ids=(-1, noise, -1, checker, -1)),
        JT.BSDF_PLASTIC_FORWARD: dict(k_d=(0.4, 0.5, 0.6), k_s=(0.9, 0.9, 0.9), ior=1.4),
        JT.BSDF_GGX_CONDUCTOR: dict(eta=(0.143, 0.375, 1.444), k=(3.983, 2.386, 1.603),
                                    roughness_x=0.3, roughness_y=0.15,
                                    tex_ids=(-1, -1, noise, -1, noise)),
        JT.BSDF_DISPERSION: dict(k_s=(0.99, 0.98, 0.97), cauchy_a=1.5046, cauchy_b=0.0042),
        JT.BSDF_FORWARD: dict(),
        JT.BSDF_GGX_DIELECTRIC: dict(k_s=(0.95, 0.95, 0.95), ior=1.5, roughness_x=0.25,
                                     roughness_y=0.35),
        JT.BSDF_OREN_NAYAR: dict(k_d=(0.6, 0.5, 0.4), roughness_x=0.5),
    }
    mats = {bt: b.add_bsdf(BSDFSpec(btype=bt, **kw)) for bt, kw in specs.items()}
    area = b.add_emitter(EmitterSpec(etype=JT.EMITTER_AREA, emission=(1.0, 0.9, 0.8), scaler=7.0))
    b.add_emitter(EmitterSpec(etype=JT.EMITTER_POINT, emission=(0.5, 0.6, 0.7), scaler=3.0,
                              pos=(0.2, 1.5, 0.4)))
    spot = b.add_emitter(EmitterSpec(etype=JT.EMITTER_AREA_SPOT, emission=(1, 1, 1), scaler=9.0,
                                     extra=(0.7, 0.0, 0.0, 0.0)))
    b.add_emitter(EmitterSpec(etype=JT.EMITTER_ENVMAP, emission=(1, 1, 1), scaler=1.0,
                              tex_id=sky, extra=(1.0, 0.4, 0.1, 0.0)))
    b.add_mesh(np.concatenate([
        j_ts.quad([0.3, 2, 0.3], [0.3, 2, 0.7], [0.7, 2, 0.7], [0.7, 2, 0.3]),
        j_ts.quad([0.8, 2, 0.3], [0.8, 2, 0.4], [1.2, 2, 0.4], [1.2, 2, 0.3])]), mats[0],
        emitter_id=area)
    b.add_mesh(j_ts.quad([-0.3, 1.6, -0.3], [-0.3, 1.6, 0.3], [0.3, 1.6, 0.3],
                         [0.3, 1.6, -0.3]), mats[0], emitter_id=spot)
    uv = np.array([[[0, 0], [3, 0], [3, 3]], [[0, 0], [3, 3], [0, 3]]], np.float32)
    for i, m in enumerate(mats.values()):
        b.add_mesh(j_ts.quad([i, 0, 0], [i + 1, 0, 0], [i + 1, 0, 1], [i, 0, 1]), m, uv=uv)
    sj = b.compile()
    return sj, bridge.scene_from_numpy(flatten_jax_scene(sj)), mats


def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _ctx_pair(scenes, rs, family):
    sj, st, mats = scenes
    bid = np.full(B, mats[family], np.int32)
    n_s = _unit(rs, B)
    uv = rs.uniform(-1.5, 2.5, (B, 2)).astype(np.float32)
    cj = j_eval.make_ctx(sj, jnp.asarray(bid), jnp.asarray(uv), jnp.asarray(n_s))
    ct = t_eval.make_ctx(st, torch.as_tensor(bid), torch.as_tensor(uv), torch.as_tensor(n_s))
    return cj, ct


def test_fresnel_terms():
    rs = np.random.default_rng(0)
    c = rs.random(B).astype(np.float32)
    eta = rs.uniform(0.5, 2.5, B).astype(np.float32)
    _close(t_fresnel.fresnel_dielectric(torch.as_tensor(c), torch.as_tensor(eta)),
           j_fresnel.fresnel_dielectric(jnp.asarray(c), jnp.asarray(eta)))
    et, k = rs.uniform(0.1, 3, (2, B, 3)).astype(np.float32)
    _close(t_fresnel.fresnel_conductor(torch.as_tensor(c), torch.as_tensor(et), torch.as_tensor(k)),
           j_fresnel.fresnel_conductor(jnp.asarray(c), jnp.asarray(et), jnp.asarray(k)))
    _close(t_fresnel.diffuse_fresnel(torch.as_tensor(eta)),
           j_fresnel.diffuse_fresnel(jnp.asarray(eta)))


def test_ggx_functions():
    rs = np.random.default_rng(10)
    wo = _unit(rs, B)
    wo[:, 2] = np.abs(wo[:, 2]) + 1e-3
    wi, h = _unit(rs, B), _unit(rs, B)
    ax, ay = rs.uniform(0.02, 0.9, (2, B)).astype(np.float32)
    u = rs.random((B, 2)).astype(np.float32)
    T, J = torch.as_tensor, jnp.asarray
    _close(t_ggx.ndf(T(h), T(ax), T(ay)), j_ggx.ndf(J(h), J(ax), J(ay)), "ndf")
    _close(t_ggx.g1(T(wo), T(ax), T(ay)), j_ggx.g1(J(wo), J(ax), J(ay)), "g1")
    _close(t_ggx.g2(T(wo), T(wi), T(ax), T(ay)), j_ggx.g2(J(wo), J(wi), J(ax), J(ay)), "g2")
    hs_t = t_ggx.sample_vndf(T(wo), T(ax), T(ay), T(u))
    hs_j = j_ggx.sample_vndf(J(wo), J(ax), J(ay), J(u))
    _close(hs_t, hs_j, "sample_vndf")
    _close(t_ggx.vndf_pdf(T(wo), hs_t, T(ax), T(ay)), j_ggx.vndf_pdf(J(wo), hs_j, J(ax), J(ay)),
           "vndf_pdf")


def test_spectral_fit():
    wl = np.random.default_rng(11).uniform(360.0, 830.0, B).astype(np.float32)
    for a, b in zip(t_spectral.xyz_fit(torch.as_tensor(wl)), j_spectral.xyz_fit(jnp.asarray(wl))):
        _close(a, b, "xyz_fit")
    _close(t_spectral.wavelength_to_rgb(torch.as_tensor(wl)),
           j_spectral.wavelength_to_rgb(jnp.asarray(wl)), "wavelength_to_rgb")
    np.testing.assert_allclose(t_spectral.NORM, j_spectral._NORM, rtol=RTOL)


def test_texture_lookups(scenes):
    sj, st, _ = scenes
    rs = np.random.default_rng(12)
    tid = rs.integers(-1, 3, B).astype(np.int32)
    uv = rs.uniform(-2.0, 3.0, (B, 2)).astype(np.float32)
    n_s = _unit(rs, B)
    base = rs.random((B, 3)).astype(np.float32)
    T, J = torch.as_tensor, jnp.asarray
    _close(t_tex.sample_texture(st.textures, T(tid), T(uv)),
           j_tex.sample_texture(sj.textures, J(tid), J(uv)), "sample_texture")
    _close(t_tex.scaled_rgb(st.textures, T(tid), T(uv), T(base)),
           j_tex.scaled_rgb(sj.textures, J(tid), J(uv), J(base)), "scaled_rgb")
    _close(t_tex.eval_normal_map(st.textures, T(tid), T(uv), T(n_s)),
           j_tex.eval_normal_map(sj.textures, J(tid), J(uv), J(n_s)), "eval_normal_map")


def test_make_ctx_texture_slots(scenes):
    """Diffuse, specular, glossy, normal-map and roughness slots."""
    sj, st, _ = scenes
    rs = np.random.default_rng(13)
    bid = rs.integers(0, len(FAMILIES), B).astype(np.int32)
    uv = rs.uniform(-1.0, 2.0, (B, 2)).astype(np.float32)
    n_s = _unit(rs, B)
    cj = j_eval.make_ctx(sj, jnp.asarray(bid), jnp.asarray(uv), jnp.asarray(n_s))
    ct = t_eval.make_ctx(st, torch.as_tensor(bid), torch.as_tensor(uv), torch.as_tensor(n_s))
    for k in ("kd", "ks", "kg", "eta", "k", "ior", "ax", "ay", "thickness", "cauchy_a",
              "cauchy_b", "n"):
        _close(ct[k], cj[k], k)
    np.testing.assert_array_equal(ct["btype"].numpy(), np.asarray(cj["btype"]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_eval_bsdf_matches(scenes, family):
    rs = np.random.default_rng(1 + FAMILIES[family])
    cj, ct = _ctx_pair(scenes, rs, FAMILIES[family])
    wo, wi = _unit(rs, B), _unit(rs, B)
    fj, pj = j_eval.eval_bsdf(cj, jnp.asarray(wo), jnp.asarray(wi))
    ft, pt_ = t_eval.eval_bsdf(ct, torch.as_tensor(wo), torch.as_tensor(wi))
    _close(ft, fj, "f")
    _close(pt_, pj, "pdf")
    smooth = FAMILIES[family] in (JT.BSDF_LAMBERTIAN, JT.BSDF_PLASTIC, JT.BSDF_GGX_CONDUCTOR,
                                  JT.BSDF_GGX_DIELECTRIC, JT.BSDF_OREN_NAYAR)
    assert (np.asarray(fj) > 0).any() == smooth


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sample_bsdf_matches(scenes, family):
    rs = np.random.default_rng(20 + FAMILIES[family])
    cj, ct = _ctx_pair(scenes, rs, FAMILIES[family])
    wo = _unit(rs, B)
    rng = rs.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)
    # half the paths already carry a locked wavelength
    wl = np.where(rs.random(B) < 0.5, 0.0, rs.uniform(400, 700, B)).astype(np.float32)
    oj, rj = j_eval.sample_bsdf(cj, jnp.asarray(wo), jnp.asarray(rng), wl=jnp.asarray(wl))
    ot, rt = t_eval.sample_bsdf(ct, torch.as_tensor(wo), torch.as_tensor(rng.astype(np.int64)),
                                wl=torch.as_tensor(wl))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).astype(np.int64))
    for k in ("wi", "weight", "pdf", "wl"):
        _close(ot[k], oj[k], k)
    for k in ("is_delta", "lobe"):
        np.testing.assert_array_equal(ot[k].numpy(), np.asarray(oj[k]), err_msg=k)


def test_sample_bsdf_wavelength_stratum(scenes):
    """A caller-given wavelength uniform replaces the drawn one."""
    rs = np.random.default_rng(30)
    cj, ct = _ctx_pair(scenes, rs, JT.BSDF_DISPERSION)
    wo = _unit(rs, B)
    rng = rs.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)
    u_wl = rs.random(B).astype(np.float32)
    oj, _ = j_eval.sample_bsdf(cj, jnp.asarray(wo), jnp.asarray(rng), u_wl=jnp.asarray(u_wl))
    ot, _ = t_eval.sample_bsdf(ct, torch.as_tensor(wo), torch.as_tensor(rng.astype(np.int64)),
                               u_wl=torch.as_tensor(u_wl))
    for k in ("wi", "weight", "wl"):
        _close(ot[k], oj[k], k)


def test_sample_emitter_matches(scenes):
    """Area, area-spot (cone gate), point and envmap (importance tables)."""
    sj, st, _ = scenes
    rs = np.random.default_rng(3)
    p = rs.uniform(-0.5, 1.5, (B, 3)).astype(np.float32)
    n = _unit(rs, B)
    rng = rs.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)
    ej, rj = j_em.sample_emitter(sj, jnp.asarray(p), jnp.asarray(n), jnp.asarray(rng))
    et, rt = t_em.sample_emitter(st, torch.as_tensor(p), torch.as_tensor(n),
                                 torch.as_tensor(rng.astype(np.int64)))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).astype(np.int64))
    for k in ("dir", "dist", "le", "pdf"):
        _close(et[k], ej[k], k)
    for k in ("valid", "delta", "prim", "eid"):
        np.testing.assert_array_equal(et[k].numpy(), np.asarray(ej[k]), err_msg=k)
    etype = np.asarray(sj.emitters.etype)[np.asarray(ej["eid"])]
    assert {int(x) for x in etype} == {JT.EMITTER_AREA, JT.EMITTER_POINT, JT.EMITTER_AREA_SPOT,
                                      JT.EMITTER_ENVMAP}
    spot = etype == JT.EMITTER_AREA_SPOT
    assert (np.asarray(ej["le"])[spot].max(-1) == 0).any()  # some samples outside the cone


def test_sample_le_matches(scenes):
    """The light tracer's emission sampling: area, area-spot (cone gate)
    and point draws; the envmap's draws are invalid."""
    sj, st, _ = scenes
    rs = np.random.default_rng(5)
    rng = rs.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)
    ej, rj = j_em.sample_le(sj, jnp.asarray(rng), B)
    et, rt = t_em.sample_le(st, torch.as_tensor(rng.astype(np.int64)), B)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).astype(np.int64))
    for k in ("pos", "dir", "n", "thp0", "thp_pos", "cos_gate"):
        _close(et[k], ej[k], k)
    for k in ("valid", "is_point"):
        np.testing.assert_array_equal(et[k].numpy(), np.asarray(ej[k]), err_msg=k)
    # the emitter each draw picked, from the reference's own pick
    u_sel = np.asarray(j_rng.next1d(jnp.asarray(rng))[0])
    eid = np.clip((np.asarray(sj.emitters.sel_cdf)[None, :] < u_sel[:, None]).sum(-1), 1,
                  int(sj.emitters.etype.shape[0]) - 1)
    etype = np.asarray(sj.emitters.etype)[eid]
    assert {JT.EMITTER_AREA, JT.EMITTER_POINT, JT.EMITTER_AREA_SPOT} <= {int(x) for x in etype}
    np.testing.assert_array_equal(np.asarray(ej["valid"]), etype != JT.EMITTER_ENVMAP)
    spot = etype == JT.EMITTER_AREA_SPOT
    thp0 = np.asarray(ej["thp0"])
    assert (thp0[spot].max(-1) == 0).any() and (thp0[spot].max(-1) > 0).any()


def test_emitter_hit_terms_match(scenes):
    sj, st, _ = scenes
    rs = np.random.default_rng(4)
    n_obj = int(np.asarray(sj.objects.emitter_id).shape[0])
    obj = rs.integers(0, n_obj, B).astype(np.int32)
    t = rs.uniform(0.1, 3, B).astype(np.float32)
    cos_l = rs.uniform(-0.2, 1, B).astype(np.float32)
    uv = rs.random((B, 2)).astype(np.float32)
    eid = np.asarray(sj.objects.emitter_id)[obj]
    lj = j_em.emitter_radiance_hit(sj, jnp.asarray(eid), jnp.asarray(uv), jnp.asarray(cos_l))
    lt = t_em.emitter_radiance_hit(st, torch.as_tensor(eid).long(), torch.as_tensor(uv),
                                   torch.as_tensor(cos_l))
    _close(lt, lj, "emitter_radiance_hit")
    cc = np.maximum(cos_l, 1e-6)
    pj = j_em.hit_emitter_pdf(sj, jnp.asarray(obj), jnp.asarray(t), jnp.asarray(cc))
    pt_ = t_em.hit_emitter_pdf(st, torch.as_tensor(obj), torch.as_tensor(t), torch.as_tensor(cc))
    _close(pt_, pj, "hit_emitter_pdf")


@pytest.mark.parametrize("which", ["importance", "cosine"])
def test_env_terms_match(scenes, which):
    """env_radiance and env_nee_pdf with importance tables (textured sky)
    and with the cosine fallback (untextured furnace envmap)."""
    if which == "importance":
        sj, st, _ = scenes
    else:
        sj = j_ts.furnace(4, 4)[0]
        st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    rs = np.random.default_rng(5)
    d, n = _unit(rs, B), _unit(rs, B)
    _close(t_em.env_radiance(st, torch.as_tensor(d)), j_em.env_radiance(sj, jnp.asarray(d)),
           "env_radiance")
    _close(t_em.env_nee_pdf(st, torch.as_tensor(n), torch.as_tensor(d)),
           j_em.env_nee_pdf(sj, jnp.asarray(n), jnp.asarray(d)), "env_nee_pdf")
