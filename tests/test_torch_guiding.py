"""Path guiding in the port (cuda_pt_torch/models/guiding.py and the
guide= plumbing of path_tracer.shade_stage and models/wavefront.py)
against the JAX reference, with the reference's guide carried over
(guiding.guide_from_numpy).

Contracts: lobe_params, vmf_pdf and vmf_sample within rtol 1e-5 / atol
1e-6; 50 fit steps from the same weights: the loss within 1e-4 relative,
the weights within rtol 1e-3 / atol 1e-5; collect_samples (8x8, 1 spp,
max_depth 2) per lane within rtol 1e-4 / atol 1e-5 on >= 95 % of lanes;
the guided wavefront against JAX's under the same per-lane contract, the
means within 1e-3; guide=None draws what the unguided wavefront draws
(each lane bit-equal to the composed tracer's); and a port-only copy of
the reference's test that a trained guide stays unbiased and lowers the
variance on the slot scene. Three JAX traces: fit's step, the collect
walk and the guided wavefront."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.core import camera as t_cam
from cuda_pt_torch.core import rng as t_rng
from cuda_pt_torch.core.config import MaxDepthParams
from cuda_pt_torch.models import guiding as t_g
from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.models import wavefront as t_wf
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import builder as t_builder
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_tpu.core import camera as j_cam
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.models import guiding as j_g
from cuda_pt_tpu.models import wavefront as j_wf
from cuda_pt_tpu.scene import builder as j_builder
from cuda_pt_tpu.scene import testscenes as j_ts
from test_torch_bridge import flatten_jax_camera, flatten_jax_scene

RTOL, ATOL = 1e-5, 1e-6
LANE_RTOL, LANE_ATOL, LANE_FRAC = 1e-4, 1e-5, 0.95


def slot_scene(ts, builder, cam_mod, size: int):
    """The reference's slot scene (tests/test_guiding.py::_slot_scene): a
    light seen from the floor only through a narrow slot, where guided
    scattering wins. Built with either package's builder."""
    b = builder.SceneBuilder()
    white = b.add_bsdf(builder.BSDFSpec(k_d=(0.75, 0.75, 0.75)))
    dark = b.add_bsdf(builder.BSDFSpec(k_d=(0, 0, 0)))
    em = b.add_emitter(builder.EmitterSpec(emission=(1, 1, 1), scaler=60.0))
    q = ts.quad
    b.add_mesh(q([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1]), white)
    b.add_mesh(q([-1, 1.6, -1], [1, 1.6, -1], [1, 1.6, 1], [-1, 1.6, 1]), dark, emitter_id=em)
    b.add_mesh(q([-1, 1.0, -1], [0.05, 1.0, -1], [0.05, 1.0, 1], [-1, 1.0, 1]), white)
    b.add_mesh(q([0.25, 1.0, -1], [1, 1.0, -1], [1, 1.0, 1], [0.25, 1.0, 1]), white)
    cam = cam_mod.make_camera((0, 0.7, -2.6), (0, 0.3, 0), fov=35, width=size, height=size)
    return b.compile(), cam


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def lane_match(got, want) -> float:
    """Share of lanes (rows) whose values all agree within the lane contract."""
    got, want = np.asarray(got).reshape(len(got), -1), np.asarray(want).reshape(len(want), -1)
    return float(np.isclose(got, want, rtol=LANE_RTOL, atol=LANE_ATOL).all(axis=1).mean())


@pytest.fixture(scope="module")
def slot():
    """The slot scene at 12x12 in both packages (the port's carried over
    from the reference's), and the reference's initial guide carried over."""
    sj, cj = slot_scene(j_ts, j_builder, j_cam, 12)
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    ct = bridge.camera_from_numpy(flatten_jax_camera(cj))
    gj = j_g.make_guide(sj, jax.random.PRNGKey(5))
    return sj, cj, st, ct, gj, t_g.guide_from_numpy(_np_tree(gj))


def test_guide_net_layout_and_init():
    """flax Dense's layout and init: weights (out, in) with the truncated
    LeCun normal's spread, zero biases; the same generator seed gives the
    same net; import of the module needs no JAX."""
    a = t_g.init_guide(torch.Generator().manual_seed(0))
    b = t_g.init_guide(torch.Generator().manual_seed(0))
    shapes = [tuple(lin.weight.shape) for lin in a.layers]
    assert shapes == [(32, 6), (32, 32), (5, 32)]
    for la, lb in zip(a.layers, b.layers):
        assert torch.equal(la.weight, lb.weight) and not la.bias.any()
        std = (1.0 / la.in_features) ** 0.5 / t_g._TRUNC_STD
        assert float(la.weight.detach().abs().max()) <= 2.0 * std
    big = t_g.GuideNet(256, torch.Generator().manual_seed(1)).layers[1].weight
    assert abs(float(big.detach().std()) - (1.0 / 256) ** 0.5) < 0.002


def test_lobe_and_vmf_match_reference(slot):
    sj, _, st, _, gj, gt = slot
    r = np.random.default_rng(4)
    B = 512
    p = r.uniform(-1, 1.6, size=(B, 3)).astype(np.float32)
    n = r.normal(size=(B, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = r.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    u2 = r.uniform(0, 1, size=(B, 2)).astype(np.float32)
    want = j_g.guide_lobe(gj, jnp.asarray(p), jnp.asarray(n))
    got = t_g.guide_lobe(gt, torch.as_tensor(p), torch.as_tensor(n))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    axis, kappa = want[0], want[1]
    ta, tk = torch.tensor(np.asarray(axis)), torch.tensor(np.asarray(kappa))
    np.testing.assert_allclose(t_g.vmf_pdf(ta, tk, torch.as_tensor(d)).numpy(),
                               np.asarray(j_g.vmf_pdf(axis, kappa, jnp.asarray(d))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_g.vmf_sample(ta, tk, torch.as_tensor(u2)).numpy(),
                               np.asarray(j_g.vmf_sample(axis, kappa, jnp.asarray(u2))),
                               rtol=RTOL, atol=ATOL)
    bp = r.uniform(0, 2, size=B).astype(np.float32)
    p_norm = (p - np.asarray(gj["lo"])) / np.asarray(gj["ext"])
    np.testing.assert_allclose(
        t_g.guided_mix_pdf(gt["net"], torch.as_tensor(p_norm), torch.as_tensor(n),
                           torch.as_tensor(bp), torch.as_tensor(d)).detach().numpy(),
        np.asarray(j_g.guided_mix_pdf(j_g._NET, gj["params"], jnp.asarray(p_norm),
                                      jnp.asarray(n), jnp.asarray(bp), jnp.asarray(d))),
        rtol=RTOL, atol=ATOL)


def test_fit_matches_reference(slot):
    """50 Adam steps on the same samples from the same weights: torch.optim
    .Adam against optax.adam."""
    _, _, _, _, gj, _ = slot
    r = np.random.default_rng(3)
    B = 256
    p = r.uniform(0, 1, size=(B, 3)).astype(np.float32)
    n = np.broadcast_to(np.float32([0, 0, 1]), (B, 3)).copy()
    bright = np.float32([0.6, 0.0, 0.8])
    d = r.normal(scale=0.15, size=(B, 3)).astype(np.float32) + bright
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lum = r.uniform(0, 2, size=B).astype(np.float32)
    params_j, loss_j = j_g.fit(j_g._NET, gj["params"], *map(jnp.asarray, (p, n, d, lum)),
                               steps=50)
    gt = t_g.guide_from_numpy(_np_tree(gj))
    net, loss_t = t_g.fit(gt["net"], *map(torch.as_tensor, (p, n, d, lum)), steps=50)
    assert abs(loss_t - loss_j) <= 1e-4 * abs(loss_j), (loss_t, loss_j)
    want = t_g.guide_from_numpy({**_np_tree(gj), "params": _np_tree(params_j)})["net"]
    for a, b in zip(net.parameters(), want.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-3,
                                   atol=1e-5)


def test_collect_samples_match_reference():
    """The training tuples at 8x8, 1 spp, max_depth 2, per lane."""
    sj, cj = slot_scene(j_ts, j_builder, j_cam, 8)
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    ct = bridge.camera_from_numpy(flatten_jax_camera(cj))
    # one jitted trace (its bounce loop inside)
    want = jax.jit(lambda s, c: j_g.collect_samples(s, c, JMD(max_depth=2), 11, False,
                                                    spp=1))(sj, cj)
    got = t_g.collect_samples(st, ct, MaxDepthParams(max_depth=2), 11, False, spp=1)
    for g, w in zip(got, want):
        assert g.shape == tuple(np.asarray(w).shape)
        assert lane_match(g.numpy(), w) >= LANE_FRAC
    assert float(got[3].sum()) > 0.0


def test_guided_wavefront_matches_reference(slot):
    """The wavefront with the carried guide, against JAX's, per pixel (one
    lane a pixel at 1 spp) and in the mean; guided lanes exist."""
    sj, cj, st, ct, gj, gt = slot
    want = np.asarray(jax.jit(lambda s, c, g: j_wf.render(
        s, c, JMD(max_depth=3), spp=1, seed=21, use_bvh=False, guide=g))(sj, cj, gj))
    got = t_wf.render(st, ct, MaxDepthParams(max_depth=3), spp=1, seed=21, guide=gt).numpy()
    assert lane_match(got.reshape(-1, 3), want.reshape(-1, 3)) >= LANE_FRAC
    assert abs(float(got.mean()) - float(want.mean())) < 1e-3
    unguided = t_wf.render(st, ct, MaxDepthParams(max_depth=3), spp=1, seed=21).numpy()
    assert not np.array_equal(got, unguided)


def test_unguided_wavefront_draws_as_before(slot):
    """guide=None: every lane of the wavefront pass is bit-equal to the
    composed tracer's on the same ray and stream (no extra draw, no other
    arithmetic), and the guide's draws shift the lanes it touches only."""
    _, _, st, ct, _, gt = slot
    md = MaxDepthParams(max_depth=3)
    lane = torch.arange(ct.width * ct.height)
    rng = t_rng.seed(9, lane)
    o, d, rng = t_cam.generate_rays(ct, lane, rng)
    L, pix = t_wf.trace_paths_wavefront(st, md, o, d, rng, guide=None)
    want = t_pt.trace_paths(st, md, o, d, rng)
    assert torch.equal(L, want[pix])
    Lg, pixg = t_wf.trace_paths_wavefront(st, md, o, d, rng, guide=gt)
    assert torch.isfinite(Lg).all() and not torch.equal(Lg, L)


def test_guided_wavefront_unbiased_and_lower_variance():
    """The reference's equal-spp test on the port alone: a guide trained on
    the slot scene agrees with the unguided estimator in expectation and
    lowers the seed-to-seed variance."""
    scene, cam = slot_scene(t_ts, t_builder, t_cam, 20)
    md = MaxDepthParams(max_depth=3)
    guide, loss = t_g.train_guide(scene, cam, md, seed=3, use_bvh=False, spp=6, steps=150)
    assert np.isfinite(loss)

    def stats(g, n_seeds=8, spp=6):
        imgs = np.stack([t_wf.render(scene, cam, md, spp=spp, seed=50 + s, guide=g).numpy()
                         for s in range(n_seeds)])
        return imgs.mean(), imgs.var(axis=0).mean()

    m_un, v_un = stats(None)
    m_g, v_g = stats(guide)
    assert abs(m_g - m_un) / max(m_un, 1e-6) < 0.15, (m_g, m_un)
    assert v_g < v_un, (v_g, v_un)
