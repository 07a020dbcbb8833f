"""The Renderer's surface against the reference's: the constructor's
parameters (names, order, defaults), the options the port does not take
yet, info()'s keys, and sampler="sobol" on the kernel route (the hybrid
scheme's inputs bit for bit against JAX's). No rendering beyond a few
small passes, no JAX kernel call."""

import inspect

import numpy as np
import pytest

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core.config import MaxDepthParams, RendererType, RenderingConfig
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene.xml_parser import ParsedScene
from cuda_pt_tpu import api as j_api
from cuda_pt_tpu.models import path_tracer as j_pt


def _parsed(scene, cam, md=None):
    return ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height,
                                                   md=md or MaxDepthParams(max_depth=2)))


def _params(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


def test_renderer_signature_is_the_reference_s():
    """The port's parameters, less the trailing device, are the reference's
    in name, order and default."""
    port = _params(Renderer.__init__)
    assert port[-1] == ("device", None)
    assert port[:-1] == _params(j_api.Renderer.__init__)


def test_positional_call_in_the_reference_order():
    """Renderer(parsed, MEGAKERNEL_PT, 0, None, None, "pcg", 1, None) builds
    the Renderer of the keyword call, and one pass renders the same image."""
    scene, cam, _ = t_ts.cornell_box(6, 6)
    pos = Renderer(_parsed(scene, cam), RendererType.MEGAKERNEL_PT, 0, None, None, "pcg", 1,
                   None, device="cpu")
    kw = Renderer(_parsed(scene, cam), renderer=RendererType.MEGAKERNEL_PT, seed_offset=0,
                  traversal=None, sampler="pcg", nee_candidates=1, max_lanes_per_call=None,
                  device="cpu")
    assert pos.info() == kw.info()
    assert pos.max_lanes_per_call == kw.max_lanes_per_call
    np.testing.assert_array_equal(pos.render(1), kw.render(1))


@pytest.mark.parametrize("kw, item", [({"override_res": (8, 8)}, "item 6"),
                                      ({"traversal": "mxu"}, "item 13")])
def test_unported_options_raise_naming_their_item(kw, item):
    """An option still to port raises naming its ROADMAP item; item 6's
    override_res is ported (the XML parser applies it) and, as in the
    reference, a ParsedScene source ignores it."""
    scene, cam, _ = t_ts.cornell_box(4, 4)
    if item == "item 6":
        r = Renderer(_parsed(scene, cam), device="cpu", **kw)
        assert (r.camera.width, r.camera.height) == (4, 4)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        Renderer(_parsed(scene, cam), device="cpu", **kw)


def test_unknown_sampler_raises_at_construction():
    scene, cam, _ = t_ts.cornell_box(4, 4)
    with pytest.raises(NotImplementedError, match="'halton'"):
        Renderer(_parsed(scene, cam), sampler="halton", device="cpu")


def _over_brute_force():
    """cornell_box with three more boxes: 68 triangles, past the brute-force
    limit of 64."""
    _, cam, b = t_ts.cornell_box(4, 4)
    for k in range(3):
        x = 0.1 + 0.25 * k
        b.add_mesh(t_ts._box_mesh([x, 0.7, 0.1], [x + 0.1, 0.8, 0.2]), 0)
    return b.compile(), cam


@pytest.mark.parametrize("make", [lambda: t_ts.cornell_box(4, 4)[:2], _over_brute_force],
                         ids=["cornell_32", "boxes_68"])
def test_info_use_bvh_follows_the_reference_rule(make):
    """info()["use_bvh"] is num_prims > the reference's BRUTE_FORCE_MAX_PRIMS;
    info()["sampler"] is the argument."""
    scene, cam = make()
    info = Renderer(_parsed(scene, cam), sampler="pcg", device="cpu").info()
    assert info["use_bvh"] == (info["num_prims"] > j_pt.BRUTE_FORCE_MAX_PRIMS)
    assert info["use_bvh"] == (info["num_prims"] == 68)
    assert info["sampler"] == "pcg"


# ---------------------------------------------------------------------------
# sampler="sobol" on every route
# ---------------------------------------------------------------------------


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def test_sobol_kernel_route_runs_the_hybrid_scheme():
    """Renderer(sampler="sobol") on the CPU's kernel route: the Sobol state
    of the Z-order lanes, its jitter draw and the pcg streams seeded
    seed ^ 0x9E3779B9 equal JAX's bit for bit (the rays to the camera's
    ulps, tests/test_torch_core.py); the pass is K2's plain version on
    those inputs, and a banded pass equals it bit for bit."""
    import jax
    import jax.numpy as jnp
    import torch

    from cuda_pt_torch.core import qmc as t_qmc
    from cuda_pt_torch.core import rng as t_rng
    from cuda_pt_torch.ops import megakernel as t_mk
    from cuda_pt_torch.scene import bridge
    from cuda_pt_tpu.core import camera as j_cam
    from cuda_pt_tpu.core import qmc as j_qmc
    from cuda_pt_tpu.core import rng as j_rng
    from cuda_pt_tpu.ops.pallas import megakernel as j_mk
    from cuda_pt_tpu.scene import testscenes as j_ts
    from test_torch_bridge import flatten_jax_camera, flatten_jax_scene

    sj, cj, _ = j_ts.cornell_box(8, 8)
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    ct = bridge.camera_from_numpy(flatten_jax_camera(cj))
    md = MaxDepthParams(max_depth=3)
    parsed = ParsedScene(st, ct, RenderingConfig(width=8, height=8, md=md, seed=5))
    r = Renderer(parsed, sampler="sobol", device="cpu")
    info = r.info()
    assert (info["sampler"], info["traversal"], info["driver"]) == ("sobol", "fused", "whole_path")
    perm_j, _ = j_mk.tile_swizzle(8, 8)
    perm, inv = t_mk.tile_swizzle(8, 8)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))

    @jax.jit
    def hybrid_j(idx):  # the reference's api.py:176-181, one compile
        rs = j_qmc.make_state("sobol", 5, perm_j, idx)
        o, d, _ = j_cam.generate_rays(cj, perm_j, rs)
        pcg = j_qmc.make_state("pcg", jnp.uint32(5) ^ jnp.uint32(0x9E3779B9), perm_j, idx)
        return rs, j_rng.next2d(rs)[0], o, d, pcg

    for idx in (0, 3):
        rs_j, u_j, oj, dj, pcg_j = hybrid_j(idx)
        rs_t = t_qmc.make_state("sobol", 5, perm, idx)
        np.testing.assert_array_equal(rs_t.numpy(), np.asarray(rs_j).astype(np.int64))
        np.testing.assert_array_equal(t_rng.next2d(rs_t)[0].numpy(), np.asarray(u_j))
        o, d, rng = r._hybrid_rays(perm, idx)
        np.testing.assert_array_equal(rng.numpy(), np.asarray(pcg_j).astype(np.int64))
        assert _ulps(o.numpy(), np.asarray(oj)).max() <= 1
        assert _ulps(d.numpy(), np.asarray(dj)).max() <= 2
    o, d, rng = r._hybrid_rays(perm, 0)
    want = t_mk.trace_megakernel_reference(r._pack, md, o, d, rng)[inv].reshape(8, 8, 3)
    assert torch.equal(r.render_raw(), want)
    banded = Renderer(parsed, sampler="sobol", max_lanes_per_call=24, device="cpu")
    assert torch.equal(banded.render_raw(), want)
    with pytest.raises(ValueError, match="rng"):  # a Sobol state never reaches the kernels
        t_mk.trace_megakernel(r._pack, md, o.to("meta"), d.to("meta"),
                              t_qmc.make_state("sobol", 5, perm, 0).to("meta"))


@pytest.mark.parametrize("rtype", ["pt_xla", "wavefront", "vpt_composed", "vpt_fused"])
def test_sobol_on_every_family_route(rtype):
    """The composed routes pass the sampler through: each pass equals its
    model's Sobol pass; the volume kernel route renders the hybrid."""
    import torch

    from cuda_pt_torch.models import path_tracer as t_pt
    from cuda_pt_torch.models import volume_pt as t_vpt
    from cuda_pt_torch.models import wavefront as t_wf

    md = MaxDepthParams(max_depth=3)
    if rtype.startswith("vpt"):
        scene, cam, _ = t_ts.cornell_vpt(6, 6)
        kw = {"renderer": RendererType.VOLUME_PT}
        kw.update({"traversal": "xla"} if rtype == "vpt_composed" else {})
    else:
        scene, cam, _ = t_ts.cornell_box(6, 6)
        kw = ({"traversal": "xla"} if rtype == "pt_xla"
              else {"renderer": RendererType.WAVEFRONT_PT})
    r = Renderer(_parsed(scene, cam, md), sampler="sobol", device="cpu", **kw)
    img = r.render_raw()
    if rtype == "pt_xla":
        want = t_pt.render_sample(r.scene, r.camera, md, 0, 0, sampler="sobol")
    elif rtype == "wavefront":
        want = t_wf.render_sample(r.scene, r.camera, md, 0, 0, compact=True, sampler="sobol")
    elif rtype == "vpt_composed":
        want = t_vpt.render(r.scene, r.camera, md, 1, seed=0, sampler="sobol")
    else:
        assert r.info()["traversal"] == "fused"
        want = img
    assert torch.equal(img, want) and bool(torch.isfinite(img).all())
    assert not torch.equal(img, Renderer(_parsed(scene, cam, md), device="cpu", **kw).render_raw())
