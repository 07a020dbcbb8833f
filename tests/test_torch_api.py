"""The Renderer's surface against the reference's: the constructor's
parameters (names, order, defaults), the samplers and options the port
does not draw from yet, and info()'s keys. No rendering beyond one small
pass, no JAX kernel call."""

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


@pytest.mark.parametrize("kw, item", [({"sampler": "sobol"}, "item 1"),
                                      ({"override_res": (8, 8)}, "item 5")])
def test_unported_options_raise_naming_their_item(kw, item):
    scene, cam, _ = t_ts.cornell_box(4, 4)
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
