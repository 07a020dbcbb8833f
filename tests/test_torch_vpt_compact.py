"""The volume path tracer's live-lane compaction (models/volume_pt.py,
compact=True) and the ray counters (path_tracer.count_rays,
volume_pt.count_rays: the per-lane ``rays`` field of both states) against
the JAX reference on the CPU.

Compaction against the reference's compacted render: per lane allclose
(rtol 1e-4, atol 1e-5) on >= 95 % of pixels and means within 1e-3
relative, tighter than the reference's own hold of compacted against
uncompacted (tests/test_renderers.py: 93 % at atol 1e-4, means within
0.02). Against the port's uncompacted render the image is bit-equal (0
differing pixels): each lane keeps its stream. Ray counts are equal as
integers."""

import numpy as np
import pytest
import torch

from cuda_pt_torch.core.config import MaxDepthParams as TMD
from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.models import volume_pt as t_vpt
from cuda_pt_torch.models import wavefront as t_wf
from cuda_pt_torch.scene import bridge
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.models import path_tracer as j_pt
from cuda_pt_tpu.models import volume_pt as j_vpt
from cuda_pt_tpu.scene import testscenes as j_ts
from test_torch_bridge import flatten_jax_camera, flatten_jax_scene
from test_torch_vpt import j_nested_media

W, SPP, SEED = 16, 2, 9


def _port(sj, cj):
    return (bridge.scene_from_numpy(flatten_jax_scene(sj)),
            bridge.camera_from_numpy(flatten_jax_camera(cj)))


@pytest.fixture(scope="module")
def nested():
    """Media nested two deep behind glass, 16x16: 256 lanes, so the ladder
    has a 128-lane rung."""
    sj, cj = j_nested_media(W)
    return sj, cj, *_port(sj, cj)


def test_compacted_render_matches_jax(nested):
    sj, cj, st, ct = nested
    md_j, md_t = JMD(max_depth=6, max_volume=5), TMD(max_depth=6, max_volume=5)
    assert t_wf.compact_sizes(W * W) == [256, 128]
    want = np.asarray(j_vpt.render(sj, cj, md_j, SPP, seed=SEED, use_bvh=False, compact=True))
    got = t_vpt.render(st, ct, md_t, SPP, seed=SEED, compact=True).numpy()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert want.mean() > 0.01 and close.mean() >= 0.95, close.mean()
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean(), (got.mean(), want.mean())


@pytest.mark.parametrize("kind", ["nested", "grid"])
def test_compacted_render_equals_uncompacted(nested, kind):
    """Compaction reorganises the lanes only: 0 pixels differ from the
    uncompacted render, bit for bit, media nested behind glass or a grid
    (whose tracking draws advance every lane of the live prefix)."""
    if kind == "nested":
        st, ct = nested[2:]
    else:
        st, ct = _port(*j_ts.grid_smoke(width=W, height=W, n=8)[:2])
    md = TMD(max_depth=4, max_volume=5)
    a = t_vpt.render(st, ct, md, SPP, seed=SEED, compact=True)
    b = t_vpt.render(st, ct, md, SPP, seed=SEED)
    differ = int((a != b).any(dim=-1).sum())
    assert differ == 0 and float(a.mean()) > 0.01, differ


def test_count_rays_pt_equal_jax():
    """path_tracer.count_rays on cornell, on the Sobol sampler's streams."""
    sj, cj = j_ts.cornell_box(width=8, height=8)[:2]
    st, ct = _port(sj, cj)
    md = dict(max_depth=4)
    want = int(j_pt.count_rays(sj, cj, JMD(**md), SPP, seed=SEED, sampler="sobol"))
    got = t_pt.count_rays(st, ct, TMD(**md), SPP, seed=SEED, sampler="sobol")
    assert isinstance(got, int) and got == want > 8 * 8 * SPP, (got, want)


@pytest.mark.parametrize("kind", ["nested", "grid"])
def test_count_rays_vpt_equal_jax(nested, kind):
    """volume_pt.count_rays without grids (a shadow walk through null
    interfaces counts once) and with them, equal to the reference's, and
    to the per-lane sum of the render's own streams."""
    if kind == "nested":
        sj, cj, st, ct = nested
    else:
        sj, cj = j_ts.grid_smoke(width=8, height=8, n=8)[:2]
        st, ct = _port(sj, cj)
    md = dict(max_depth=4, max_volume=5)
    want = int(j_vpt.count_rays(sj, cj, JMD(**md), SPP, seed=SEED, use_bvh=False))
    got = t_vpt.count_rays(st, ct, TMD(**md), SPP, seed=SEED)
    assert got == want > ct.width * ct.height * SPP, (got, want)
    lane = torch.arange(ct.width * ct.height)
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    o, d, rng = cam_mod.generate_rays(ct, lane, qmc.make_state("pcg", SEED, lane, 0))
    s = t_vpt.trace_paths_final(st, TMD(**md), o, d, rng,
                                wl_u=t_pt.wl_stratum_u(SEED, 0, lane))
    assert 0 < int(s.rays.sum()) < got
    assert t_vpt.count_rays(st, ct, TMD(**md), 1, seed=SEED) == int(s.rays.sum())


def test_jax_rays_field_present():
    """The reference's states carry the per-lane count the port's carry."""
    assert "rays" in j_pt.PTState.__dataclass_fields__
    assert "rays" in j_vpt.VPTState.__dataclass_fields__
    for t_cls, j_cls in ((t_pt.PTState, j_pt.PTState), (t_vpt.VPTState, j_vpt.VPTState)):
        want = list(j_cls.__dataclass_fields__)
        assert list(t_cls.__dataclass_fields__)[:len(want)] == want
