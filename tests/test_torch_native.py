"""The port's host C++ (accel/native.py, scene/native_obj.py, built by
utils/host_build.py) and the NumPy modules around it, held against the JAX
package on the CPU: BVHConfig, the presets, the native SAH and SBVH
builders (node arrays and order bit-equal; the SBVH at 4,096 prims or
fewer, below its threaded subtrees), the default compile's prim order,
SBVH scene arrays, the bf16 wide collapse and the OBJ parsers."""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from cuda_pt_torch.accel import bvh_build as t_bvh
from cuda_pt_torch.accel import native as t_native
from cuda_pt_torch.accel import wide_build as t_wide
from cuda_pt_torch.core.config import BVHConfig
from cuda_pt_torch.scene import native_obj as t_nobj
from cuda_pt_torch.scene import obj_loader as t_obj
from cuda_pt_torch.scene import presets as t_presets
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.utils import host_build
from cuda_pt_tpu.accel import bvh_build as j_bvh
from cuda_pt_tpu.accel import native as j_native
from cuda_pt_tpu.accel import wide_build as j_wide
from cuda_pt_tpu.core import config as j_config
from cuda_pt_tpu.scene import obj_loader as j_obj
from cuda_pt_tpu.scene import presets as j_presets
from cuda_pt_tpu.scene import testscenes as j_ts
from test_torch_bridge import TABLES, flatten_jax_scene


def test_bvh_config_fields_match_reference():
    """BVHConfig's fields, their order and their defaults are the reference's."""
    got = [(f.name, f.default) for f in dataclasses.fields(BVHConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(j_config.BVHConfig)]
    assert got == want
    assert [f.name for f in dataclasses.fields(BVHConfig)][:6] == [
        "max_prims_per_leaf", "cache_level", "overlap_w", "use_sbvh", "use_ref_unsplit",
        "dup_budget_frac"]


def test_presets_equal_reference():
    assert t_presets.CONDUCTORS == j_presets.CONDUCTORS
    assert t_presets.DISPERSION == j_presets.DISPERSION
    assert t_presets.DISPERSION["Glass_BK7"] == t_presets.DISPERSION["Glass-BK7"]


def _soup(n: int, seed: int, sphere_frac: float = 0.05):
    rs = np.random.default_rng(seed)
    c = rs.uniform(-5, 5, (n, 1, 3))
    p = (c + rs.normal(scale=0.3, size=(n, 3, 3))).astype(np.float32)
    sph = rs.random(n) < sphere_frac
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    e1[sph] = np.abs(e1[sph]) * [1, 0, 0]
    return p[:, 0], e1, e2, sph


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_native_libraries_build_under_the_build_dir():
    assert t_native.available() and t_native.sbvh_available() and t_nobj.available()
    for src in (t_native._SRC, t_native._SRC_SBVH, t_nobj._SRC):
        path = host_build.library_path(src, ("-pthread",) if src == t_native._SRC_SBVH else ())
        assert os.path.exists(path) and os.path.dirname(path) == host_build.HOST_DIR
        assert host_build.HOST_DIR.endswith(os.path.join("build", "cuda_pt_torch", "host"))
    # the name hashes the source and the flags
    assert host_build.library_path(t_native._SRC) != host_build.library_path(t_native._SRC,
                                                                             ("-DX",))


@pytest.mark.parametrize("n,seed,max_leaf,overlap_w", [(3000, 1, 4, 1.0), (1500, 2, 8, 0.0),
                                                        (97, 3, 1, 2.0)])
def test_native_bvh_bit_equal_reference(n, seed, max_leaf, overlap_w):
    p0, e1, e2, sph = _soup(n, seed)
    lo, hi, cent = t_bvh.prim_bounds(p0, e1, e2, sph)
    got = t_native.build_bvh_native(lo, hi, cent, max_leaf, overlap_w)
    _equal(got, j_native.build_bvh_native(lo, hi, cent, max_leaf, overlap_w))
    # build_bvh dispatches to it, as the reference's does
    _equal(t_bvh.build_bvh(lo, hi, cent, max_leaf, overlap_w), got)
    _equal(j_bvh.build_bvh(lo, hi, cent, max_leaf, overlap_w), got)
    assert t_bvh.sah_cost(got) == j_bvh.sah_cost(got)


@pytest.mark.parametrize("n,seed,budget,max_leaf", [(4096, 4, 1.0, 4), (2500, 5, 0.5, 4),
                                                     (800, 6, 0.0, 8)])
def test_native_sbvh_bit_equal_reference(n, seed, budget, max_leaf):
    p0, e1, e2, sph = _soup(n, seed)
    got = t_native.build_sbvh_native(p0, e1, e2, sph, max_leaf, 1.0, budget)
    _equal(got, j_native.build_sbvh_native(p0, e1, e2, sph, max_leaf, 1.0, budget))
    order = got["order"]
    assert np.array_equal(np.unique(order), np.arange(n))  # every prim referenced
    assert order.size >= n and int(got["node_count"].sum()) == order.size
    if budget == 0.0:
        assert order.size == n  # no budget, no duplicates


def _compiled_equal(st, sj):
    flat = flatten_jax_scene(sj)
    for name in TABLES:
        table = getattr(st, name)
        for f in dataclasses.fields(table):
            got = getattr(table, f.name)
            if torch.is_tensor(got):
                got = got.numpy()
            np.testing.assert_array_equal(got, flat[f"{name}.{f.name}"], err_msg=f"{name}.{f.name}")
    assert st.present_bsdfs == flat["present_bsdfs"]


def test_default_compile_gives_reference_prim_order():
    """Both packages' default compiles (native SAH) of a seeded scene: every
    table bit-equal, the BVH's nodes and the prim order included."""
    st, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    sj, _, _ = j_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    _compiled_equal(st, sj)


@pytest.mark.parametrize("unsplit,budget", [(False, None), (True, None), (False, 0.25)])
def test_sbvh_compile_equal_reference(unsplit, budget):
    """compile(BVHConfig(use_sbvh=True)): the scene arrays equal JAX's, the
    duplicated references counted once by the emitter tables."""
    _, _, bt = t_ts.cornell_box(8, 8)
    _, _, bj = j_ts.cornell_box(8, 8)
    kw = dict(use_sbvh=True, use_ref_unsplit=unsplit, dup_budget_frac=budget)
    st = bt.compile(BVHConfig(**kw))
    sj = bj.compile(j_config.BVHConfig(**kw))
    _compiled_equal(st, sj)
    assert st.geom.num_prims >= sum(o.p.shape[0] for o in bt.objects)


def test_sbvh_falls_back_to_sah_when_native_is_none(monkeypatch):
    _, _, b = t_ts.cornell_box(8, 8)
    monkeypatch.setattr(t_native, "build_sbvh_native", lambda *a, **k: None)
    st = b.compile(BVHConfig(use_sbvh=True))
    want = b.compile(BVHConfig())
    np.testing.assert_array_equal(st.bvh.node_skip.numpy(), want.bvh.node_skip.numpy())


@pytest.mark.parametrize("box_dtype", ["f32", "bf16"])
def test_collapse_wide_box_dtype_equal_reference(box_dtype):
    p0, e1, e2, sph = _soup(2000, 7)
    nodes = t_bvh.build_bvh(*t_bvh.prim_bounds(p0, e1, e2, sph), max_leaf=4)
    wt = t_wide.collapse_wide(nodes, max_leaf=4, box_dtype=box_dtype)
    wj = j_wide.collapse_wide(nodes, max_leaf=4, box_dtype=box_dtype)
    assert wt.child_min.dtype == (torch.bfloat16 if box_dtype == "bf16" else torch.float32)
    for f in ("child_min", "child_max", "child_node", "leaf_base", "leaf_count"):
        got = getattr(wt, f).float().numpy() if f.startswith("child_m") else getattr(wt, f).numpy()
        want = np.asarray(getattr(wj, f)).astype(got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (wt.max_leaf, wt.max_stack) == (wj.max_leaf, wj.max_stack)
    if box_dtype == "bf16":  # rounded outward: every f32 box inside its bf16 one
        wf = t_wide.collapse_wide(nodes, max_leaf=4)
        fin = torch.isfinite(wf.child_min)
        assert bool((wt.child_min.float()[fin] <= wf.child_min[fin]).all())
        assert bool((wt.child_max.float()[fin] >= wf.child_max[fin]).all())


def test_native_unavailable_warns_once_and_falls_back(monkeypatch):
    """Where g++ is missing: one warning per library, available() False,
    and build_bvh gives the NumPy tree."""
    def no_gxx(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(t_native, "_LIBS", {})
    monkeypatch.setattr(host_build, "build", no_gxx)
    p0, e1, e2, sph = _soup(300, 8)
    bounds = t_bvh.prim_bounds(p0, e1, e2, sph)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert not t_native.available() and not t_native.sbvh_available()
        got = t_bvh.build_bvh(*bounds, max_leaf=4)
        assert t_native.build_sbvh_native(p0, e1, e2, sph) is None
    msgs = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 2 and all("did not build" in m for m in msgs), msgs
    _equal(got, j_bvh.build_bvh(*bounds, max_leaf=4, use_native=False))


OBJ_FILES = {
    "polygons": """# a quad, a pentagon and a triangle
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0.25
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0.5 0.5
f 1/1/1 2/2/1 3/3/1 4/4/1
f 1/1/2 2/2/2 3/3/2 5/4/2 4/4/2   # trailing comment
f 1 3 5
""",
    "negative": """v 0 0 0
v 2 0 0
v 0 2 0
vn 0 0 -3
f -3//-1 -2//-1 -1//-1
v 0 0 1
f -4 -3 -1
""",
    "no_normals_uvs": """v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 0
f 1 2 3
f 1 2 4
f 3/ 2/ 1/
""",
    "comments_blank": """
# only comments and blank lines around one triangle

v 1e-3 2.5E1 -3
v 4 5 6
   v 7 8 9
vt 0.25 0.75
f 1/1 2/1 3/1
""",
    "empty": "",
}


@pytest.mark.parametrize("name", sorted(OBJ_FILES))
@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_load_obj_equal_reference(tmp_path, name, native):
    path = str(tmp_path / f"{name}.obj")
    with open(path, "w") as f:
        f.write(OBJ_FILES[name])
    got = t_obj.load_obj(path, native=native)
    want = j_obj.load_obj(path, native=native)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if native:  # and the Python parser's arrays, up to the normals' f32 rounding
        py = t_obj.load_obj(path, native=False)
        for k in got:
            np.testing.assert_allclose(got[k], py[k], rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_load_obj_missing_file_raises_as_reference(tmp_path, native):
    path = str(tmp_path / "missing.obj")
    with pytest.raises(FileNotFoundError):
        j_obj.load_obj(path, native=native)
    with pytest.raises(FileNotFoundError):
        t_obj.load_obj(path, native=native)
    assert t_nobj.load_obj_native(path) is None
