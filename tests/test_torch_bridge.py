"""Carrying scenes across: flatten a JAX Scene / Camera into the
field-path dicts that cuda_pt_torch/scene/bridge.py reads, and check the
round trip. The other port test files import the helpers from here."""

import dataclasses

import numpy as np
import torch

from cuda_pt_torch.accel import native as t_native
from cuda_pt_torch.scene import bridge
from cuda_pt_tpu.accel import native as j_native
from cuda_pt_tpu.scene import testscenes as j_ts

# The port's CPU tests run small tensors in several test processes at once
# (pytest-xdist); one intra-op thread per process keeps them from
# oversubscribing the cores. Every worker imports this module when it
# collects the port's tests, so the setting holds for all of them.
torch.set_num_threads(1)

def numpy_bvh_builds(mp) -> None:
    """Send both packages' SAH builds down their NumPy paths (mp: a
    pytest.MonkeyPatch): each native builder patched to give None, as
    build_bvh(use_native=False) does, so that scenes compiled under it hold
    the port's NumPy tree against the reference's."""
    mp.setattr(j_native, "build_bvh_native", lambda *a, **k: None)
    mp.setattr(t_native, "build_bvh_native", lambda *a, **k: None)


TABLES = ("geom", "objects", "emitters", "bsdfs", "textures", "media", "grids", "bvh",
          "env_importance")


def flatten_jax_scene(scene) -> dict:
    """A JAX Scene as {"<table>.<field>": ndarray, ...}."""
    out = {}
    for name in TABLES:
        table = getattr(scene, name)
        for f in dataclasses.fields(table):
            v = getattr(table, f.name)
            out[f"{name}.{f.name}"] = v if isinstance(v, int) else np.asarray(v)
    for k in ("env_emitter", "cam_medium", "num_emitters"):
        out[k] = int(np.asarray(getattr(scene, k)))
    out["present_bsdfs"] = tuple(scene.present_bsdfs)
    return out


def flatten_jax_camera(cam) -> dict:
    return {f: np.asarray(getattr(cam, f)) for f in
            ("R", "t", "focal", "aperture", "focal_dist", "hsign", "width", "height")}


def test_bridge_round_trip_cornell():
    sj, cj, _ = j_ts.cornell_box(12, 10)
    flat = flatten_jax_scene(sj)
    st = bridge.scene_from_numpy(flat)
    for key, want in flat.items():
        if key in ("env_emitter", "cam_medium", "num_emitters", "present_bsdfs"):
            assert getattr(st, key) == want, key
            continue
        table, field = key.split(".")
        got = getattr(getattr(st, table), field)
        if torch.is_tensor(got):
            assert got.dtype == torch.as_tensor(want).dtype, key
            got = got.numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)
    ct = bridge.camera_from_numpy(flatten_jax_camera(cj))
    assert (ct.width, ct.height) == (12, 10)
    np.testing.assert_array_equal(ct.R.numpy(), np.asarray(cj.R))
    np.testing.assert_array_equal(ct.focal.numpy(), np.asarray(cj.focal))
