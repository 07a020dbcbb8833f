"""The kernel's plain version (ops/megakernel.trace_megakernel_reference:
the fused TPU kernel's estimator) against JAX trace_megakernel(interpret=
True), per lane, on the two scenes that carry the whole surface envelope:
kitchen_stress (envmap, diffuse textures, dispersion, GGX conductor,
plastic, smooth dielectric) and a scene with the four families kitchen
lacks plus an area-spot light. Also the VMEM limits the port lifted.

Contract: allclose(rtol 1e-4, atol 1e-5) on >= 95 % of lanes, image means
within 1e-3 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.core.config import MaxDepthParams as TMD
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.scene import bridge
from cuda_pt_tpu.core import camera as j_cam
from cuda_pt_tpu.core import qmc as j_qmc
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.ops.pallas import megakernel as j_mk
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import types as JT
from cuda_pt_tpu.scene.builder import BSDFSpec, EmitterSpec, SceneBuilder
from test_torch_bridge import concurrently, flatten_jax_scene

RTOL, ATOL, MIN_LANES, MEAN_REL = 1e-4, 1e-5, 0.95, 1e-3


def four_families(width=8, height=8):
    """Oren-Nayar floor, Specular back wall, a rough GGX dielectric pane, a
    Forward pane and an area-spot light (JAX builder)."""
    q = j_ts.quad
    b = SceneBuilder()
    on = b.add_bsdf(BSDFSpec(btype=JT.BSDF_OREN_NAYAR, k_d=(0.6, 0.5, 0.4), roughness_x=0.5))
    mirror = b.add_bsdf(BSDFSpec(btype=JT.BSDF_SPECULAR, k_d=(0.9, 0.9, 0.85)))
    rough = b.add_bsdf(BSDFSpec(btype=JT.BSDF_GGX_DIELECTRIC, k_s=(0.95, 0.95, 0.95), ior=1.5,
                                roughness_x=0.25, roughness_y=0.25))
    fwd = b.add_bsdf(BSDFSpec(btype=JT.BSDF_FORWARD))
    dark = b.add_bsdf(BSDFSpec(k_d=(0.0, 0.0, 0.0)))
    spot = b.add_emitter(EmitterSpec(etype=JT.EMITTER_AREA_SPOT, emission=(1, 1, 1),
                                     scaler=25.0, extra=(0.6, 0.0, 0.0, 0.0)))
    b.add_mesh(q([-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]), on)
    b.add_mesh(q([-2, 0, 1.5], [2, 0, 1.5], [2, 2, 1.5], [-2, 2, 1.5]), mirror)
    b.add_mesh(q([-1.2, 0.5, -0.6], [0.0, 0.5, -0.6], [0.0, 0.5, 0.6], [-1.2, 0.5, 0.6]), rough)
    b.add_mesh(q([0.1, 0.7, -0.6], [1.2, 0.7, -0.6], [1.2, 0.7, 0.6], [0.1, 0.7, 0.6]), fwd)
    b.add_mesh(q([-0.4, 1.8, -0.4], [0.4, 1.8, -0.4], [0.4, 1.8, 0.4], [-0.4, 1.8, 0.4]), dark,
               emitter_id=spot)
    scene = b.compile()
    cam = j_cam.make_camera(origin=(0, 1.3, -2.6), target=(0, 0.3, 0.2), fov=55.0,
                            width=width, height=height)
    return scene, cam


def _jax_ref(sj, cj, depth, seed):
    """JAX's kernel (interpret mode) on the scene's camera rays: (scene,
    o, d, rng, pack, L)."""
    W, H = int(cj.width), int(cj.height)
    lane = jnp.arange(W * H, dtype=jnp.int32)
    rng = j_qmc.make_state("pcg", seed, lane, 1)
    o, d, rng = j_cam.generate_rays(cj, lane, rng)
    pack_j = j_mk.make_pack(sj, node_fmt="w8")
    Lj = np.asarray(j_mk.trace_megakernel(pack_j, JMD(max_depth=depth), o, d, rng,
                                          interpret=True))
    return sj, o, d, rng, pack_j, Lj


@pytest.fixture(scope="module")
def jax_refs():
    """The file's two interpret calls, run at once (concurrently): kitchen
    at max_depth 3, seed 5; the four families at max_depth 4, seed 9."""
    return concurrently(
        kitchen=lambda: _jax_ref(*j_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)[:2], 3, 5),
        four=lambda: _jax_ref(*four_families(), 4, 9))


def _hold(ref, md_t):
    sj, o, d, rng, pack_j, Lj = ref
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    pack_t = t_mk.make_pack(st, node_fmt="w8")
    Lt = t_mk.trace_megakernel(pack_t, md_t, torch.tensor(np.asarray(o)),
                               torch.tensor(np.asarray(d)),
                               torch.tensor(np.asarray(rng).astype(np.int64))).numpy()
    close = np.isclose(Lt, Lj, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert np.isfinite(Lt).all() and Lj.mean() > 0.01
    assert close.mean() >= MIN_LANES, (close.mean(), np.abs(Lt - Lj).max())
    assert abs(Lt.mean() - Lj.mean()) <= MEAN_REL * abs(Lj.mean()), (Lt.mean(), Lj.mean())
    return pack_j, pack_t


def test_kernel_estimator_kitchen_matches_jax_interpret(jax_refs):
    """kitchen_stress 8x8 (grid 2, 198 triangles) at max_depth 3: envmap
    misses, deferred diffuse texels and the locked dispersion wavelength."""
    pack_j, pack_t = _hold(jax_refs["kitchen"], TMD(max_depth=3))
    assert pack_j.has_env and pack_j.textured and pack_j.has_disp
    assert pack_t.flags == {"has_env": True, "textured": True, "has_disp": True}


def test_kernel_estimator_four_families_matches_jax_interpret(jax_refs):
    """Specular, rough GGX dielectric, Oren-Nayar and Forward under an
    area-spot light, max_depth 4."""
    sj = jax_refs["four"][0]
    present = set(sj.present_bsdfs)
    assert {JT.BSDF_SPECULAR, JT.BSDF_GGX_DIELECTRIC, JT.BSDF_OREN_NAYAR,
            JT.BSDF_FORWARD} <= present
    assert JT.EMITTER_AREA_SPOT in set(np.asarray(sj.emitters.etype).tolist())
    _hold(jax_refs["four"], TMD(max_depth=4))


@pytest.fixture(scope="module")
def kitchen_full():
    sj, _, _ = j_ts.kitchen_stress(64, 64)
    return sj, bridge.scene_from_numpy(flatten_jax_scene(sj))


def test_lifted_vmem_limits_admit_kitchen(kitchen_full):
    """Full-size kitchen_stress (98,790 triangles) at the default depth caps
    fails the TPU kernel's VMEM budget (FUSED_VMEM_BUDGET_BYTES with the
    compacted pack plus the textured tile state) and passes the port's
    envelope, which has no VMEM limit: the card reads the tables from
    device memory. AUTO_COMPACT_BYTES stays, as make_pack's format rule
    (it decides the image, not the admission), with the reference's
    value."""
    sj, st = kitchen_full
    assert st.geom.num_prims == 98790
    assert not j_mk.megakernel_ok(sj, JMD())
    assert (j_mk.resident_pack_bytes(sj) + j_mk._tile_state_bytes(d1=JMD().max_depth + 1,
                                                                    textured=True)
            > j_mk.FUSED_VMEM_BUDGET_BYTES)
    assert t_mk.megakernel_ok(st, TMD())
    for name in ("FUSED_VMEM_BUDGET_BYTES", "_tile_state_bytes"):
        assert not hasattr(t_mk, name)
    assert t_mk.AUTO_COMPACT_BYTES == j_mk.AUTO_COMPACT_BYTES


def test_envelope_keeps_table_limits(kitchen_full):
    """The limits that shape the packed tables stay: MAX_BSDFS, and
    Plastic-forward stays outside as on the TPU."""
    _, st = kitchen_full
    flat = {"bsdfs.btype": np.asarray(st.bsdfs.btype)}
    assert len(flat["bsdfs.btype"]) <= t_mk.MAX_BSDFS
    b = SceneBuilder()
    for i in range(t_mk.MAX_BSDFS + 1):
        b.add_bsdf(BSDFSpec(k_d=(0.5, 0.5, 0.5)))
    b.add_mesh(j_ts.quad([0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]), 0)
    many = bridge.scene_from_numpy(flatten_jax_scene(b.compile()))
    assert not t_mk.megakernel_ok(many)
    b = SceneBuilder()
    b.add_mesh(j_ts.quad([0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]),
               b.add_bsdf(BSDFSpec(btype=JT.BSDF_PLASTIC_FORWARD)))
    pfw = bridge.scene_from_numpy(flatten_jax_scene(b.compile()))
    assert not t_mk.megakernel_ok(pfw)
