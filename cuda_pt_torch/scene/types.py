"""Compiled scene: flat SoA tensors (port of cuda_pt_tpu/scene/types.py).

Dataclasses of tensors take the place of flax.struct pytrees; static
fields (leaf capacity, stack bound, present BSDF families) are plain Python
values. ``to_device`` moves any of these dataclasses, nested, to a device.
"""

from __future__ import annotations

import dataclasses

import torch

BSDF_LAMBERTIAN = 0
BSDF_SPECULAR = 1
BSDF_TRANSLUCENT = 2
BSDF_PLASTIC = 3
BSDF_PLASTIC_FORWARD = 4
BSDF_GGX_CONDUCTOR = 5
BSDF_DISPERSION = 6
BSDF_FORWARD = 7
BSDF_GGX_DIELECTRIC = 8
BSDF_OREN_NAYAR = 9
NUM_BSDF_TYPES = 10

EMITTER_NULL = 0
EMITTER_POINT = 1
EMITTER_AREA = 2
EMITTER_AREA_SPOT = 3
EMITTER_ENVMAP = 4

PHASE_ISOTROPIC = 0
PHASE_HG = 1
PHASE_DUAL_HG = 2
PHASE_RAYLEIGH = 3
PHASE_SGGX = 4

MEDIUM_NONE = -1
MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1

# BSDF scalar param columns (BSDFTable.params[:, col])
P_IOR = 0
P_ROUGH_X = 1
P_ROUGH_Y = 2
P_THICKNESS = 3
P_CAUCHY_A = 4
P_CAUCHY_B = 5
P_PENETRATION = 6
NUM_BSDF_PARAMS = 8

TEX_DIFFUSE = 0
TEX_SPECULAR = 1
TEX_GLOSSY = 2
TEX_NORMAL = 3
TEX_ROUGHNESS = 4
NUM_TEX_SLOTS = 5


def to_device(obj, device):
    """Copy of a (nested) dataclass of tensors with every tensor on device."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    return obj


@dataclasses.dataclass
class Geometry:
    """Per-primitive SoA. Spheres ride in triangle slots: p0 = center,
    e1[..., 0] = radius."""

    p0: torch.Tensor  # (N, 3)
    e1: torch.Tensor  # (N, 3) p1 - p0
    e2: torch.Tensor  # (N, 3) p2 - p0
    n0: torch.Tensor  # (N, 3) shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # (N, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    obj_idx: torch.Tensor  # (N,) int32
    is_sphere: torch.Tensor  # (N,) bool

    @property
    def num_prims(self) -> int:
        return self.p0.shape[0]


@dataclasses.dataclass
class ObjectTable:
    bsdf_id: torch.Tensor  # (O,) int32
    emitter_id: torch.Tensor  # (O,) int32; 0 = not an emitter
    medium_in: torch.Tensor  # (O,) int32
    cullable: torch.Tensor  # (O,) bool
    prim_base: torch.Tensor  # (O,) int32
    prim_count: torch.Tensor  # (O,) int32
    inv_area: torch.Tensor  # (O,) float32


@dataclasses.dataclass
class EmitterTable:
    """Slot 0 is the null emitter."""

    etype: torch.Tensor  # (E,) int32
    emission: torch.Tensor  # (E, 3)
    scaler: torch.Tensor  # (E,)
    pos: torch.Tensor  # (E, 3)
    extra: torch.Tensor  # (E, 4)
    obj_id: torch.Tensor  # (E,) int32
    tex_id: torch.Tensor  # (E,) int32
    prim_cdf: torch.Tensor  # (E, K) inclusive area CDF over the emitter's prims
    prim_sel: torch.Tensor  # (E, K) int32 global prim ids
    sel_pmf: torch.Tensor  # (E,) power-weighted selection pmf
    sel_cdf: torch.Tensor  # (E,) inclusive, last = 1


@dataclasses.dataclass
class BSDFTable:
    btype: torch.Tensor  # (M,) int32
    k_d: torch.Tensor  # (M, 3)
    k_s: torch.Tensor
    k_g: torch.Tensor
    eta: torch.Tensor
    k: torch.Tensor
    params: torch.Tensor  # (M, NUM_BSDF_PARAMS)
    tex_ids: torch.Tensor  # (M, NUM_TEX_SLOTS) int32, -1 = none


@dataclasses.dataclass
class TextureAtlas:
    texels: torch.Tensor  # (T, 4)
    offset: torch.Tensor  # (K,) int32
    width: torch.Tensor
    height: torch.Tensor


@dataclasses.dataclass
class MediumTable:
    mtype: torch.Tensor
    sigma_a: torch.Tensor
    sigma_s: torch.Tensor
    scale: torch.Tensor
    phase_type: torch.Tensor
    phase_g: torch.Tensor
    phase_w: torch.Tensor
    emission_scale: torch.Tensor
    grid_id: torch.Tensor


@dataclasses.dataclass
class GridMediumData:
    density: torch.Tensor
    emission: torch.Tensor
    bbox_min: torch.Tensor
    bbox_max: torch.Tensor
    majorant: torch.Tensor
    avg_density: torch.Tensor


@dataclasses.dataclass
class BVHArrays:
    """Stackless skip-encoded binary BVH in SoA form."""

    node_min: torch.Tensor  # (M, 3)
    node_max: torch.Tensor  # (M, 3)
    node_skip: torch.Tensor  # (M,) int32
    node_base: torch.Tensor  # (M,) int32
    node_count: torch.Tensor  # (M,) int32
    max_leaf: int = 4

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


@dataclasses.dataclass
class WideBVHArrays:
    """8-wide BVH collapsed from the binary tree. child_node >= 0: wide
    node id; < 0: leaf ``-(leaf_id+1)``; EMPTY (int32 min): no child."""

    child_min: torch.Tensor  # (W, 8, 3)
    child_max: torch.Tensor  # (W, 8, 3)
    child_node: torch.Tensor  # (W, 8) int32
    leaf_base: torch.Tensor  # (L,) int32
    leaf_count: torch.Tensor  # (L,) int32
    max_leaf: int = 4
    max_stack: int = 32

    @property
    def num_nodes(self) -> int:
        return self.child_min.shape[0]

    @property
    def num_leaves(self) -> int:
        return self.leaf_base.shape[0]


@dataclasses.dataclass
class TraversalForest:
    """Chunked, row-packed BVH forest of kernel K1 (ops/traverse_kernel.py):
    C spatially coherent chunks, each with its own skip-encoded tree. Node
    i of chunk c: nodes[c, i // 8, (i % 8) * 16:] in "f32" rows (8 slots x
    16 fields, 64 B per node) or nodes[c, i // 16, (i % 16) * 8:] in "bf16"
    rows (16 slots x 8 fields, 32 B per node, the boxes as outward-rounded
    bf16 pairs). Integer fields are exact floats (ids below 2^24)."""

    nodes: torch.Tensor  # (C, Rn, 128) f32
    prims: torch.Tensor  # (C, Rp, 128) f32
    n_nodes: torch.Tensor  # (C,) int32 real nodes per chunk
    node_fmt: str = "f32"

    @property
    def num_chunks(self) -> int:
        return self.nodes.shape[0]


@dataclasses.dataclass
class EnvImportance:
    row_cdf: torch.Tensor
    col_cdf: torch.Tensor
    pmf: torch.Tensor

    @property
    def enabled(self) -> bool:
        return self.pmf.shape[0] > 1 or self.pmf.shape[1] > 1


@dataclasses.dataclass
class Scene:
    geom: Geometry
    objects: ObjectTable
    emitters: EmitterTable
    bsdfs: BSDFTable
    textures: TextureAtlas
    media: MediumTable
    grids: GridMediumData
    bvh: BVHArrays
    env_emitter: int  # envmap emitter id, 0 if none
    cam_medium: int  # medium containing the camera
    num_emitters: int  # real emitters (excluding slot 0)
    env_importance: EnvImportance | None = None
    # kernel K1's forest (SceneBuilder.compile(forest_chunk=...), or the
    # BVH as one chunk, packed by the Renderer); None: traversal "pallas"
    # packs it per call (models/path_tracer.pallas_forest)
    forest: TraversalForest | None = None
    wide: WideBVHArrays | None = None
    # static set of BSDF families present (dispatch pruning)
    present_bsdfs: tuple = tuple(range(NUM_BSDF_TYPES))
    # the walk backend: "" = models/path_tracer.TRAVERSAL_IMPL, "xla" = the
    # skip walk, "pallas" = kernel K1, "wide" = the 8-wide walk (scene.wide)
    traversal: str = ""

    @property
    def device(self) -> torch.device:
        return self.geom.p0.device
