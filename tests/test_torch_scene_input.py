"""Scene input without JAX, held against the JAX package on the CPU: the
image loaders (PNG decoded by hand, Radiance .hdr), the NanoVDB reader,
the XML parser (every element, override_res and override_accel), the
traversal autotuner and, end to end, Renderer(xml_path) against the
reference's Renderer on the same file."""

import dataclasses
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image as PIL_Image

from cuda_pt_torch.accel import autotune as t_auto
from cuda_pt_torch.api import Renderer
from cuda_pt_torch.media import nvdb as t_nvdb
from cuda_pt_torch.pyrender import PythonRenderer
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene import xml_parser as t_xml
from cuda_pt_torch.utils import image as t_img
from cuda_pt_tpu.accel import autotune as j_auto
from cuda_pt_tpu.api import Renderer as JRenderer
from cuda_pt_tpu.media import nvdb as j_nvdb
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import xml_parser as j_xml
from cuda_pt_tpu.utils import image as j_img
from test_media import _write_synthetic_nvdb
from test_torch_bridge import TABLES, flatten_jax_camera, flatten_jax_scene

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _write_png(path, img: np.ndarray, depth: int, ctype: int, filters, interlace: int = 0):
    """A PNG written by hand with the given row filters (cycled), so that
    every filter type and the 16-bit layouts occur."""
    h, w = img.shape[:2]
    raw = (img.astype(">u2").view(np.uint8) if depth == 16 else img.astype(np.uint8))
    rows = raw.reshape(h, -1).astype(np.int32)
    bpp = max(_CHANNELS[ctype] * depth // 8, 1)
    out, prev = b"", np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            r = x
        elif f == 1:
            r = x - a
        elif f == 2:
            r = x - prev
        elif f == 3:
            r = x - ((a + prev) >> 1)
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            r = x - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out += bytes([f]) + (r & 0xFF).astype(np.uint8).tobytes()
        prev = x
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                   interlace))
                 + _png_chunk(b"IDAT", zlib.compress(out)) + _png_chunk(b"IEND", b""))


def _pil_images(tmp_path) -> dict:
    rs = np.random.default_rng(21)
    yy, xx = np.mgrid[0:19, 0:23]
    smooth = np.stack([(xx * 7 + yy) % 256, (yy * 11) % 256, (xx * yy) % 256,
                       (xx + 2 * yy) % 256], -1).astype(np.uint8)
    noise = rs.integers(0, 256, (19, 23, 4), dtype=np.uint8)
    out = {}
    for name, arr in (("smooth", smooth), ("noise", noise)):
        for mode, ch in (("L", 0), ("LA", slice(0, 2)), ("RGB", slice(0, 3)),
                         ("RGBA", slice(0, 4))):
            out[f"{name}_{mode}"] = PIL_Image.fromarray(np.ascontiguousarray(arr[..., ch]), mode)
        pal = PIL_Image.fromarray(arr[..., 0] % 200, "P")
        pal.putpalette(list(range(256)) * 3)
        out[f"{name}_P8"] = pal
        pal4 = PIL_Image.fromarray(arr[..., 1] % 5, "P")  # PIL writes it at 4 bits
        pal4.putpalette(list(range(15)))
        out[f"{name}_P4"] = pal4
        out[f"{name}_I16"] = PIL_Image.fromarray(arr[..., 0].astype(np.uint16) * 257
                                                 + arr[..., 1])
    paths = {}
    for k, im in out.items():
        paths[k] = str(tmp_path / f"{k}.png")
        im.save(paths[k])
    return paths


def _same(a: np.ndarray, b: np.ndarray):
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_load_png_written_by_pil_bit_equal(tmp_path):
    for name, path in _pil_images(tmp_path).items():
        for linear in (True, False):
            got, want = t_img.load_image(path, linear), j_img.load_image(path, linear)
            assert got.ndim == 3, name
            _same(got, want)


@pytest.mark.parametrize("depth,ctype", [(8, 0), (8, 2), (8, 4), (8, 6), (16, 0), (16, 2),
                                         (16, 4), (16, 6)])
def test_load_png_every_filter_bit_equal(tmp_path, depth, ctype):
    """Rows under filters 0-4 in turn, 8 and 16 bits (16-bit colour keeps
    the high byte, 16-bit gray+alpha opens as RGBA, as in PIL)."""
    rs = np.random.default_rng(depth * 10 + ctype)
    img = rs.integers(0, 1 << depth, (13, 9, _CHANNELS[ctype]))
    path = str(tmp_path / "f.png")
    _write_png(path, img[..., 0] if ctype == 0 else img, depth, ctype, [0, 1, 2, 3, 4, 4, 3])
    _same(t_img.load_image(path), j_img.load_image(path))


def test_png_errors_and_formats_without_pil(tmp_path, monkeypatch):
    path = str(tmp_path / "adam7.png")
    _write_png(path, np.zeros((4, 4, 3), np.uint8), 8, 2, [0], interlace=1)
    with pytest.raises(ValueError, match="adam7.png: interlaced"):
        t_img.load_image(path)
    bmp = str(tmp_path / "tex.bmp")
    PIL_Image.fromarray(np.arange(48, dtype=np.uint8).reshape(4, 4, 3)).save(bmp)
    _same(t_img.load_image(bmp), j_img.load_image(bmp))  # through PIL where it exists
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match=r"tex\.bmp: reading \.bmp images needs PIL"):
        t_img.load_image(bmp)
    png = str(tmp_path / "rgba.png")
    rgba = np.random.default_rng(3).random((5, 6, 4)).astype(np.float32)
    t_img.save_png(png, rgba)  # and PNG stays readable without PIL
    assert t_img.load_image(png, to_linear=False).shape == (5, 6, 4)


def _write_hdr(path, rgbe: np.ndarray, rle: bool):
    """A Radiance file: flat RGBE scanlines, or new-style RLE ones (each
    plane as runs of equal bytes and literal dumps)."""
    H, W, _ = rgbe.shape
    body = bytearray()
    for y in range(H):
        if not rle:
            body += rgbe[y].tobytes()
            continue
        body += bytes([2, 2, W >> 8, W & 0xFF])
        for c in range(4):
            plane, x = rgbe[y, :, c], 0
            while x < W:
                run = 1
                while x + run < W and run < 127 and plane[x + run] == plane[x]:
                    run += 1
                if run >= 3:
                    body += bytes([128 + run, plane[x]])
                    x += run
                else:
                    n = min(W - x, 128)
                    body += bytes([n]) + plane[x:x + n].tobytes()
                    x += n
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {H} +X {W}\n".encode()
                + bytes(body))


@pytest.mark.parametrize("rle", [False, True], ids=["flat", "rle"])
def test_load_hdr_bit_equal(tmp_path, rle):
    rs = np.random.default_rng(9)
    rgbe = rs.integers(0, 256, (7, 40, 4), dtype=np.uint8)
    rgbe[:, 10:30] = rgbe[:, 10:11]  # runs for the RLE planes
    rgbe[2, :, 3] = 0  # black by the zero exponent
    path = str(tmp_path / "sky.hdr")
    _write_hdr(path, rgbe, rle)
    got = t_img.load_image(path)
    _same(got, j_img.load_image(path))
    assert got.shape == (7, 40, 3) and not got[2].any()


def test_nvdb_bit_equal(tmp_path):
    """The reference's synthetic files: codec 0 and ZIP, internal tiles;
    BLOSC raises with the reference's message; .npy / .npz dense grids."""
    rs = np.random.default_rng(5)
    v0, v1 = (rs.uniform(0.1, 1.0, (8, 8, 8)).astype(np.float32) for _ in range(2))
    files = {}
    for codec in (0, 1):
        files[codec] = str(tmp_path / f"c{codec}.nvdb")
        _write_synthetic_nvdb(files[codec], [((0, 0, 0), v0), ((8, 0, 0), v1)],
                              (0, 0, 0, 15, 7, 7), codec=codec)
    files["tiles"] = str(tmp_path / "tiles.nvdb")
    _write_synthetic_nvdb(files["tiles"], [((0, 0, 0), v0)], (0, 0, 0, 15, 15, 15),
                          lower_nodes=[((0, 0, 0), {(1, 0, 0): 0.25, (0, 1, 1): 0.5},
                                        [(0, 0, 0)])],
                          upper_nodes=[((0, 0, 0), {(1, 0, 0): 9.0}, [(0, 0, 0)])])
    for key, path in files.items():
        got, want = t_nvdb.load_nvdb_density(path), j_nvdb.load_nvdb_density(path)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, key
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_nvdb.load_dense(files[1])[0][:, :, 8:], v1)
    blosc = str(tmp_path / "blosc.nvdb")
    _write_synthetic_nvdb(blosc, [((0, 0, 0), v0)], (0, 0, 0, 7, 7, 7), codec=2)
    with pytest.raises(ValueError) as et:
        t_nvdb.load_nvdb_density(blosc)
    with pytest.raises(ValueError) as ej:
        j_nvdb.load_nvdb_density(blosc)
    assert str(et.value) == str(ej.value) and "codec 2" in str(et.value)
    np.save(tmp_path / "d.npy", v0)
    np.savez(tmp_path / "d.npz", density=v1, bbox_min=np.ones(3), bbox_max=np.full(3, 2.0))
    for name in ("d.npy", "d.npz"):
        for a, b in zip(t_nvdb.load_dense(str(tmp_path / name)),
                        j_nvdb.load_dense(str(tmp_path / name))):
            np.testing.assert_array_equal(a, b)


def _write_obj(path, tris: np.ndarray, normals: bool = True):
    with open(path, "w") as f:
        for t in tris:
            for v in t:
                f.write("v %.9g %.9g %.9g\n" % tuple(v))
        if normals:
            for t in tris:
                nrm = np.cross(t[1] - t[0], t[2] - t[0])
                f.write("vn %.9g %.9g %.9g\n" % tuple(nrm))
        for i in range(len(tris)):
            f.write("f " + " ".join(f"{3 * i + k + 1}//{i + 1}" if normals else
                                    str(3 * i + k + 1) for k in range(3)) + "\n")


_QUAD = t_ts.quad


def _every_element_scene(d) -> str:
    """A scene file with every element the parser reads (and its assets)."""
    rs = np.random.default_rng(17)
    t_img.save_png(os.path.join(d, "albedo.png"), rs.integers(0, 256, (6, 5, 3), dtype=np.uint8))
    t_img.save_png(os.path.join(d, "normal.png"), rs.integers(0, 256, (4, 4, 3), dtype=np.uint8))
    _write_hdr(os.path.join(d, "sky.hdr"), rs.integers(100, 140, (4, 8, 4), dtype=np.uint8),
               rle=False)
    dens = rs.uniform(0.0, 2.0, (8, 8, 8)).astype(np.float32)
    _write_synthetic_nvdb(os.path.join(d, "smoke.nvdb"), [((0, 0, 0), dens)], (0, 0, 0, 7, 7, 7),
                          codec=1)
    _write_synthetic_nvdb(os.path.join(d, "glow.nvdb"), [((0, 0, 0), dens * 0.5)],
                          (0, 0, 0, 7, 7, 7))
    _write_obj(os.path.join(d, "floor.obj"), _QUAD([-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]))
    _write_obj(os.path.join(d, "box.obj"), np.concatenate([
        _QUAD([-.5, 0, -.5], [.5, 0, -.5], [.5, 1, -.5], [-.5, 1, -.5]),
        _QUAD([-.5, 1, -.5], [.5, 1, -.5], [.5, 1, .5], [-.5, 1, .5])]), normals=False)
    _write_obj(os.path.join(d, "light.obj"),
               _QUAD([-.3, 1.9, -.3], [.3, 1.9, -.3], [.3, 1.9, .3], [-.3, 1.9, .3]))
    bsdfs = "\n".join([
        '<brdf type="lambertian" id="tex"><rgb name="k_d" value="#ff8040"/>'
        '<ref type="texture" id="pack"/></brdf>',
        '<brdf type="specular" id="mirror"><rgb name="k_d" value="0.9"/></brdf>',
        '<brdf type="det-refraction" id="glass"><rgb name="k_d" value="1.33, 1.33, 1.33"/>'
        '<rgb name="k_s" value="0.98 0.97 0.96"/></brdf>',
        '<brdf type="conductor-ggx" id="cu"><string name="conductor" value="Cu"/>'
        '<float name="roughness_x" value="0.2"/><float name="roughness_y" value="0.3"/></brdf>',
        '<brdf type="conductor-ggx" id="au"/>',
        '<brdf type="plastic" id="plastic"><rgb name="sigma_a" value="0.1 0.2 0.3"/>'
        '<float name="ior" value="1.6"/><float name="thickness" value="0.4"/></brdf>',
        '<brdf type="plastic-forward" id="pf"/>',
        '<brdf type="dispersion" id="bk7"><string name="type" value="Glass_BK7"/></brdf>',
        '<brdf type="dispersion" id="diamond"/>',
        '<brdf type="rough-dielectric" id="frost"><float name="roughness_x" value="0.3"/></brdf>',
        '<brdf type="oren-nayar" id="on"><rgb name="k_g" value="0.5"/></brdf>',
        '<brdf type="forward" id="null"/>',
        '<brdf type="unknown-kind" id="fallback"/>',
    ])
    return f"""<scene version="1.2">
<renderer type="vpt">
  <integer name="sample_count" value="32"/>
  <integer name="max_bounce" value="5"/><integer name="max_diffuse" value="3"/>
  <integer name="max_specular" value="4"/><integer name="max_transmit" value="6"/>
  <integer name="max_volume" value="7"/>
  <float name="min_time" value="0.5"/><float name="max_time" value="9.5"/>
  <bool name="bidirectional" value="true"/>
  <integer name="specular_constraint" value="2"/><float name="caustic_scaling" value="0.5"/>
</renderer>
<accelerator type="bvh">
  <integer name="max_node_num" value="12"/><integer name="cache_level" value="3"/>
  <float name="overlap_w" value="0.5"/><bool name="use_sbvh" value="false"/>
  <bool name="use_ref_unsplit" value="true"/><float name="dup_budget_frac" value="-1"/>
</accelerator>
<texture id="pack">
  <string name="diffuse" value="albedo.png"/><string name="normal" value="normal.png"/>
  <string name="roughness" value="missing.png"/>
</texture>
<texture id="skytex"><string name="emission" value="sky.hdr"/></texture>
<phase type="hg" id="fwd"><float name="g" value="0.6"/></phase>
<phase type="mixed-hg" id="dual"><float name="g" value="0.7"/><float name="g2" value="-0.3"/>
  <float name="weight" value="0.8"/></phase>
<medium type="homogeneous" id="fog"><rgb name="sigma_a" value="0.05 0.1 0.15"/>
  <rgb name="sigma_s" value="0.5"/><float name="scale" value="2"/><ref type="phase" id="fwd"/>
</medium>
<medium type="grid" id="smoke"><rgb name="albedo" value="0.9 0.8 0.7"/>
  <string name="density" value="smoke.nvdb"/><string name="emission" value="glow.nvdb"/>
  <float name="emission-scale" value="0.25"/><float name="scale" value="3"/>
  <ref type="phase" id="dual"/></medium>
<medium type="grid" id="broken"><string name="density" value="missing.nvdb"/></medium>
{bsdfs}
<emitter type="envmap" id="sky"><rgb name="emission" value="1 1 1"/>
  <float name="scale" value="2"/><float name="azimuth" value="30"/>
  <float name="zenith" value="10"/><ref type="texture" id="skytex"/></emitter>
<emitter type="area" id="panel"><rgb name="emission" value="1 0.9 0.8"/>
  <rgb name="scaler" value="10 20 30"/></emitter>
<emitter type="point" id="bulb"><rgb name="emission" value="2 2 2"/>
  <point x="0.1" y="1.5" z="-0.2"/><float name="scaler" value="3"/></emitter>
<emitter type="area-spot" id="spot"><float name="half-angle" value="30"/></emitter>
<shape type="obj"><string name="filename" value="floor.obj"/><ref type="material" id="tex"/>
</shape>
<shape type="obj"><string name="filename" value="box.obj"/><ref type="material" id="null"/>
  <ref type="medium" id="smoke"/><bool name="cullable" value="true"/></shape>
<shape type="obj"><string name="filename" value="light.obj"/><ref type="material" id="on"/>
  <ref type="emitter" id="panel"/></shape>
<shape type="sphere"><point x="1" y="0.5" z="0"/><float name="radius" value="0.4"/>
  <ref type="material" id="bk7"/><ref type="medium" id="fog"/></shape>
<shape type="sphere"><point x="-1" y="0.3" z="0.5"/><ref type="material" id="cu"/></shape>
<shape type="obj"><string name="filename" value="absent.obj"/></shape>
<sensor type="perspective">
  <float name="fov" value="45"/><bool name="hflip" value="true"/>
  <float name="aperture" value="0.05"/><float name="focal_dist" value="3"/>
  <transform name="toWorld"><lookat origin="0, 1, -4" target="0, 0.5, 0" up="0, 1, 0"/>
  </transform>
  <film type="hdrfilm"><integer name="width" value="40"/><integer name="height" value="30"/>
    <bool name="gamma_correction" value="false"/></film>
</sensor>
</scene>
"""


def _config_equal(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(y):
            _config_equal(x, y)
        else:
            assert (x.value if hasattr(x, "value") else x) == (
                y.value if hasattr(y, "value") else y), f.name


def _scenes_equal(st, sj):
    flat = flatten_jax_scene(sj)
    for name in TABLES:
        table = getattr(st, name)
        if table is None:
            assert flat.get(f"{name}.row_cdf") is None
            continue
        for f in dataclasses.fields(table):
            got = getattr(table, f.name)
            got = got.numpy() if torch.is_tensor(got) else got
            np.testing.assert_array_equal(got, flat[f"{name}.{f.name}"], err_msg=f"{name}.{f.name}")
    assert (st.env_emitter, st.cam_medium, st.num_emitters) == (
        flat["env_emitter"], flat["cam_medium"], flat["num_emitters"])
    assert st.present_bsdfs == flat["present_bsdfs"]


@pytest.mark.parametrize("overrides", [False, True], ids=["as_written", "overridden"])
def test_load_xml_every_element_equal_reference(tmp_path, overrides):
    path = str(tmp_path / "scene.xml")
    with open(path, "w") as f:
        f.write(_every_element_scene(str(tmp_path)))
    kw = dict(override_res=(24, 20), override_accel={"max_prims_per_leaf": 16}) \
        if overrides else {}
    with pytest.warns(UserWarning, match="absent.obj"):
        pt = t_xml.load_xml(path, **kw)
    pj = j_xml.load_xml(path, **kw)
    _config_equal(pt.config, pj.config)
    assert pt.config.bvh.max_prims_per_leaf == (16 if overrides else 8)
    assert pt.config.bvh.dup_budget_frac is None and pt.config.bvh.cache_level == 3
    assert (pt.config.width, pt.config.height) == ((24, 20) if overrides else (40, 30))
    cam_j = flatten_jax_camera(pj.camera)
    for k, v in cam_j.items():
        got = getattr(pt.camera, k)
        np.testing.assert_array_equal(got.numpy() if torch.is_tensor(got) else got, v, k)
    _scenes_equal(pt.scene, pj.scene)
    # the missing grid fell back to homogeneous, the others kept their grids
    assert pt.scene.media.mtype.tolist() == [0, 1, 0]
    assert pt.scene.grids.density.shape == (1, 8, 8, 8)
    assert pt.builder is not None and len(pt.builder.objects) == 5


@pytest.mark.parametrize("bad", ['<string name="conductor" value="Unobtainium"/>',
                                 '<string name="type" value="Glass-XYZ"/>'])
def test_load_xml_unknown_presets_raise_as_reference(tmp_path, bad):
    btype = "conductor-ggx" if "conductor" in bad else "dispersion"
    path = str(tmp_path / "bad.xml")
    with open(path, "w") as f:
        f.write(f'<scene><brdf type="{btype}" id="m">{bad}</brdf><sensor>'
                '<transform><lookat origin="0,0,-1" target="0,0,0"/></transform>'
                '<film/></sensor></scene>')
    with pytest.raises(ValueError) as et:
        t_xml.load_xml(path)
    with pytest.raises(ValueError) as ej:
        j_xml.load_xml(path)
    assert str(et.value) == str(ej.value) and "'m'" in str(et.value)
    with open(path, "w") as f:
        f.write("<notascene/>")
    with pytest.raises(ValueError, match="not a scene file"):
        t_xml.load_xml(path)


def _cornell_xml(d) -> str:
    """cornell_box as a scene file: its walls, light and boxes as OBJ files."""
    _, _, b = t_ts.cornell_box(8, 8)
    names = ["white", "red", "green", "black"]
    brdfs = "".join(f'<brdf type="lambertian" id="{n}"><rgb name="k_d" value="%s"/></brdf>'
                    % " ".join("%.9g" % c for c in s.k_d) for n, s in zip(names, b.bsdfs))
    shapes = ""
    for i, ob in enumerate(b.objects):
        _write_obj(os.path.join(d, f"o{i}.obj"), ob.p)
        em = '<ref type="emitter" id="light"/>' if ob.emitter_id else ""
        shapes += (f'<shape type="obj"><string name="filename" value="o{i}.obj"/>'
                   f'<ref type="material" id="{names[ob.bsdf_id]}"/>{em}</shape>\n')
    return f"""<scene>
<renderer type="pt"><integer name="max_bounce" value="3"/></renderer>
{brdfs}
<emitter type="area" id="light"><rgb name="emission" value="1 1 1"/>
  <float name="scaler" value="12"/></emitter>
{shapes}<sensor><float name="fov" value="40"/>
  <transform><lookat origin="0.5, 0.5, -1.35" target="0.5, 0.5, 0.5"/></transform>
  <film><integer name="width" value="64"/><integer name="height" value="64"/></film>
</sensor></scene>
"""


@pytest.fixture(scope="module")
def cornell_xml(tmp_path_factory):
    d = tmp_path_factory.mktemp("cornell")
    path = str(d / "cornell.xml")
    with open(path, "w") as f:
        f.write(_cornell_xml(str(d)))
    return path


def test_renderer_xml_end_to_end_matches_reference(cornell_xml):
    """Renderer(xml_path, override_res=(16, 16)), 2 spp, max_depth 3,
    traversal "xla" on both sides (the reference fuses only off the CPU),
    under the Renderer hold's tolerance; PythonRenderer on the same path."""
    r = Renderer(cornell_xml, override_res=(16, 16), traversal="xla", device="cpu")
    rj = JRenderer(cornell_xml, override_res=(16, 16), traversal="xla")
    assert (r.md.max_depth, r.camera.width, r.camera.height) == (3, 16, 16)
    img, ref = r.render(2), np.asarray(rj.render(2))
    assert img.shape == ref.shape == (16, 16, 3) and np.isfinite(img).all()
    match = np.isclose(img, ref, atol=2e-4, rtol=1e-4).mean()
    assert match > 0.995, match
    assert abs(float(img.mean()) - float(ref.mean())) < 5e-4
    assert r.info()["traversal"] == "xla" and r.info()["width"] == 16
    pr = PythonRenderer(cornell_xml, override_res=(16, 16), traversal="xla", device="cpu")
    out = pr.render()
    assert out.shape == (16, 16, 4) and pr.counter() == 1
    np.testing.assert_array_equal(out[..., :3], Renderer(
        cornell_xml, override_res=(16, 16), traversal="xla", device="cpu").render(1))


def test_override_res_ignored_for_parsed_scene():
    scene, cam, _ = t_ts.cornell_box(8, 6)
    parsed = t_xml.ParsedScene(scene, cam, t_xml.RenderingConfig(width=8, height=6))
    r = Renderer(parsed, override_res=(32, 32), device="cpu")
    assert (r.camera.width, r.camera.height) == (8, 6)


def test_probe_rays_equal_reference():
    sj, cj, _ = j_ts.cornell_box(8, 8)
    st, ct, _ = t_ts.cornell_box(8, 8)
    ot, dt = t_auto._probe_rays(st, None, 300)  # the scene's sphere: bit-equal
    oj, dj = j_auto._probe_rays(sj, None, 300)
    assert ot.shape == (600, 3) and ot.dtype == torch.float32
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    # camera rays: the port's generate_rays normalizes in the kernels' order
    # (one f32 ulp from the reference's)
    ot, dt = t_auto._probe_rays(st, ct, 300)
    oj, dj = j_auto._probe_rays(sj, cj, 300)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1.2e-7)


def test_autotune_cornell(monkeypatch):
    """The candidates are the reference's, each timed ("mxu", the matmul
    brute force, too: ported), the result is cached per scene key, the
    Renderer's "auto" pins the pick, and each pinned composed walk renders
    the same image."""
    from cuda_pt_tpu.utils import timing as j_timing

    monkeypatch.setattr(t_auto, "_CACHE", {})
    monkeypatch.setattr(j_auto, "_CACHE", {})
    monkeypatch.setattr(j_timing, "timeit", lambda *a, **k: 1.0)  # the reference's rule, untimed
    sj, cj, _ = j_ts.cornell_box(8, 8)
    scene, cam, _ = t_ts.cornell_box(8, 8)
    want = j_auto.autotune_traversal(sj, cj, n_rays=256, reps=1)
    got = t_auto.autotune_traversal(scene, cam, n_rays=256, reps=1)
    assert list(got["timings_ms"]) == list(want["timings_ms"]) == [
        "xla", "wide", "wide_bf16", "pallas", "mxu"]
    assert all(np.isfinite(v) for v in got["timings_ms"].values()) and not got["cached"]
    assert got["impl"] == min(got["timings_ms"], key=got["timings_ms"].get)
    again = t_auto.autotune_traversal(scene, cam)
    assert again["cached"] and again["impl"] == got["impl"]
    parsed = t_xml.ParsedScene(scene, cam, t_xml.RenderingConfig(
        width=8, height=8, md=t_xml.MaxDepthParams(max_depth=3)))
    r = Renderer(parsed, traversal="auto", device="cpu")
    assert r.info()["traversal"] == ("wide" if got["impl"].startswith("wide") else got["impl"])
    imgs = {}
    key = t_auto._scene_key(scene)
    for impl in ("xla", "wide", "wide_bf16"):
        t_auto._CACHE[key] = dict(got, impl=impl)
        r = Renderer(parsed, traversal="auto", device="cpu")
        if impl == "wide_bf16":
            assert r.scene.wide.child_min.dtype == torch.bfloat16
        imgs[impl] = r.render(1)
    np.testing.assert_array_equal(imgs["wide"], imgs["xla"])
    np.testing.assert_array_equal(imgs["wide_bf16"], imgs["xla"])


@pytest.mark.parametrize("name", ["cornell", "kitchen", "grid"])
def test_chip_smoke_xml_writer_round_trip(tmp_path, name):
    """chip_smoke.py's scene writer (OBJ at %.9g, sRGB PNG textures, RGBE
    sky, ZIP .nvdb grid): the files parse to the builder's triangles, and
    both packages' parsers give the same compiled scene and camera."""
    import chip_smoke
    from cuda_pt_torch.scene import types as TT

    make = {"cornell": lambda: t_ts.cornell_box(8, 8),
            "kitchen": lambda: t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4),
            "grid": lambda: t_ts.grid_smoke(8, 8, n=16)}[name]
    scene, _, b = make()
    view = dict(chip_smoke.XML_VIEWS[name], fov=40.0)
    path = chip_smoke.write_scene_xml(TT, b, str(tmp_path), name, view, 12,
                                      rtype="vpt" if name == "grid" else "pt")
    pt, pj = t_xml.load_xml(path), j_xml.load_xml(path)
    np.testing.assert_array_equal(chip_smoke._tri_rows(pt.scene), chip_smoke._tri_rows(scene))
    _scenes_equal(pt.scene, pj.scene)
    for k, v in flatten_jax_camera(pj.camera).items():
        got = getattr(pt.camera, k)
        np.testing.assert_array_equal(got.numpy() if torch.is_tensor(got) else got, v, k)
    if name == "grid":
        np.testing.assert_array_equal(pt.scene.grids.density[0].numpy(), b.grids[0]["density"])
    if name == "kitchen":
        # 8-bit sRGB textures within half a step (0.005 in linear terms), the
        # RGBE sky within one mantissa step of its pixel's largest channel
        got, want = pt.scene.textures.texels.numpy()[:, :3], scene.textures.texels.numpy()[:, :3]
        step = 0.005 + want.max(axis=1, keepdims=True) / 128
        assert (np.abs(got - want) <= step).all()
