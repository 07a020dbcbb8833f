"""The port's command-line tools (cuda_pt_torch/scripts/) that need no JAX
render: their scenes and rays against the JAX scripts' on the same inputs,
and a tiny --device cpu run of the rest, whose output must carry the JAX
script's schema (the keys, config names and order of the JSON files that
script wrote into the repo, read here, never written).

Tolerances, fixed before any run:
- showcase.build_scene and scenes.slot_scene: every table of the compiled
  scene equal to the JAX one's, ints exact, floats within 1e-6;
- sbvh_budget_sweep.measure at two budgets on a 1,568-prim XML (cornell
  and a torus; the SBVH is deterministic at this size): refs, nodes and
  SAH equal those of JAX's builder.compile(bvh_cfg=...) (no JAX walk);
- packet_divergence on cornell at 16x16: make_rays (camera and one-bounce
  rays) within 1e-6 of JAX's; the lane orders of JAX's measure (its K1
  and walk stubbed out) equal to the port's on the same rays; the packet
  counts from the plain packet form (tests/test_torch_forest.py holds it
  to JAX's interpret kernel);
- quality_bench, guiding_study (one short schedule), compaction_sweep,
  profile_render and interactive_probe: the schema, and the invariants
  that hold (the sorted and compacted wavefront images equal the no-sort
  image, the guided mean drift finite, the trace file written);
- --help of the eleven tools, and main() without --device raising where
  CUDA is absent."""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch

from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scripts import (compaction_sweep, guiding_study, interactive_probe,
                                   packet_divergence, profile_render, quality_bench,
                                   sbvh_budget_sweep, scenes, showcase)
from cuda_pt_tpu.accel import bvh_build as j_bvh_build
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import xml_parser as j_xml
from test_torch_bridge import REPO, TABLES, flatten_jax_scene, jax_script
from test_torch_scene_input import _cornell_xml, _write_obj

TOOLS = ("scene_info", "serial_render", "analyze_rays", "showcase", "quality_bench",
         "guiding_study", "compaction_sweep", "sbvh_budget_sweep", "packet_divergence",
         "profile_render", "interactive_probe")


def _committed(name: str):
    """A JSON file the JAX script wrote into the repo (read only)."""
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def _tables_close(st, sj):
    """Every table of the port's scene against the JAX scene's: ints (and
    bools) exact, floats within 1e-6."""
    flat = flatten_jax_scene(sj)
    for name in TABLES:
        table = getattr(st, name)
        if table is None:
            assert flat.get(f"{name}.row_cdf") is None
            continue
        for f in dataclasses.fields(table):
            got = getattr(table, f.name)
            got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
            want = np.asarray(flat[f"{name}.{f.name}"])
            key = f"{name}.{f.name}"
            assert got.shape == want.shape, key
            if np.issubdtype(want.dtype, np.floating):
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=key)
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)
    assert (st.env_emitter, st.cam_medium, st.num_emitters) == (
        flat["env_emitter"], flat["cam_medium"], flat["num_emitters"])
    assert st.present_bsdfs == flat["present_bsdfs"]


def _cams_close(ct, cj):
    for f in ("R", "t", "focal"):
        np.testing.assert_allclose(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    assert (ct.width, ct.height) == (int(cj.width), int(cj.height))


def test_showcase_scene_matches_reference():
    st, ct = showcase.build_scene()
    sj, cj = jax_script("showcase").build_scene()
    _tables_close(st, sj)
    _cams_close(ct, cj)
    assert st.geom.num_prims == 17 and len(st.present_bsdfs) >= 5


def test_slot_scene_matches_reference():
    from test_guiding import _slot_scene

    st, ct = scenes.slot_scene()
    sj, cj = _slot_scene()
    _tables_close(st, sj)
    _cams_close(ct, cj)


@pytest.fixture(scope="module")
def torus_xml(tmp_path_factory):
    """cornell_box as OBJ files plus a 1,536-triangle torus."""
    d = tmp_path_factory.mktemp("sbvh")
    text = _cornell_xml(str(d))
    tris, _, _ = t_ts._torus_mesh((0.5, 0.35, 0.5), 0.25, 0.08, 48, 16)
    _write_obj(str(d / "torus.obj"), tris)
    text = text.replace("<sensor>", '<shape type="obj"><string name="filename" '
                        'value="torus.obj"/><ref type="material" id="white"/></shape>\n<sensor>')
    path = str(d / "torus.xml")
    with open(path, "w") as f:
        f.write(text)
    return path


def test_sbvh_budget_sweep_matches_reference(torus_xml, capsys):
    budgets = [0.0, 0.3]
    rows = sbvh_budget_sweep.measure(torus_xml, "cpu", budgets)
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == [{"scene": "torus.xml", **r} for r in rows]
    assert list(rows[0]) == list(next(iter(_committed("SBVH_BUDGET.json").values()))[0])
    for row, budget in zip(rows, budgets):
        ps = j_xml.load_xml(torus_xml, override_res=(128, 128))
        cfg = dataclasses.replace(ps.config.bvh, use_sbvh=True, dup_budget_frac=budget)
        sj = ps.builder.compile(bvh_cfg=cfg)
        nodes = {k: np.asarray(getattr(sj.bvh, k))
                 for k in ("node_min", "node_max", "node_skip", "node_base", "node_count")}
        assert row["budget"] == budget
        assert row["refs"] == int(sj.geom.num_prims) and row["nodes"] == int(sj.bvh.num_nodes)
        assert row["sah"] == round(float(j_bvh_build.sah_cost(nodes)), 2)
        assert row["mean_node_tests"] > 0 and row["mean_prim_tests"] > 0 and row["ms"] > 0
    assert rows[0]["refs"] == 1568 and rows[1]["refs"] > rows[0]["refs"]


def test_packet_divergence_matches_reference(monkeypatch):
    jpd = jax_script("packet_divergence")
    sj, cj, _ = j_ts.cornell_box(width=16, height=16)
    st, ct, _ = t_ts.cornell_box(width=16, height=16)
    rays_j = jpd.make_rays(sj, cj, seed=3)
    rays_t = packet_divergence.make_rays(st, ct, seed=3)
    for (oj, dj), (ot, dt) in zip(rays_j, rays_t):
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-6)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    # JAX's lane orders: its measure with the K1 count and the walk stubbed
    seen = []
    monkeypatch.setattr(jpd, "packet_fetches", lambda f, o, d, order, tile=None:
                        seen.append(np.asarray(order)) or 1)
    monkeypatch.setattr(jpd, "perlane_tests", lambda *a: (0, 0))
    names = ("scanline", "shuffled", "morton", "morton_octant")
    forest = packet_divergence.load_scene("cornell", 16)[2]
    rng_j, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    for (oj, dj), case in zip(rays_j, ("primary", "secondary")):
        seen.clear()
        jpd.measure(case, sj, cj, None, (oj, dj), rng_j)
        o, d = torch.from_numpy(np.array(oj)), torch.from_numpy(np.array(dj))
        orders = packet_divergence.lane_orders(st, o, d, rng_t)
        assert list(orders) == list(names)
        for k, want in zip(names, seen[:4]):
            np.testing.assert_array_equal(orders[k].numpy(), want, err_msg=k)
        assert not np.array_equal(seen[1], np.arange(256))
        # the port's row on the same rays (the plain packet form)
        row = packet_divergence.measure(case, st, ct, forest, (o, d), np.random.default_rng(7))
        fetches = row["packet_node_fetches"]
        assert list(fetches) == [*names, "morton_octant_tile256", "morton_octant_tile128"]
        assert all(v > 0 for v in fetches.values()) and row["tiles"] == 1
        assert row["xla_perlane_node_tests"] > 0 and row["xla_loop_iters"] > 0


def test_quality_bench_schema(tmp_path, capsys):
    out = str(tmp_path / "q.json")
    assert quality_bench.main(["--width", "4", "--budgets", "4", "--out", out,
                               "--device", "cpu"]) == 0
    got, want = json.loads(open(out).read()), _committed("QUALITY_BENCH.json")
    assert list(got) == list(want) and got["reference_spp"] == 1024
    assert [r["config"] for r in got["rows"]] == [r["config"] for r in want["rows"][:7]]
    assert [list(r) for r in got["rows"]] == [list(r) for r in want["rows"][:7]]
    assert [r["config"] for r in got["time_to_quality"]] == [
        r["config"] for r in want["time_to_quality"]]
    assert [list(r) for r in got["time_to_quality"]] == [list(r) for r in want["time_to_quality"]]
    assert got["rows"][0]["vs_uniform_pcg"] == 1.0 and all(
        np.isfinite(r["mse"]) and r["mse"] > 0 for r in got["rows"])
    # uniform_pcg reaches its own largest-budget MSE at that budget
    assert got["time_to_quality"][0]["spp_to_target"] == 4
    assert capsys.readouterr().out.count("\n") == 7 + 3 + 1
    assert quality_bench.ref_samples_per_pass(64 * 64) == 64


def test_guiding_study_short_schedule(tmp_path, monkeypatch):
    monkeypatch.setattr(guiding_study, "SCHEDULES", ((2, 5),))
    out = str(tmp_path / "g.json")
    assert guiding_study.main(["--seeds", "2", "--spp", "1", "--out", out, "--device",
                               "cpu"]) == 0
    got, want = json.loads(open(out).read()), _committed("GUIDING_STUDY.json")
    assert list(got) == list(want) and got["n_seeds"] == 2 and got["render_spp"] == 1
    assert [r["config"] for r in got["rows"]] == ["unguided", "fit_spp2_steps5"]
    assert [list(r) for r in got["rows"]] == [list(r) for r in want["rows"][:2]]
    guided = got["rows"][1]
    assert np.isfinite(guided["mean_drift"]) and np.isfinite(guided["fit_loss"])
    assert guided["var"] > 0 and abs(got["best_equal_time_win"] - guided["equal_time_win"]) <= 5e-4
    assert got["verdict"] in ("pays", "experimental-off-by-default (<1.3x equal-time win)")


def test_compaction_sweep_images_and_schema(tmp_path, capsys, monkeypatch):
    import cuda_pt_torch.scripts as tools

    monkeypatch.setattr(tools, "REFERENCE_XML_DIR", str(tmp_path))  # its VPT half on cornell
    images = {}
    res = compaction_sweep.sweep(6, 1, 6, 4, "cpu", images)
    assert list(res) == ["wf_depth6_nosort", "wf_depth6_sorted", "wf_depth6_compact",
                         "vpt_depth4_plain", "vpt_depth4_compact"]
    assert all(v >= 0 for v in res.values()) and list(images) == list(res)
    base = images["wf_depth6_nosort"]
    assert float(base.mean()) > 0
    assert torch.equal(images["wf_depth6_sorted"], base)
    assert torch.equal(images["wf_depth6_compact"], base)
    assert torch.equal(images["vpt_depth4_compact"], images["vpt_depth4_plain"])
    out = str(tmp_path / "c.json")
    capsys.readouterr()
    assert compaction_sweep.main(["--res", "4", "--spp", "1", "--wf-depth", "3", "--vpt-depth",
                                  "3", "--json", out, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == json.loads(open(out).read()) and len(lines) == 6


def test_profile_render_trace(tmp_path, capsys):
    res = profile_render.profile("cornell", "pallas", "pcg", 1, 4, str(tmp_path / "tr"), "cpu")
    assert os.path.isfile(res["trace"]) and res["ms"] > 0 and res["top"]
    with open(res["trace"]) as f:
        assert "traceEvents" in json.load(f)
    text = capsys.readouterr().out
    assert "trace written to" in text and "aten::" in text


def test_interactive_probe_schema(tmp_path):
    out = str(tmp_path / "i.json")
    assert interactive_probe.main(["--width", "8", "--frames", "2", "--out", out, "--device",
                                   "cpu"]) == 0
    got = json.loads(open(out).read())
    assert list(got) == list(_committed("INTERACTIVE_PROBE.json"))
    assert got["backend"] == "cpu" and got["traversal"] == "fused" and got["fps"] > 0
    assert got["frames"] == 2 and np.isfinite(got["film_mean"]) and got["film_mean"] > 0


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_help_and_cuda_default(tool, capsys, monkeypatch):
    """--help exits 0; without --device the tool wants CUDA and raises
    where it is absent (every tool's main resolves the device first)."""
    mod = importlib.import_module(f"cuda_pt_torch.scripts.{tool}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0 and "--device" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"scene_info": ["--xml", "x.xml"], "serial_render": ["--xml", "x.xml"],
            "analyze_rays": ["--xml", "x.xml"], "sbvh_budget_sweep": ["x.xml"]}.get(tool, [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)


def test_reference_scenes_absent_stop_naming_the_path(tmp_path, monkeypatch):
    """The tools that read the reference renderer's own XMLs stop naming the
    missing path, in a directory without them and with CUDA_PT_REFERENCE_XML
    unset (no directory: nothing beside the checkout is read);
    compaction_sweep falls back to cornell (its sweep test)."""
    import cuda_pt_torch.scripts as tools

    for where in (str(tmp_path), None):
        monkeypatch.setattr(tools, "REFERENCE_XML_DIR", where)
        for mod, argv, name in ((sbvh_budget_sweep, [], "whiskey.xml"),
                                (packet_divergence, ["--scene", "whiskey"], "whiskey.xml"),
                                (profile_render, ["--scene", "bunny"], "bunny.xml")):
            with pytest.raises(SystemExit, match="no such scene file") as e:
                mod.main([*argv, "--device", "cpu"])
            assert os.path.join(where or "$CUDA_PT_REFERENCE_XML", name) in str(e.value)
        assert tools.reference_xml("medium-cbox.xml", required=False) is None
