"""The port's web viewer (cuda_pt_torch/viewer/server.py) against the
reference's ViewerState, and its hot reload on the kernel route.

Contracts: every table edit, camera move / rotate, depth cap and ToF
window leaves the Renderer's tables, camera and md equal to the reference
ViewerState's after the same messages (eager arrays, no JAX render); the
first pass after an emitter, material or medium edit equals, bit for bit
per lane, pass 0 of a fresh Renderer built on the edited scene, on the
CPU's kernel route (the kernels' plain versions); a ToF window or a
family outside the kernel moves the Renderer to the composed route and
info() says so; under traversal="fused" such an edit is refused (HTTP
400) and the Renderer stays as it was; the endpoints serve, accumulate
and hot-reload end to end in a thread, as tests/test_viewer.py drives
the reference's."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core import film as t_film
from cuda_pt_torch.core.config import MaxDepthParams, RenderingConfig
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene import types as TT
from cuda_pt_torch.scene.xml_parser import ParsedScene
from cuda_pt_torch.utils.image import decode_png
from cuda_pt_torch.viewer.server import ThreadingHTTPServer, ViewerState, make_handler
from cuda_pt_tpu.api import Renderer as JRenderer
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.core.config import RenderingConfig as JRC
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene.xml_parser import ParsedScene as JParsed
from cuda_pt_tpu.viewer.server import ViewerState as JViewerState

SIZE = 16
MD = dict(max_depth=3)
EDITS = {
    "emitter": {"kind": "emitter", "id": 1, "field": "scaler", "value": 25.0},
    "bsdf": {"kind": "bsdf", "id": 1, "field": "k_d", "value": [0.9, 0.2, 0.1]},
    "medium": {"kind": "medium", "id": 0, "field": "scale", "value": 3.0},
}


def _parsed(md=None, scene_fn=t_ts.cornell_box):
    scene, cam, _ = scene_fn(SIZE, SIZE)
    return ParsedScene(scene, cam, RenderingConfig(width=SIZE, height=SIZE, seed=5,
                                                   md=md or MaxDepthParams(**MD)))


def _edited(parsed, msg):
    """parsed with msg's table row set, as a fresh scene would carry it."""
    name = {"emitter": "emitters", "bsdf": "bsdfs", "medium": "media"}[msg["kind"]]
    table = getattr(parsed.scene, name)
    col = getattr(table, msg["field"]).clone()
    col[msg["id"]] = torch.as_tensor(msg["value"], dtype=col.dtype)
    scene = dataclasses.replace(parsed.scene,
                                **{name: dataclasses.replace(table, **{msg["field"]: col})})
    return dataclasses.replace(parsed, scene=scene)


def test_edits_match_reference_state():
    """The same messages through both ViewerStates (threads not started):
    tables, camera and md equal."""
    sj, cj, _ = j_ts.cornell_box(SIZE, SIZE)
    js = JViewerState(JRenderer(JParsed(sj, cj, JRC(width=SIZE, height=SIZE, md=JMD(**MD)),
                                        None)))
    ts = ViewerState(Renderer(_parsed(), device="cpu"))
    msgs = [EDITS["emitter"], EDITS["bsdf"], EDITS["medium"],
            {"kind": "camera_move", "delta": [0.1, -0.05, 0.3]},
            {"kind": "camera_rotate", "yaw": 0.12, "pitch": -0.2},
            {"kind": "max_depth", "field": "max_diffuse", "value": 2},
            {"kind": "tof", "min_time": 0.5, "max_time": 6.0},
            {"kind": "colormap", "value": "magma"}, {"kind": "tonemap", "value": "aces"}]
    for m in msgs:
        js.update(m)
        ts.update(m)
    jr, tr = js.renderer, ts.renderer
    for name, field in (("emitters", "scaler"), ("bsdfs", "k_d"), ("media", "scale")):
        np.testing.assert_array_equal(getattr(getattr(tr.scene, name), field).numpy(),
                                      np.asarray(getattr(getattr(jr.scene, name), field)))
    for f in ("R", "t"):
        np.testing.assert_allclose(getattr(tr.camera, f).numpy(), np.asarray(getattr(jr.camera, f)),
                                   rtol=0, atol=1e-6)
    assert dataclasses.asdict(tr.md) == dataclasses.asdict(jr.md)
    assert ts.scene_json() == js.scene_json()
    assert (ts.colormap, ts.tonemap, ts.dirty) == ("magma", "aces", True)
    # the tables were swapped, not written: the parsed scene keeps its rows
    assert float(tr.parsed.scene.emitters.scaler[1]) != 25.0


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_edit_reaches_the_kernel_route(edit):
    """The first pass after the edit, on the kernel route (K2's plain
    version here), equals pass 0 of a fresh Renderer on the edited scene
    lane for lane; the generation bumps and the film restarts."""
    parsed = _parsed()
    state = ViewerState(Renderer(parsed, device="cpu"))
    r = state.renderer
    assert r.info()["traversal"] == "fused"
    state.step()
    state.step()
    assert r.counter() == 2 and state.first_pass[0] == 0
    pack0 = r._pack
    state.update(EDITS[edit])
    assert r._pack is not pack0 and r.fused
    state.step()
    gen, img = state.first_pass
    assert gen == 1 and r.counter() == 1
    fresh = Renderer(_edited(parsed, EDITS[edit]), device="cpu")
    want = fresh.render_raw()
    assert torch.equal(img, want)
    before = Renderer(parsed, device="cpu").render_raw()
    assert edit == "medium" or not torch.equal(want, before)  # cornell has no medium to show it


def test_tof_and_family_move_the_route():
    """A ToF window and a BSDF type outside the kernel move the default
    Renderer to the composed route; under traversal="fused" both are
    refused and nothing changes; a family switch re-routes and back."""
    state = ViewerState(Renderer(_parsed(), device="cpu"))
    r = state.renderer
    state.update({"kind": "tof", "min_time": 0.5, "max_time": 6.0})
    assert (r.info()["traversal"], r.info()["driver"], r._pack) == ("xla", "composed", None)
    state.update({"kind": "tof", "min_time": 0.0, "max_time": 0.0})
    assert r.info()["traversal"] == "fused"
    state.update({"kind": "bsdf", "id": 1, "field": "btype", "value": TT.BSDF_PLASTIC_FORWARD})
    assert r.info()["driver"] == "composed"
    assert TT.BSDF_PLASTIC_FORWARD in r.scene.present_bsdfs
    state.step()
    assert np.isfinite(r.film.mean.numpy()).all()
    state.update({"kind": "renderer", "value": "depth"})
    assert (r.info()["renderer"], r.info()["driver"]) == ("depth", "composed")

    fused = ViewerState(Renderer(_parsed(), traversal="fused", device="cpu"))
    fr = fused.renderer
    pack, md, scene = fr._pack, fr.md, fr.scene
    for msg in ({"kind": "tof", "min_time": 0.5, "max_time": 6.0},
                {"kind": "bsdf", "id": 1, "field": "btype", "value": TT.BSDF_PLASTIC_FORWARD},
                {"kind": "renderer", "value": "depth"}):
        with pytest.raises(ValueError, match="envelope|requires the megakernel"):
            fused.update(msg)
        assert fr._pack is pack and fr.md is md and fr.scene is scene and fr.fused
    assert not fused.dirty


@pytest.fixture(scope="module")
def served():
    state = ViewerState(Renderer(_parsed(), device="cpu"))
    state.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield state, port
    state.stop.set()
    httpd.shutdown()
    httpd.server_close()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def _post(port, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/update",
                                 data=json.dumps(obj).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def _wait(cond, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.05)
    assert cond()


def test_viewer_serves_and_accumulates(served):
    state, port = served
    assert b"<canvas" in _get(port, "/") and b"cuda_pt_torch viewer" in _get(port, "/")
    _wait(lambda: state.renderer.counter() >= 2)
    info = json.loads(_get(port, "/info"))
    assert info["spp"] >= 2 and info["traversal"] == "fused" and info["error"] is None
    assert info["ms_per_pass"] > 0.0
    img = decode_png(_get(port, "/frame.png"))
    assert img.shape == (SIZE, SIZE, 3) and img.dtype == np.uint8 and img.max() > 0
    scene = json.loads(_get(port, "/scene"))
    assert len(scene["bsdfs"]) >= 4 and scene["md"]["max_depth"] == 3.0
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nothing")
    assert e.value.code == 404


def test_viewer_hot_reload_over_http(served):
    """An emitter edit posted over HTTP: the table swapped by the time the
    POST returns, the generation bumps, accumulation restarts; the frame is
    the film's sRGB export."""
    state, port = served
    _wait(lambda: state.renderer.counter() >= 2)
    g0 = state.generation
    _post(port, {"kind": "emitter", "id": 1, "field": "scaler", "value": 20.0})
    assert float(state.renderer.scene.emitters.scaler[1]) == 20.0
    _wait(lambda: state.generation > g0 and state.renderer.counter() >= 1)
    _post(port, {"kind": "camera_move", "delta": [0.0, 0.0, 0.2]})
    _post(port, {"kind": "denoise", "value": True})
    gen = state.generation
    _wait(lambda: state.generation > gen and state.renderer.counter() >= 2)
    assert decode_png(_get(port, "/frame.png")).shape == (SIZE, SIZE, 3)
    _post(port, {"kind": "denoise", "value": False})
    _post(port, {"kind": "tonemap", "value": "aces"})
    state.stop.set()
    state.thread.join(timeout=60)
    with state.lock:
        png, r = state.png, state.renderer
        want = t_film.to_srgb(r.film.mean, gamma=r.config.gamma, tonemap="aces")
    if state.dirty:  # the last edit's pass was dropped: render one frame for it
        state.step()
        png = state.png
        want = t_film.to_srgb(r.film.mean, gamma=r.config.gamma, tonemap="aces")
    np.testing.assert_array_equal(decode_png(_get(port, "/frame.png")), decode_png(png))
    np.testing.assert_array_equal(decode_png(png),
                                  (want * 255.0 + 0.5).to(torch.uint8).numpy())
    state.start()


def test_viewer_refuses_bad_edits_with_400(served):
    state, port = served
    for msg in ({"kind": "max_depth", "field": "max_colour", "value": 3},
                {"kind": "sampler", "value": "halton"},
                {"kind": "emitter", "id": 1, "field": "no_such_field", "value": 1.0}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, msg)
        assert e.value.code == 400
    _post(port, {"kind": "sampler", "value": "sobol"})
    assert state.renderer.sampler == "sobol"
    _post(port, {"kind": "max_depth", "field": "max_depth", "value": 2})
    _post(port, {"kind": "sampler", "value": "pcg"})
    gen = state.generation
    _wait(lambda: state.generation > gen and state.renderer.counter() >= 1)
    assert state.error is None and np.isfinite(state.renderer.film.mean.numpy()).all()


def test_viewer_entry_arguments(monkeypatch):
    """python -m cuda_pt_torch.viewer --xml ... serves the XML scene at the
    asked side and port, on the asked device (the reference's scripts/
    viewer.py arguments, --device in place of --cpu)."""
    from cuda_pt_torch.viewer import __main__ as entry

    calls = []
    monkeypatch.setattr(entry, "serve", lambda *a, **k: calls.append((a, k)))
    assert entry.main(["--xml", "s.xml", "--port", "8123", "--width", "32", "--height", "24",
                       "--device", "cpu"]) == 0
    assert calls == [(("s.xml",), {"port": 8123, "override_res": (32, 24), "device": "cpu"})]
