"""The film's tail (cuda_pt_torch/core/film.py) and the drop-in surface
(cuda_pt_torch/pyrender.py): to_srgb's gamma and ACES against JAX,
checkpoints that cross between the two packages both ways, resume equal
to straight rendering bit for bit (the reference's
tests/test_tof_checkpoint.py, Renderer form included), and
PythonRenderer on the CPU. No Pallas call."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core import film as t_film
from cuda_pt_torch.core.config import MaxDepthParams, RenderingConfig
from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.pyrender import PythonRenderer
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene.xml_parser import ParsedScene
from cuda_pt_tpu.core import film as j_film


def _radiance(seed: int, shape=(6, 5, 3)) -> np.ndarray:
    """Radiance with highlights far above 1 and a few zeros."""
    rs = np.random.default_rng(seed)
    x = rs.exponential(0.6, shape).astype(np.float32)
    x[rs.random(shape) < 0.05] = 0.0
    x[rs.random(shape) < 0.05] *= 40.0
    return x


def _parsed(w=8, h=8, depth=3):
    scene, cam, _ = t_ts.cornell_box(w, h)
    return ParsedScene(scene, cam, RenderingConfig(width=w, height=h,
                                                   md=MaxDepthParams(max_depth=depth)))


@pytest.mark.parametrize("tonemap", ["gamma", "aces"])
@pytest.mark.parametrize("gamma", [True, False])
def test_to_srgb_matches_jax(tonemap, gamma):
    x = _radiance(1)
    want = np.asarray(j_film.to_srgb(jnp.asarray(x), gamma=gamma, tonemap=tonemap))
    got = t_film.to_srgb(torch.as_tensor(x), gamma=gamma, tonemap=tonemap).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    assert got.min() >= 0.0 and got.max() <= 1.0


def _films(n: int = 3):
    ft, fj = t_film.make_film(6, 5), j_film.make_film(6, 5)
    for i in range(n):
        x = _radiance(10 + i)
        ft = t_film.accumulate(ft, torch.as_tensor(x))
        fj = j_film.accumulate(fj, jnp.asarray(x))
    return ft, fj


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port writes the reference's keys and dtypes (count an int32
    scalar); JAX's load_checkpoint reads the same film."""
    ft, _ = _films()
    path = str(tmp_path / "port.npz")
    t_film.save_checkpoint(ft, path)
    z = np.load(path)
    assert sorted(z.files) == ["count", "m2", "mean", "weight"]
    assert z["count"].dtype == np.int32 and z["count"].shape == ()
    assert all(z[k].dtype == np.float32 for k in ("mean", "m2", "weight"))
    g = j_film.load_checkpoint(path)
    assert int(g.count) == 3 and g.count.dtype == jnp.int32
    for k in ("mean", "m2", "weight"):
        np.testing.assert_array_equal(np.asarray(getattr(g, k)), getattr(ft, k).numpy())


def test_jax_checkpoint_loads_in_port(tmp_path):
    """A JAX checkpoint loads onto the caller's device with a Python int
    count, and accumulation continues as JAX's does."""
    _, fj = _films()
    path = str(tmp_path / "jax.npz")
    j_film.save_checkpoint(fj, path)
    g = t_film.load_checkpoint(path, device="cpu")
    assert g.count == 3 and isinstance(g.count, int) and g.mean.device.type == "cpu"
    for k in ("mean", "m2", "weight"):
        np.testing.assert_array_equal(getattr(g, k).numpy(), np.asarray(getattr(fj, k)))
    x = _radiance(20)
    g = t_film.accumulate(g, torch.as_tensor(x))
    fj = j_film.accumulate(fj, jnp.asarray(x))
    np.testing.assert_allclose(g.mean.numpy(), np.asarray(fj.mean), rtol=1e-6)
    np.testing.assert_allclose(t_film.variance(g).numpy(), np.asarray(j_film.variance(fj)),
                               rtol=1e-5, atol=1e-7)


def test_film_checkpoint_resume_bit_equal(tmp_path):
    """Three passes, a checkpoint, two more passes from it: bit for bit the
    five straight passes (the reference's test_film_checkpoint_roundtrip)."""
    p = _parsed()
    md = p.config.md

    def passes(film, idx):
        for i in idx:
            film = t_film.accumulate(film, t_pt.render_sample(p.scene, p.camera, md, 0, i,
                                                              use_bvh=False))
        return film

    f = passes(t_film.make_film(8, 8), range(3))
    path = str(tmp_path / "ckpt.npz")
    t_film.save_checkpoint(f, path)
    g = passes(t_film.load_checkpoint(path), range(3, 5))
    h = passes(t_film.make_film(8, 8), range(5))
    assert g.count == h.count == 5
    for k in ("mean", "m2", "weight"):
        assert torch.equal(getattr(g, k), getattr(h, k)), k


def test_renderer_checkpoint_resume_bit_equal(tmp_path):
    """Renderer.render(2), save_checkpoint, load_checkpoint into a fresh
    Renderer, render(2): the film of four straight passes, bit for bit, on
    the Renderer's device (the kernel route's plain version here)."""
    p = _parsed()
    r = Renderer(p, device="cpu")
    r.render(2)
    path = str(tmp_path / "film.npz")
    r.save_checkpoint(path)
    r2 = Renderer(p, device="cpu")
    r2.load_checkpoint(path)
    assert r2.counter() == 2 and r2.film.mean.device == r2.device
    r2.render(2)
    r4 = Renderer(p, device="cpu")
    r4.render(4)
    assert r2.counter() == r4.counter() == 4
    for k in ("mean", "m2", "weight"):
        assert torch.equal(getattr(r2.film, k), getattr(r4.film, k)), k


def test_python_renderer_on_the_cpu():
    """render: (H, W, 4) float32, RGB the film's mean and alpha its weight;
    variance: (H, W, 1) float32, the film's; keyword arguments reach the
    Renderer."""
    pr = PythonRenderer(_parsed(8, 6), device="cpu", sampler="sobol")
    for k in (1, 2):
        img = pr.render()
        assert img.shape == (6, 8, 4) and img.dtype == np.float32
        np.testing.assert_array_equal(img[..., 3], np.full((6, 8), float(k), np.float32))
    r = pr._r
    np.testing.assert_array_equal(img[..., :3], r.film.mean.numpy())
    var = pr.variance()
    assert var.shape == (6, 8, 1) and var.dtype == np.float32
    np.testing.assert_array_equal(var[..., 0], t_film.variance(r.film).numpy())
    assert pr.counter() == 2 and pr.avg_frame_time() > 0.0
    assert pr.info()["sampler"] == "sobol" and pr.info()["device"] == "cpu"
    pr.release()
    assert r.film is None


def test_python_renderer_device_and_xml():
    """device_id picks cuda:<id> unless device= is given (CUDA is absent
    here, so the Renderer refuses it); an XML path goes to the parser,
    which raises for a file that is not there."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PythonRenderer(_parsed(), device_id=0)
    with pytest.raises(FileNotFoundError, match="scene.xml"):
        PythonRenderer("scene.xml", device="cpu")
