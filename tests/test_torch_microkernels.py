"""The port's micro-kernels S2, S3 and S4 against the reference's Pallas
kernels, run on the CPU in interpret mode.

- S2 (ops/extract_ab.py): each variant of scripts/exp_extract_ab.py's
  _make_kernel under pl.pallas_call(interpret=True) on cornell's binary f32
  rows, one (1, 2, 128) tile of random rays, 16 steps, against the port's
  plain version bit for bit; v0 also on the reference's equal rays.
- S3 (ops/lanegather.py): scripts/exp_lanegather.py's main() with
  pallas_call in interpret mode and its timing patched to record each
  jitted kernel's output; every tag bit for bit against the plain version,
  the gather also against np.take_along_axis.
- S4 (ops/mxuleaf.py): scripts/exp_r5_mxuleaf.py's main() the same way at
  R = 1 and NLEAF = 16, its REPO pointed at a temporary directory (main()
  writes its JSON there); the tables it times equal make_inputs's, the
  scalar plain version against kern_scalar (hit mask equal, t within rtol
  1e-6: XLA fuses multiply-adds on the CPU, the port rounds each product),
  the mxu plain version against kern_mxu (hit mask equal, t within rtol
  1e-5: both products are f32 sums of the same terms in other orders).

The scripts are loaded with importlib; nothing in them or in the JAX
package changes. The file takes a few seconds.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cuda_pt_torch.ops import extract_ab as t_ab
from cuda_pt_torch.ops import lanegather as t_lg
from cuda_pt_torch.ops import mxuleaf as t_mx
from cuda_pt_torch.ops import node_bench as t_nb
from cuda_pt_torch.ops import traverse_kernel as t_tk
from cuda_pt_torch.scene import bridge
from cuda_pt_tpu.utils import timing as j_timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S3_TAGS = ("e0", "g1", "g4", "g14", "w14", "w112")  # the order exp_lanegather.main() times them


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"{name}_ref", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record_main(monkeypatch, mod):
    """Run mod.main() with pallas_call in interpret mode; timing.timeit
    records (args, output) of each call it is handed and times nothing."""
    calls = []

    def timeit(f, *args, reps=5):
        calls.append((args, np.asarray(f(*args))))
        return 1.0

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(j_timing, "timeit", timeit)
    monkeypatch.setattr(j_timing, "warm_readback", lambda: 0.0)
    mod.main()
    monkeypatch.undo()
    return calls


def test_lanegather_plain_matches_jax_interpret(monkeypatch, capsys):
    """S3: every reference tag's output bit for bit; the check gather equal
    to np.take_along_axis, as the script's own check says."""
    calls = _record_main(monkeypatch, _script("exp_lanegather"))
    lines = capsys.readouterr().out
    assert '"gather_bit_exact", "ok": true' in lines
    assert len(calls) == len(S3_TAGS)
    x, row, idx = t_lg.make_inputs()
    for tag, (args, out_j) in zip(S3_TAGS, calls):
        for a, b in zip(args, (x, row, idx)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        out_t = t_lg.lanegather(tag, x, row, idx).numpy()
        np.testing.assert_array_equal(out_t.view(np.uint32), out_j.view(np.uint32), err_msg=tag)
    for tag in ("s1", "s4", "s14"):  # the port's shuffle forms: the gN outputs
        g = t_lg.lanegather("g" + tag[1:], x, row, idx, 8)
        assert torch.equal(t_lg.lanegather(tag, x, row, idx, 8), g)
    got = t_lg.gather(row, idx).numpy()
    want = np.take_along_axis(np.broadcast_to(row.numpy(), idx.shape), idx.numpy(), axis=1)
    np.testing.assert_array_equal(got, want)  # and kern_chk equals want: the script's check


@pytest.fixture(scope="module")
def cornell_rows():
    """Cornell's binary f32 node rows: the port's pack_nodes on the bridged
    scene, equal to the reference's."""
    from cuda_pt_tpu.ops.pallas import traverse_kernel as j_tk
    from cuda_pt_tpu.scene import testscenes as j_ts
    from test_torch_bridge import flatten_jax_scene

    sj, _, _ = j_ts.cornell_box(8, 8)
    nodes = t_tk.pack_nodes(bridge.scene_from_numpy(flatten_jax_scene(sj)).bvh)
    np.testing.assert_array_equal(nodes, np.asarray(j_tk.pack_nodes(sj.bvh)))
    return nodes


def _s2_rays(equal: bool):
    """One tile of 256 lanes: the reference's equal rays, or random rays
    around the cornell box (some miss it) from a numpy seed -> (o, d)
    (256, 3) float32."""
    if equal:
        return tuple(t.numpy() for t in t_nb.reference_rays(256))
    rs = np.random.default_rng(17)
    o = rs.uniform(-1.0, 2.0, (256, 3)).astype(np.float32)
    d = rs.normal(size=(256, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _s2_jax(mod, tag: str, nodes, o, d, n_iters: int):
    variant, n_ptr = t_ab.TAGS[tag]
    kern = mod._make_kernel(variant, n_iters, nodes.shape[0], n_ptr)
    planes = [jnp.asarray(a[:, k].reshape(1, 2, 128)) for a in (o, d) for k in range(3)]
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((1, 2, 128), jnp.float32), interpret=True,
    )(jnp.asarray(nodes), *planes)).reshape(-1)


@pytest.mark.parametrize("tag", list(t_ab.TAGS))
def test_extract_ab_plain_matches_jax_interpret(cornell_rows, tag):
    """S2: each tag's 16 steps on one tile of 256 random rays, bit for bit.
    The tile's vote steers the walk: lanes that miss every box it visits
    end at 0 beside lanes that hit."""
    o, d = _s2_rays(False)
    out_j = _s2_jax(_script("exp_extract_ab"), tag, cornell_rows, o, d, 16)
    out_t = t_ab.extract_ab(tag, torch.as_tensor(cornell_rows), torch.as_tensor(o),
                            torch.as_tensor(d), 16, tile=256).numpy()
    np.testing.assert_array_equal(out_t.view(np.uint32), out_j.view(np.uint32))
    if tag in ("v0", "v1", "v2", "w2"):
        assert 0 < int((out_t != 0).sum()) < 256  # some lanes hit a box, some never did


def test_extract_ab_equal_rays_match_jax_and_s1(cornell_rows):
    """S2 on the reference's equal rays: v0 bit for bit against the JAX
    kernel and against S1 (the same walk with a per-ray pointer)."""
    o, d = _s2_rays(True)
    nodes = torch.as_tensor(cornell_rows)
    out_j = _s2_jax(_script("exp_extract_ab"), "v0", cornell_rows, o, d, 40)
    out_t = t_ab.extract_ab("v0", nodes, torch.as_tensor(o), torch.as_tensor(d), 40, tile=256)
    s1 = t_nb.node_bench(nodes, torch.as_tensor(o), torch.as_tensor(d), 40)
    np.testing.assert_array_equal(out_t.numpy().view(np.uint32), out_j.view(np.uint32))
    assert torch.equal(out_t.view(torch.int32), s1.view(torch.int32)) and float(out_t[0]) != 0


S4_R, S4_NLEAF = 1, 16  # 128 rays over 128 triangles


def test_mxuleaf_plain_matches_jax_interpret(monkeypatch, tmp_path, capsys):
    """S4: the script's main() at R = 1, NLEAF = 16 (its REPO a temporary
    directory). The tables it times are make_inputs's; scalar: hit mask
    equal, t within rtol 1e-6; mxu: hit mask equal, t within rtol 1e-5."""
    mod = _script("exp_r5_mxuleaf")
    monkeypatch.setattr(mod, "R", S4_R)
    monkeypatch.setattr(mod, "NLEAF", S4_NLEAF)
    monkeypatch.setattr(mod, "REPO", tmp_path)
    (scalar_args, t_sj), (mxu_args, t_mj) = _record_main(monkeypatch, mod)
    assert (tmp_path / "EXP_R5_MXULEAF.json").exists()
    assert '"agree_frac": 1.0' in capsys.readouterr().out
    inp = t_mx.make_inputs(0, S4_R, S4_NLEAF)
    np.testing.assert_array_equal(np.asarray(scalar_args[0]), inp["prow"].numpy())
    np.testing.assert_array_equal(np.asarray(mxu_args[0]), inp["coef"].numpy())
    t_sj, t_mj = t_sj.reshape(-1), t_mj.reshape(-1)
    t_s = t_mx.leaf_min_t("scalar", inp["prow"], inp["o"], inp["d"]).numpy()
    t_m = t_mx.leaf_min_t("mxu", inp["coef"], inp["o"], inp["d"]).numpy()
    hit = np.isfinite(t_sj)
    print(f"S4: {int(hit.sum())} of {hit.size} lanes hit")
    assert hit.mean() >= 0.25
    np.testing.assert_array_equal(np.isfinite(t_s), hit)
    # not bit-equal: XLA contracts the products and sums into fused
    # multiply-adds on the CPU, the port rounds each (as the kernel does)
    np.testing.assert_allclose(t_s[hit], t_sj[hit], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.isfinite(t_m), np.isfinite(t_mj))
    np.testing.assert_allclose(t_m[hit], t_mj[hit], rtol=1e-5, atol=0)
