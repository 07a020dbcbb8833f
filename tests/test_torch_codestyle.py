"""Codestyle gate for the port, and the rule that the port imports no JAX:
neither cuda_pt_torch/, its tools/ nor chip_smoke.py may import jax, flax,
optax or cuda_pt_tpu (only the tests import both packages)."""

import ast
import glob
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cuda_pt_tpu"}


def _port_files():
    files = glob.glob(os.path.join(REPO, "cuda_pt_torch", "**", "*.py"), recursive=True)
    files += glob.glob(os.path.join(REPO, "tools", "*.py"))
    # the distributed tests' rank worker runs without JAX too
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py"),
                            os.path.join(REPO, "tests", "torch_dist_worker.py")]


def test_codestyle_port_clean():
    spec = importlib.util.spec_from_file_location(
        "codestyle_check", os.path.join(REPO, "scripts", "codestyle", "check.py"))
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    tests = sorted(os.path.relpath(p, REPO) for p in
                   glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
    assert check.main(["check", "cuda_pt_torch", "tools", "chip_smoke.py", *tests,
                       "tests/torch_dist_worker.py"]) == 0


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


# the scene-input modules (the XML parser and what it loads, the native
# builders' bridges, the autotuner): each one is among the files above, so
# the rule holds for it, and no string in its code (docstrings aside) names
# the JAX package: its libraries build from the port's own sources
SCENE_INPUT = ("scene/xml_parser.py", "scene/presets.py", "scene/obj_loader.py",
               "scene/native_obj.py", "utils/image.py", "utils/host_build.py", "media/nvdb.py",
               "accel/native.py", "accel/autotune.py")


@pytest.mark.parametrize("module", SCENE_INPUT)
def test_scene_input_module_checked(module):
    path = os.path.join(REPO, "cuda_pt_torch", module)
    assert path in _port_files()
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            assert "cuda_pt_tpu" not in node.value, f"{path}:{node.lineno}"


# the distributed modules and the torchrun entry: each is among the files
# the no-JAX rule walks
@pytest.mark.parametrize("module", ["parallel/__init__.py", "parallel/distributed.py",
                                    "distributed_render.py"])
def test_distributed_module_checked(module):
    assert os.path.join(REPO, "cuda_pt_torch", module) in _port_files()
