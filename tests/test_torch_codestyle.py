"""Codestyle gate for the port, and the rule that the port imports no JAX:
neither cuda_pt_torch/, its tools/ nor chip_smoke.py may import jax, flax
or cuda_pt_tpu (only the tests import both packages)."""

import ast
import glob
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "cuda_pt_tpu"}


def _port_files():
    files = glob.glob(os.path.join(REPO, "cuda_pt_torch", "**", "*.py"), recursive=True)
    files += glob.glob(os.path.join(REPO, "tools", "*.py"))
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def test_codestyle_port_clean():
    spec = importlib.util.spec_from_file_location(
        "codestyle_check", os.path.join(REPO, "scripts", "codestyle", "check.py"))
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    tests = sorted(os.path.relpath(p, REPO) for p in
                   glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
    assert check.main(["check", "cuda_pt_torch", "tools", "chip_smoke.py", *tests]) == 0


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
