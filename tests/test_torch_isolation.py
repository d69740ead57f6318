"""The PyTorch port stands alone: no module of kubernetes_tpu_torch/ or
tools/, and not chip_smoke.py, imports jax or anything of the JAX package
kubernetes_tpu; and the package imports on a CPU-only torch without nvcc, building nothing.
"""

from __future__ import annotations

import ast
import importlib
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "kubernetes_tpu_torch")
TOOLS = os.path.join(ROOT, "tools")   # the port's measurement scripts


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in (*os.walk(PKG), *os.walk(TOOLS)):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "kubernetes_tpu")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call):
            # importlib.import_module("...") / __import__("...") by name
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                        and _forbidden(arg.value):
                    bad.append(arg.value)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_forbidden_name_rule():
    assert _forbidden("kubernetes_tpu.codec")
    assert _forbidden("jax.numpy")
    assert not _forbidden("kubernetes_tpu_torch.codec")


def test_package_imports_without_jax_or_nvcc():
    """Every module imports in a fresh interpreter where importing jax or
    the JAX package fails, and importing builds no kernel."""
    code = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import kubernetes_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from kubernetes_tpu_torch.kernels import _build
assert _build.library.cache_info().currsize == 0
assert not any(k.split(".")[0] in ("jax", "kubernetes_tpu") for k in sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_kernel_sources_and_build_settings():
    from kubernetes_tpu_torch.kernels import _build

    srcs = _build.sources()
    assert srcs and all(os.path.dirname(s) == os.path.join(PKG, "kernels")
                        for s in srcs)
    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.CUDA_FLAGS
    assert "--use_fast_math" not in _build.CUDA_FLAGS
    assert os.path.basename(_build.BUILD_DIR) == ".torch_ext_build"
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".torch_ext_build/" in f.read().split()
