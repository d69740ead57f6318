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


def test_walk_covers_the_preemption_slice():
    """The import walk reaches the modules the preemption slice added: the
    cpuref copy, models/preemption.py and K2's case list."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("kubernetes_tpu_torch/cpuref/__init__.py",
                "kubernetes_tpu_torch/cpuref/reference.py",
                "kubernetes_tpu_torch/models/preemption.py",
                "kubernetes_tpu_torch/kernels/k2_cases.py"):
        assert mod in rel, mod
    names = {m.name for m in pkgutil.walk_packages(
        [PKG], "kubernetes_tpu_torch.")}
    assert {"kubernetes_tpu_torch.cpuref.reference",
            "kubernetes_tpu_torch.models.preemption"} <= names


def test_walk_covers_the_extender_slice():
    """The import walk reaches the modules the extender slice added: the
    sidecar and its client, the independent scheduling model, the config
    copy, the binary and K7's case list."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    mods = ("extender/__init__.py", "extender/server.py",
            "extender/client.py", "models/generic.py", "config/__init__.py",
            "config/featuregates.py", "config/profile.py", "config/types.py",
            "cmd/__init__.py", "cmd/base.py", "cmd/extender.py",
            "api/serialize.py", "kernels/k7_cases.py")
    for mod in mods:
        assert f"kubernetes_tpu_torch/{mod}" in rel, mod
    names = {m.name for m in pkgutil.walk_packages(
        [PKG], "kubernetes_tpu_torch.")}
    assert {"kubernetes_tpu_torch.extender.server",
            "kubernetes_tpu_torch.extender.client",
            "kubernetes_tpu_torch.models.generic",
            "kubernetes_tpu_torch.config.types",
            "kubernetes_tpu_torch.cmd.extender"} <= names


def test_walk_covers_the_capacity_slice():
    """The import walk reaches the modules the capacity and replica slice
    added: the planner, the reconciler and hub, the replica set, and the
    case lists of K8, K9 and K10."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    mods = ("runtime/capacity.py", "runtime/reconciler.py",
            "runtime/replicas.py", "models/binpack.py",
            "kernels/k8_cases.py", "kernels/k9_cases.py",
            "kernels/k10_cases.py")
    for mod in mods:
        assert f"kubernetes_tpu_torch/{mod}" in rel, mod
    names = {m.name for m in pkgutil.walk_packages(
        [PKG], "kubernetes_tpu_torch.")}
    assert {"kubernetes_tpu_torch.runtime.capacity",
            "kubernetes_tpu_torch.runtime.reconciler",
            "kubernetes_tpu_torch.runtime.replicas"} <= names


def test_walk_covers_the_filter_and_score_slice():
    """The import walk reaches the case lists of K11 and K12, and the ops
    that dispatch to them hold their twins."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("kernels/k11_cases.py", "kernels/k12_cases.py",
                "ops/predicates.py", "ops/priorities.py"):
        assert f"kubernetes_tpu_torch/{mod}" in rel, mod
    from kubernetes_tpu_torch.ops import predicates, priorities

    assert callable(predicates.filter_batch_plain)
    assert callable(predicates.predicate_stack_plain)
    assert callable(priorities.score_batch_plain)


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
    assert {os.path.basename(s) for s in srcs} >= {"select_hosts.cu",
                                                   "preempt_one.cu",
                                                   "fold_predicates.cu",
                                                   "binpack_counts.cu",
                                                   "ffd_order.cu",
                                                   "reconcile_admit.cu",
                                                   "filter_pass.cu",
                                                   "score_pass.cu"}
    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.CUDA_FLAGS
    assert "--use_fast_math" not in _build.CUDA_FLAGS
    assert os.path.basename(_build.BUILD_DIR) == ".torch_ext_build"
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".torch_ext_build/" in f.read().split()
