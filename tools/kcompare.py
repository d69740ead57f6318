"""What the kernel compare tools (tools/k8_compare.py, k11_compare.py,
k12_compare.py, k13_compare.py) share: copying a commit's kernel source
and its headers, building a source with nvcc into a shared library of its
own, opening it with its entry points' signatures, holding outputs equal
bit for bit, and the card's name and power limit.  Not part of the package; the tools run
on the card, `fetch` where git is.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KDIR = os.path.join(ROOT, "kubernetes_tpu_torch", "kernels")


def fetch(rev: str, source: str, parent_dir: str) -> None:
    """REV's kernels/`source` and every header it includes, into
    parent_dir."""
    os.makedirs(parent_dir, exist_ok=True)

    def show(name: str) -> str:
        return subprocess.run(
            ["git", "show", f"{rev}:kubernetes_tpu_torch/kernels/{name}"],
            cwd=ROOT, capture_output=True, text=True, check=True).stdout

    text = show(source)
    names = [source] + re.findall(r'#include "([^"]+)"', text)
    for name in names:
        with open(os.path.join(parent_dir, name), "w") as f:
            f.write(text if name == source else show(name))
    print(f"{rev}: {', '.join(names)} -> {parent_dir}")


def nvcc(src: str, include: str, out: str, *defines: str) -> str:
    """src (with the headers in `include`) as the shared library out;
    nvcc's -Xptxas -v report."""
    from torch.utils.cpp_extension import CUDA_HOME

    from kubernetes_tpu_torch.kernels import _build

    os.makedirs(os.path.dirname(out), exist_ok=True)
    res = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "nvcc"), *_build.CUDA_FLAGS,
         "-std=c++17", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
         *defines, "-I", include, "-o", out, src],
        capture_output=True, text=True)
    report = (res.stdout + res.stderr).strip()
    if res.returncode:
        raise RuntimeError(f"nvcc {src} failed:\n{report}")
    return report


def build(tag: str, src: str, include: str, defines, marker: str) -> str:
    """nvcc src into the build directory as `tag`.so, printing the
    -Xptxas -v lines of the kernels whose names hold `marker`; returns the
    library's path."""
    from kubernetes_tpu_torch.kernels import _build

    so = os.path.join(_build.BUILD_DIR, f"{tag}.so")
    report = nvcc(src, include, so, *defines)
    print(f"[nvcc {tag}] " + " | ".join(
        line.strip() for line in report.splitlines()
        if marker in line or "registers" in line or "spill" in line),
        flush=True)
    return so


def load(path: str, signatures: dict):
    """The shared library at path, each entry point in `signatures`
    ({name: (argtypes, restype)}) given its signature."""
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def same(got, want) -> bool:
    """Bit for bit: tensors (f32 compared as their bits), and tuples or
    lists of them (None only against None)."""
    import torch

    if want is None or got is None:
        return got is None and want is None
    if isinstance(want, (tuple, list)):
        return (isinstance(got, (tuple, list)) and len(got) == len(want)
                and all(same(g, w) for g, w in zip(got, want)))
    if want.dtype == torch.float32:
        return (got.dtype == torch.float32
                and torch.equal(got.view(torch.int32), want.view(torch.int32)))
    return torch.equal(got, want)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
