"""Kernels K8 and K9 of the capacity slice against the JAX package, on CPU.

Bit for bit, on every case of kernels/k9_cases.py and k8_cases.py:
  * K9's plain twin (models/binpack.py ffd_order_plain) against the JAX
    package's models/binpack.py ffd_order, vmapped over the lanes and
    jitted; and the port's single-lane ffd_order;
  * K8's plain twin (models/binpack.py binpack_counts_plain: used, placed
    counts, loads, touched) against the JAX binpack_ffd_counts, vmapped
    over the lanes (uniform mode) or on the per-node free rows (per-bin
    mode) and jitted; and the port's binpack_ffd_counts, which keeps the
    reference's signature.
The wrappers refuse CPU tensors; K8 and K9 run only on the card:
chip_smoke.py holds them against their twins on the same cases, and the
`cuda`-marked tests here do the same where a card is present.  K8's
layout cases (k8_cases.layout_cases) each take the path they pin
(kernels.binpack_counts_path, k8_cases.PINS), which is computed from the
sizes alone and so is checked here too.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.models import binpack as jbin
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.kernels import k8_cases, k9_cases
from kubernetes_tpu_torch.models import binpack as tbin

K8_CASES = dict(k8_cases.cases())
K9_CASES = dict(k9_cases.cases())


def _same(a, b) -> bool:
    """Equal dtype, shape and bits."""
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_JAX_ORDER = jax.jit(jax.vmap(jbin.ffd_order, in_axes=(None, 0)))


@pytest.mark.parametrize("name", list(K9_CASES))
def test_ffd_order_twin_matches_jax(name):
    c = K9_CASES[name]
    want = np.asarray(_JAX_ORDER(c["reqs"], c["caps"]))
    got = tbin.ffd_order_plain(_t(c["reqs"]), _t(c["caps"])).numpy()
    assert _same(want, got), name
    # the single-lane entry the planner's stage 1 and what_if read
    one = tbin.ffd_order(_t(c["reqs"]), _t(c["caps"][0])).numpy()
    assert _same(np.asarray(jbin.ffd_order(c["reqs"], c["caps"][0])), one)


def _jax_counts(c):
    """(used i32[S], placed i32[S, C], loads f32[S, n_bins, R]) of the
    jitted JAX binpack_ffd_counts on the case."""
    if c["per_bin"]:
        u, l, p = jbin.binpack_ffd_counts(
            c["reqs"], c["counts"], c["caps"], max_bins=c["n_bins"],
            order=c["order"][0])
        return (np.asarray(u)[None], np.asarray(p)[None],
                np.asarray(l)[None])
    reqs, counts, nb = c["reqs"], c["counts"], c["n_bins"]
    fn = jax.jit(jax.vmap(lambda cap, o: jbin.binpack_ffd_counts(
        reqs, counts, cap, max_bins=nb, order=o)))
    u, l, p = fn(c["caps"], c["order"])
    return np.asarray(u), np.asarray(p), np.asarray(l)


@pytest.mark.parametrize("name", list(K8_CASES))
def test_binpack_counts_twin_matches_jax(name):
    c = K8_CASES[name]
    used, placed, loads = _jax_counts(c)
    got = tbin.binpack_counts_plain(
        *(_t(c[k]) for k in ("reqs", "counts", "caps", "order")),
        c["n_bins"], c["per_bin"], want_loads=True)
    assert _same(used, got[0].numpy()), name
    assert _same(placed, got[1].numpy()), name
    assert _same(loads, got[2].numpy()), name
    if c["per_bin"]:
        assert _same((loads[0] > 0).any(-1), got[3].numpy())
    else:
        assert got[3] is None


@pytest.mark.parametrize("name", ["per-bin-small", "uniform-r8-bins37",
                                  "int32-clip", "order-negative"])
def test_binpack_ffd_counts_keeps_the_reference_signature(name):
    c = K8_CASES[name]
    cap = c["caps"] if c["per_bin"] else c["caps"][0]
    want = jbin.binpack_ffd_counts(c["reqs"], c["counts"], cap,
                                   max_bins=c["n_bins"], order=c["order"][0])
    got = tbin.binpack_ffd_counts(_t(c["reqs"]), _t(c["counts"]), _t(cap),
                                  max_bins=c["n_bins"],
                                  order=_t(c["order"][0]))
    for w, g in zip(want, got):
        assert _same(np.asarray(w), g.numpy()), name


def test_binpack_ffd_counts_default_order_is_identity():
    c = K8_CASES["uniform-r4-bins37"]
    want = jbin.binpack_ffd_counts(c["reqs"], c["counts"], c["caps"][1],
                                   max_bins=37)
    got = tbin.binpack_ffd_counts(_t(c["reqs"]), _t(c["counts"]),
                                  _t(c["caps"][1]), max_bins=37)
    for w, g in zip(want, got):
        assert _same(np.asarray(w), g.numpy())


def test_wrappers_refuse_cpu_tensors():
    """K8 and K9 launch on CUDA tensors only; the models' dispatchers send
    CPU tensors to the twins."""
    c = K8_CASES["uniform-r4-bins1"]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ffd_order(_t(c["reqs"]), _t(c["caps"]))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.binpack_counts(
            *(_t(c[k]) for k in ("reqs", "counts", "caps", "order")), 1,
            False)


LAYOUT = [name for name, _ in k8_cases.layout_cases()]


@pytest.mark.parametrize("name", LAYOUT)
def test_layout_case_takes_its_path(name):
    """Each layout case goes down the path it was made for on an H100's
    132 SMs, and pins what it names."""
    c = K8_CASES[name]
    path = kernels.binpack_counts_path(_t(c["reqs"]), c["caps"], c["order"],
                                       c["n_bins"], c["per_bin"])
    assert c["pins"]
    for pin in c["pins"]:
        assert k8_cases.PINS[pin](path, c), (pin, path)


def test_layout_cases_cover_every_path():
    """Between them the cases take a warp and a block a lane, the
    workspace in both, the class table staged and not, fewer held
    columns than R, and a block a lane's workspace at one to four held
    columns (each kept in registers) and at more."""
    seen = set()
    for _, c in K8_CASES.items():
        p = kernels.binpack_counts_path(_t(c["reqs"]), c["caps"],
                                        c["order"], c["n_bins"], c["per_bin"])
        seen.add((p.block, p.tier > 0, p.staged))
        seen.add(("held<R",) if p.held < c["reqs"].shape[1] else ())
        seen.add(("tier", p.tier))
        if p.block and p.tier > 0:
            seen.add(("workspace held", min(p.held, 5)))
    for want in ((False, False, True), (False, True, True),
                 (True, False, True), (True, True, True),
                 (False, False, False), ("held<R",), ("tier", 2),
                 *(("workspace held", h) for h in range(1, 6))):
        assert want in seen, want


def test_paths_at_the_main_path_shapes():
    """BASELINE's what-if (S 10,000, 2,048 bins, C 256, 3 of 8 columns
    held): a warp a lane, 8 lanes a block, in shared memory, the table
    staged; the planner's stage 1 (per-bin over 6,144 rows) and stage 2
    (64 lanes of 1,024 bins): a block a lane in shared memory, and stage 1
    over 16,385 node rows with its loads in the workspace."""
    p = kernels.binpack_counts_paths(10000, 2048, 8, 256, 3, False)
    assert p == kernels.BinpackCountsPath(False, 132, 3, 8, 0, True)
    p = kernels.binpack_counts_paths(1, 6144, 8, 64, 3, True)
    assert p == kernels.BinpackCountsPath(True, 1, 3, 1, 0, True)
    p = kernels.binpack_counts_paths(64, 1024, 8, 64, 3, False)
    assert p == kernels.BinpackCountsPath(True, 64, 3, 1, 0, True)
    # stage 1 over a 16,385-node cluster: its loads in the workspace
    p = kernels.binpack_counts_paths(1, 16385, 8, 64, 3, True)
    assert p == kernels.BinpackCountsPath(True, 1, 3, 1, 1, True)
    # every column held: fewer lanes a block; more bins: the loads in the
    # workspace, and past that the summaries too
    assert kernels.binpack_counts_paths(10000, 2048, 8, 256, 8,
                                        False).lanes == 3
    assert kernels.binpack_counts_paths(1, 40000, 8, 64, 8, True).tier == 1
    assert kernels.binpack_counts_paths(1, 2 ** 22, 8, 64, 8,
                                        True).tier == 2
    with pytest.raises(ValueError):
        kernels.binpack_counts_paths(1, 64, 8, 4, 9, True)
    # the launch shape turns at the SMs: a block a lane below, a warp a
    # lane from there
    assert kernels.binpack_counts_paths(131, 64, 4, 8, 2, False).block
    assert not kernels.binpack_counts_paths(132, 64, 4, 8, 2, False).block


@pytest.mark.cuda
def test_k8_k9_match_plain_twins_on_card():
    """K8 and K9 against their twins on every case (the lists chip_smoke.py
    checks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K8 and K9 have no CPU mode")
    for name, c in K9_CASES.items():
        reqs, caps = _t(c["reqs"]).cuda(), _t(c["caps"]).cuda()
        assert torch.equal(kernels.ffd_order(reqs, caps),
                           tbin.ffd_order_plain(reqs, caps)), name
    for name, c in K8_CASES.items():
        args = [_t(c[k]).cuda() for k in ("reqs", "counts", "caps", "order")]
        got = kernels.binpack_counts(*args, c["n_bins"], c["per_bin"], True)
        want = tbin.binpack_counts_plain(*args, c["n_bins"], c["per_bin"],
                                         True)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w), name
