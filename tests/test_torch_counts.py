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
`cuda`-marked tests here do the same where a card is present.
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
