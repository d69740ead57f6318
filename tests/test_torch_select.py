"""The PyTorch port's host selection against the JAX package's, on CPU.

select_host, select_hosts_batch (K1's plain twin on CPU tensors) and
limit_feasible must give identical results on the rows and shapes of
kernels/k1_cases.py (tie-heavy, all-false, NaN, boundary-straddling ties,
rotation counters that wrap int32).  K1 itself runs only on the card:
chip_smoke.py holds it against the twin there on the same cases, and the
`cuda`-marked test below does the same where a card is present.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import select as jsel
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.kernels import k1_cases
from kubernetes_tpu_torch.ops import select as tsel

LAST_INDEX = [0, 1, 37, 2**31 - 64, 2**31 - 1, -5]
# The CPU cases leave out the shapes above this many cells: B=2048 with N of
# 5,120 or more.  chip_smoke.py and the cuda test run those on the card.
CPU_MAX_CELLS = 2_400_000
_jax_batch = jax.jit(jsel.select_hosts_batch)


def _i32(x):
    return jnp.int32(np.int32(np.int64(kernels.wrap_i32(x))))


def _batch_cases():
    """(B, N, shifts, last indices) with an id: first the original 64 x 96
    grid, one counter each, then every CPU-sized shape of k1_cases with all
    its case shifts and counters."""
    out = [pytest.param(64, 96, (0,), (li,), id=str(li)) for li in LAST_INDEX]
    for B, N in k1_cases.shapes():
        if B * N <= CPU_MAX_CELLS:
            out.append(pytest.param(B, N, tuple(k1_cases.shifts(B)),
                                    k1_cases.last_indices(B),
                                    id=f"B{B}-N{N}"))
    return out


@pytest.mark.parametrize("B,N,shifts,last_indices", _batch_cases())
def test_select_hosts_batch_identical(B, N, shifts, last_indices):
    for shift in shifts:
        scores, mask = k1_cases.rows(B, N, shift)
        st, mt = torch.from_numpy(scores), torch.from_numpy(mask)
        for li in last_indices:
            jh, jf = _jax_batch(scores, mask, _i32(li))
            th, tf = tsel.select_hosts_batch(st, mt, li)
            assert th.dtype == torch.int32 and tf.dtype == torch.bool
            np.testing.assert_array_equal(np.asarray(jh), th.numpy(),
                                          err_msg=f"shift {shift} li {li}")
            np.testing.assert_array_equal(np.asarray(jf), tf.numpy(),
                                          err_msg=f"shift {shift} li {li}")


@pytest.mark.parametrize("last_index", LAST_INDEX)
def test_select_host_identical(last_index):
    B = len(k1_cases.CASES)
    scores, mask = k1_cases.rows(B, 40)
    li = _i32(last_index)
    f = jax.jit(jsel.select_host)
    for b in range(B):
        jh, jf = f(scores[b], mask[b], li)
        th, tf = tsel.select_host(torch.from_numpy(scores[b]),
                                  torch.from_numpy(mask[b]), last_index)
        assert int(jh) == int(th) and bool(jf) == bool(tf), (b, last_index)


@pytest.mark.parametrize("start", [0, 3, 95, 2**31 - 7, -2])
def test_limit_feasible_identical(start):
    rng = np.random.default_rng(11)
    mask = rng.random((8, 96)) < 0.5
    for limit in (0, 1, 5, 96):
        js = jnp.int32(np.int32(np.int64(start)))
        jout = jax.vmap(jsel.limit_feasible, in_axes=(0, None, None))(
            mask, jnp.int32(limit), js)
        tout = tsel.limit_feasible(torch.from_numpy(mask), limit, start)
        np.testing.assert_array_equal(np.asarray(jout), tout.numpy())
    # one start per row (the speculative engine's staggered form)
    starts = (start + np.arange(8)).astype(np.int64)
    jout = jax.vmap(jsel.limit_feasible, in_axes=(0, None, 0))(
        mask, jnp.int32(7), starts.astype(np.int32))
    tout = tsel.limit_feasible(torch.from_numpy(mask), 7,
                               tsel.rotation_counters(start, 8, "cpu"))
    np.testing.assert_array_equal(np.asarray(jout), tout.numpy())


def test_num_feasible_nodes_identical():
    for n in (50, 100, 1000, 5000, 50000):
        for pct in (0, 5, 40, 100):
            want = jsel.num_feasible_nodes_to_find(n, pct)
            assert tsel.num_feasible_nodes_to_find(n, pct) == want
            if pct < 100:
                got = tsel.num_feasible_nodes_device(
                    torch.tensor(n, dtype=torch.int32), pct)
                assert int(got) == want, (n, pct)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises: a CPU tensor never reaches a silent
    fallback inside it (ops/select.py picks the twin for CPU tensors)."""
    s = torch.zeros((2, 3))
    m = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(ValueError):
        kernels.select_hosts(s, m, 0)
    with pytest.raises(ValueError):
        tsel.select_hosts_batch(s, m, 0, impl="fast")
    assert kernels.wrap_i32(2**31) == -(2**31)
    assert kernels.wrap_i32(-1) == -1


def test_k1_variant_choice():
    """The wrapper's variant pick: float4 only for N % 4 == 0 with aligned
    pointers, a warp per row only for batches of rows up to 1,024 nodes,
    and rows read twice only past 8,192 nodes."""
    v = kernels.K1_VARIANTS
    assert v[kernels.k1_variant(2048, 6144, 256, 512)] == "block_vec4"
    assert v[kernels.k1_variant(1, 6144, 256, 512)] == "block_vec4"
    assert v[kernels.k1_variant(2048, 6147, 256, 512)] == "block_scalar"
    assert v[kernels.k1_variant(2048, 6144, 260, 512)] == "block_scalar"
    assert v[kernels.k1_variant(2048, 6144, 256, 514)] == "block_scalar"
    assert v[kernels.k1_variant(33, 1024, 256, 512)] == "warp_vec4"
    assert v[kernels.k1_variant(33, 1025, 256, 512)] == "block_scalar"
    assert v[kernels.k1_variant(7, 300, 256, 512)] == "warp_vec4"
    assert v[kernels.k1_variant(7, 3, 256, 512)] == "warp_scalar"
    assert v[kernels.k1_variant(1, 3, 256, 512)] == "block_scalar"
    assert v[kernels.k1_variant(1, 8192, 256, 512)] == "block_vec4"
    assert v[kernels.k1_variant(2048, 8196, 256, 512)] == "long_vec4"
    assert v[kernels.k1_variant(7, 20001, 256, 512)] == "long_scalar"
    assert kernels.K1_ONE_READ_MAX_N == 8192


def test_k1_cases_cover_every_case():
    """Each batch size reaches every special row through its shifts, and
    the rows are the same for the same arguments."""
    for B in k1_cases.BATCHES:
        seen = {(b + sh) % len(k1_cases.CASES)
                for sh in k1_cases.shifts(B)
                for b in range(min(B, len(k1_cases.CASES)))}
        assert seen == set(range(len(k1_cases.CASES))), B
    a = k1_cases.rows(7, 300, 7)
    b = k1_cases.rows(7, 300, 7)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert max(k1_cases.WIDTHS) > kernels.K1_ONE_READ_MAX_N
    assert any(n % 4 for n in k1_cases.WIDTHS)


@pytest.mark.cuda
def test_k1_matches_plain_twin_on_card():
    """K1 against its twin on every shape, case and counter of k1_cases
    (the same list chip_smoke.py checks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    for B, N in k1_cases.shapes():
        for shift in k1_cases.shifts(B):
            scores, mask = k1_cases.rows(B, N, shift)
            s = torch.from_numpy(scores).cuda()
            m = torch.from_numpy(mask).cuda()
            for li in k1_cases.last_indices(B):
                hk, fk = kernels.select_hosts(s, m, li)
                hp, fp = tsel.select_hosts_batch_plain(s, m, li)
                assert torch.equal(hk, hp) and torch.equal(fk, fp), \
                    (B, N, shift, li)
