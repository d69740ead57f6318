"""The PyTorch port's host selection against the JAX package's, on CPU.

select_host, select_hosts_batch (K1's plain twin on CPU tensors) and
limit_feasible must give identical results on tie-heavy, all-false and NaN
rows and on rotation counters that wrap int32.  K1 itself runs only on the
card: chip_smoke.py holds it against the twin there, and the `cuda`-marked
test below does the same where a card is present.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import select as jsel
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.ops import select as tsel


def _rows(rng, B, N):
    scores = rng.integers(0, 4, (B, N)).astype(np.float32)
    mask = rng.random((B, N)) < 0.6
    mask[0] = False                       # all-false
    mask[1] = False
    mask[1, N // 2] = True                # one feasible node
    scores[2, 3] = np.nan                 # NaN, masked in
    mask[2, 3] = True
    scores[3, 5] = np.nan                 # NaN, masked out
    mask[3, 5] = False
    scores[4] = 0.0
    scores[4, ::2] = -0.0                 # -0.0 ties 0.0
    scores[5] = -np.inf
    scores[6] = -3.4e38                   # ties the masked-out filler
    mask[7] = True                        # all feasible, all tied below
    scores[7] = 1.0
    return scores, mask


LAST_INDEX = [0, 1, 37, 2**31 - 64, 2**31 - 1, -5]


@pytest.mark.parametrize("last_index0", LAST_INDEX)
def test_select_hosts_batch_identical(last_index0):
    rng = np.random.default_rng(abs(last_index0) % 1000)
    B, N = 64, 96
    scores, mask = _rows(rng, B, N)
    li = jnp.int32(np.int32(np.int64(last_index0)))
    jh, jf = jax.jit(jsel.select_hosts_batch)(scores, mask, li)
    th, tf = tsel.select_hosts_batch(torch.from_numpy(scores),
                                     torch.from_numpy(mask), last_index0)
    assert th.dtype == torch.int32 and tf.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())


@pytest.mark.parametrize("last_index", LAST_INDEX)
def test_select_host_identical(last_index):
    rng = np.random.default_rng(7)
    scores, mask = _rows(rng, 16, 40)
    li = jnp.int32(np.int32(np.int64(last_index)))
    f = jax.jit(jsel.select_host)
    for b in range(16):
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


@pytest.mark.cuda
def test_k1_matches_plain_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    rng = np.random.default_rng(3)
    scores, mask = _rows(rng, 2048, 6144)
    s = torch.from_numpy(scores).cuda()
    m = torch.from_numpy(mask).cuda()
    for li in LAST_INDEX:
        hk, fk = kernels.select_hosts(s, m, li)
        hp, fp = tsel.select_hosts_batch_plain(s, m, li)
        assert torch.equal(hk, hp) and torch.equal(fk, fp), li
