"""The PyTorch port's Filter / Score ops against the JAX package's, on CPU.

Inputs come from tests/fixtures.py through the JAX encoder and reach the
port through cluster_to_torch / pods_to_torch.  The JAX functions run under
jax.jit, as the engines run them: XLA's compiled arithmetic (an FMA in the
SelectorSpread blend, a reciprocal multiply in ImageLocality) is the
reference the port reproduces.

Tolerance: none.  Masks, per-predicate rows and first failures are
bit-identical, and so is every priority row and the weighted total,
including the floored non-integer blends (SelectorSpread, ImageLocality,
RequestedToCapacityRatio), which the port computes in the compiled
reference's order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.codec.schema import (
    DEFAULT_PRIORITY_WEIGHTS,
    FilterConfig,
    ScoreConfig,
)
from kubernetes_tpu.ops import predicates as jpred
from kubernetes_tpu.ops import priorities as jprio
from kubernetes_tpu_torch.codec.schema import cluster_to_torch, pods_to_torch
from kubernetes_tpu_torch.ops import predicates as tpred
from kubernetes_tpu_torch.ops import priorities as tprio

from fixtures import make_node, make_pod
from torch_port_helpers import twin_world, UNSCHED_KEY
from kubernetes_tpu.codec import SnapshotEncoder


def _inputs(seed, with_affinity=True, n_pending=48):
    jenc, _, jpods, _ = twin_world(seed, with_affinity=with_affinity,
                                   n_pending=n_pending)
    ct = jenc.snapshot()
    pb = jenc.encode_pods(jpods)
    return jenc, ct, pb, cluster_to_torch(ct, "cpu"), pods_to_torch(pb, "cpu")


def _dense_spread_inputs():
    """Pods in two spread groups each (dense [B, N] spread counts), node
    images and a zone layout, so the generic spread path and image
    locality carry real values."""
    enc = SnapshotEncoder()
    rng = np.random.default_rng(7)
    for i in range(40):
        enc.add_node(make_node(
            f"n{i}", cpu=str(int(rng.integers(2, 9))),
            mem=f"{int(rng.integers(2, 17))}Gi",
            labels={"failure-domain.beta.kubernetes.io/zone": f"z{i % 3}"},
            images=[{"names": [f"img-{i % 4}"],
                     "sizeBytes": int(rng.integers(1, 40)) * 64 << 20}]))
    for i in range(90):
        enc.add_pod(make_pod(
            f"e{i}", cpu="100m", mem="128Mi",
            labels={"app": f"a{i % 3}", "role": f"r{i % 2}"},
            node_name=f"n{int(rng.integers(40))}"))
    for a in range(3):
        enc.add_spread_selector("default", {"app": f"a{a}"})
    for r in range(2):
        enc.add_spread_selector("default", {"role": f"r{r}"})
    pods = [make_pod(f"p{i}", cpu="200m", mem="256Mi",
                     labels={"app": f"a{i % 3}", "role": f"r{i % 2}"},
                     images=[f"img-{i % 5}"])
            for i in range(32)]
    ct = enc.snapshot()
    pb = enc.encode_pods(pods)
    assert pb.spread_counts.shape[-1] == ct.allocatable.shape[0]
    return enc, ct, pb, cluster_to_torch(ct, "cpu"), pods_to_torch(pb, "cpu")


CASES = [("random-affinity", 11), ("random-affinity", 12),
         ("random-lean", 13), ("dense-spread", None)]


def _case(kind, seed):
    if kind == "dense-spread":
        return _dense_spread_inputs()
    return _inputs(seed, with_affinity=(kind == "random-affinity"))


@pytest.mark.parametrize("kind,seed", CASES)
def test_filter_batch_and_first_failure_identical(kind, seed):
    enc, ct, pb, tct, tpb = _case(kind, seed)
    key = enc.interner.intern(UNSCHED_KEY)
    cfg = FilterConfig()
    jmask, jper = jax.jit(
        lambda c, p: jpred.filter_batch(c, p, cfg, key))(ct, pb)
    tmask, tper = tpred.filter_batch(tct, tpb, cfg, key)
    np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())
    np.testing.assert_array_equal(np.asarray(jper), tper.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jpred.first_failure)(jper)),
        tpred.first_failure(tper).numpy())
    hot, none = tpred.filter_batch(tct, tpb, cfg, key, need_per=False)
    assert none is None
    np.testing.assert_array_equal(hot.numpy(), tmask.numpy())


@pytest.mark.parametrize("kind,seed", CASES)
def test_score_batch_identical(kind, seed):
    enc, ct, pb, tct, tpb = _case(kind, seed)
    zk = enc.getzone_key
    # every priority on (policy ones included), so each row is compared
    w = np.ones_like(DEFAULT_PRIORITY_WEIGHTS)
    w[4] = 10000.0
    lbl = enc.interner.intern("disk")
    scfg = ScoreConfig(label_prefs=((lbl, True, 2.0),),
                       rtc_shape=((0.0, 0.0), (30.0, 7.0), (100.0, 10.0)))
    jtot, jper = jax.jit(lambda c, p: jprio.score_batch(
        c, p, weights=w, score_cfg=scfg, zone_key_id=zk))(ct, pb)
    ttot, tper = tprio.score_batch(tct, tpb, weights=w, score_cfg=scfg,
                                   zone_key_id=zk)
    for i in range(jper.shape[1]):
        np.testing.assert_array_equal(np.asarray(jper)[:, i], tper[:, i].numpy(),
                                      err_msg=f"priority row {i}")
    np.testing.assert_array_equal(np.asarray(jtot), ttot.numpy())
    # the engines' total-only path with the stock weights
    jhot, _ = jax.jit(lambda c, p: jprio.score_batch(
        c, p, zone_key_id=zk, skip_zero_weight=True, need_per=False))(ct, pb)
    thot, _ = tprio.score_batch(tct, tpb, zone_key_id=zk,
                                skip_zero_weight=True, need_per=False)
    np.testing.assert_array_equal(np.asarray(jhot), thot.numpy())


def test_spread_blend_matches_compiled_reference():
    """SelectorSpread's floored blend is the first place a 1-ulp split
    shows: random integer counts, many of them on zone/node boundaries."""
    enc, ct, _, tct, _ = _dense_spread_inputs()
    rng = np.random.default_rng(3)
    N = ct.allocatable.shape[0]
    counts = rng.integers(0, 12, (4096, N)).astype(np.float32)
    counts[::3] = (rng.integers(0, 3, (len(counts[::3]), N)) * 3).astype(
        np.float32)
    # a cell where the fused blend floors one lower than separate rounding:
    # node 0 (zone z0) holds 103 of max 110 pods, zone z0 holds 194 of max
    # 220, so (1/3)*70/110 + (2/3)*260/220 is 1 in real arithmetic, 1.0
    # with separate f32 roundings and 0.99999994 through XLA's FMA
    counts[0] = 0.0
    counts[0, [0, 3, 1, 4]] = [103.0, 91.0, 110.0, 110.0]
    jout = jax.jit(lambda c, k: jprio.spread_score_from_counts(
        k, c, enc.getzone_key))(ct, counts)
    tout = tprio.spread_score_from_counts(torch.from_numpy(counts), tct,
                                          enc.getzone_key)
    assert float(np.asarray(jout)[0, 0]) == 0.0
    np.testing.assert_array_equal(np.asarray(jout), tout.numpy())


def test_fma_matches_hardware_fma():
    """fma_f32 against the fused multiply-add XLA emits for a*b+c."""
    rng = np.random.default_rng(0)
    n = 200_000
    a = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))).astype(
        np.float32)
    b = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))).astype(
        np.float32)
    c = np.where(rng.random(n) < 0.5,
                 -(a.astype(np.float64) * b).astype(np.float32),
                 rng.standard_normal(n).astype(np.float32)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    got = tprio.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(want, got)


def test_image_locality_and_interp_match_compiled_reference():
    rng = np.random.default_rng(5)
    sizes = (rng.random(100_000) * 1.2e9).astype(np.float32)
    jimg = jax.jit(lambda s: jnp.floor(
        10.0 * (jnp.clip(s, jprio._IMG_MIN, jprio._IMG_MAX) - jprio._IMG_MIN)
        / (jprio._IMG_MAX - jprio._IMG_MIN)))(sizes)
    timg = torch.floor(
        (torch.clamp(torch.from_numpy(sizes), tprio._IMG_MIN, tprio._IMG_MAX)
         - tprio._IMG_MIN) * tprio._IMG_SCALE)
    np.testing.assert_array_equal(np.asarray(jimg), timg.numpy())
    util = (rng.random((5000, 2)) * 140.0 - 10.0).astype(np.float32)
    xs = np.array([0.0, 30.0, 55.0, 100.0], np.float32)
    ys = np.array([0.0, 7.0, 7.0, 10.0], np.float32)
    jv = jax.jit(lambda u: jnp.interp(u, xs, ys))(util)
    tv = tprio.interp(torch.from_numpy(util), torch.from_numpy(xs),
                      torch.from_numpy(ys))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
