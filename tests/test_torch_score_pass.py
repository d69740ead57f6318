"""Kernel K12 (kernels/score_pass.cu) and its plain twin, on the CPU.

The twin (ops/priorities.py score_batch_plain) is held bit for bit against
the jitted JAX score_batch on every kernels/k12_cases.py case and on one
batch the port's encoder makes from the bench fleet: the total and every
priority row with need_per, and the total without; under the stock
weights, every priority on, a Policy's weights and skip_zero_weight.  The
engines' static pass (one score pass with the state-dependent weights
zeroed) equals the sum it replaced.  The dispatch sends CPU tensors to the
twin; the wrapper refuses CPU tensors.  The kernel itself is held to the
twin on the card by tests/test_torch_passes_cuda.py and chip_smoke.py.
Tolerance: none.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.codec import schema as jschema
from kubernetes_tpu.ops import priorities as jprio
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.codec import schema as tschema
from kubernetes_tpu_torch.kernels import k12_cases
from kubernetes_tpu_torch.ops import priorities as tprio

from test_torch_filter_pass import _bench_case, jax_inputs, port_inputs

CASES = k12_cases.cases()


def _score_args(case):
    return dict(weights=case["weights"], zone_key_id=case["zone_key"],
                skip_zero_weight=case["skip_zero_weight"])


def assert_twin_matches_jax(case, need_per_false=True):
    ct, pb, _ = jax_inputs(case)
    jcfg = jschema.ScoreConfig(**case["score_cfg"])
    kw = _score_args(case)
    jtot, jper = jax.jit(lambda c, p: jprio.score_batch(
        c, p, score_cfg=jcfg, **kw))(ct, pb)
    tct, tpb, _ = port_inputs(case)
    tcfg = tschema.ScoreConfig(**case["score_cfg"])
    ttot, tper = tprio.score_batch_plain(tct, tpb, score_cfg=tcfg, **kw)
    for i in range(tper.shape[1]):
        np.testing.assert_array_equal(tper[:, i].numpy(), np.asarray(jper)[:, i],
                                      err_msg=f"priority row {i}")
    np.testing.assert_array_equal(ttot.numpy(), np.asarray(jtot))
    if need_per_false:
        jhot, _ = jax.jit(lambda c, p: jprio.score_batch(
            c, p, score_cfg=jcfg, need_per=False, **kw))(ct, pb)
        thot, none = tprio.score_batch_plain(tct, tpb, score_cfg=tcfg,
                                             need_per=False, **kw)
        assert none is None
        np.testing.assert_array_equal(thot.numpy(), np.asarray(jhot))


@pytest.mark.parametrize("name", [n for n, _ in CASES])
def test_twin_matches_jax_on_k12_case(name):
    case = dict(CASES)[name]
    # the widest case checks the total-only path on its twin alone
    assert_twin_matches_jax(case, need_per_false=name != "past-the-smem-tile")


def test_twin_matches_jax_on_the_bench_fleet():
    case = _bench_case()
    case.update(weights=np.asarray(k12_cases.STOCK, np.float32),
                score_cfg={}, skip_zero_weight=True)
    assert_twin_matches_jax(case)


def test_k12_cases_cover_their_corners():
    names = dict(CASES)
    smem = names["past-the-smem-tile"]["cluster"]
    assert (smem["valid"].shape[0] + smem["topo_pairs"].shape[1]) * 4 > \
        96 * 1024
    assert names["dense-spread"]["pods"]["spread_counts"].shape[1] == 90
    assert names["stock-b7-n64"]["pods"]["spread_counts"].shape[1] == 1
    assert not (names["no-zones"]["cluster"]["pair_topo_key"]
                == k12_cases.ZONE_KEY).any()
    assert names["policy-skip-zero"]["skip_zero_weight"]


def test_static_pass_is_one_score_pass():
    """models/batched.py static_pass's score: the state-independent
    priorities with their weights, every other weight zeroed, equal to
    the sum of weighted rows it replaced (PRIORITY_ORDER from 0)."""
    from kubernetes_tpu_torch.models.batched import static_pass

    case = dict(CASES)["every-priority"]
    ct, pb, cfg = port_inputs(case)
    scfg = tschema.ScoreConfig(**case["score_cfg"])
    w = case["weights"]
    for in_batch in (False, True):
        _, got = static_pass(ct, pb, cfg, 3, w, scfg,
                             in_batch_affinity=in_batch)
        _, per = tprio.score_batch_plain(ct, pb, weights=w, score_cfg=scfg)
        want = torch.zeros_like(got)
        for name in ("InterPodAffinityPriority",
                     "NodePreferAvoidPodsPriority", "NodeAffinityPriority",
                     "TaintTolerationPriority", "ImageLocalityPriority",
                     "NodeLabelPriority", "ResourceLimitsPriority"):
            if in_batch and name == "InterPodAffinityPriority":
                continue
            i = tschema.PRIO_INDEX[name]
            want = want + float(w[i]) * per[:, i]
        assert torch.equal(got, want)


def test_cpu_tensors_take_the_twin(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel wrapper was called on the CPU")

    monkeypatch.setattr(kernels, "score_pass", refuse)
    case = dict(CASES)["affinity-ipa"]
    ct, pb, _ = port_inputs(case)
    scfg = tschema.ScoreConfig(**case["score_cfg"])
    for need_per in (True, False):
        got = tprio.score_batch(ct, pb, score_cfg=scfg, need_per=need_per,
                                **_score_args(case))
        want = tprio.score_batch_plain(ct, pb, score_cfg=scfg,
                                       need_per=need_per, **_score_args(case))
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (not need_per)


def test_k12_wrapper_refuses_cpu_tensors():
    case = dict(CASES)["stock-b1-n5"]
    ct, pb, _ = port_inputs(case)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.score_pass(ct, pb, case["weights"], False, False,
                           tschema.ScoreConfig(), case["zone_key"], None)


def test_k12_bound_counts_the_rows_it_runs():
    """chip_smoke.py's K12 bound counts the rows a call computes: the
    round's weights (SelectorSpread zeroed for a spread-lean batch) need
    neither the zones nor the group columns, so fewer operations and
    bytes than the stock weights; need_per adds the 12 rows' writes."""
    from kubernetes_tpu_torch.kernels import k1_bench
    from test_torch_filter_pass import chip_smoke_module

    cs = chip_smoke_module()
    case = _bench_case()
    ct, pb, _ = port_inputs(case)
    assert pb.spread_counts.shape[-1] != ct.n_nodes      # spread-lean
    stock = np.asarray(tprio.DEFAULT_PRIORITY_WEIGHTS, np.float32)
    round_w = cs._round_weights(ct, pb, False)
    assert round_w[tschema.PRIO_INDEX["SelectorSpreadPriority"]] == 0.0
    zk = case["zone_key"]
    a = cs._k12_bound(ct, pb, stock, False, False, zk)
    b = cs._k12_bound(ct, pb, round_w, False, False, zk)
    assert b["int_ops"] < a["int_ops"] and b["f32_ops"] < a["f32_ops"]
    assert b["bytes_ms"] < a["bytes_ms"]
    per = cs._k12_bound(ct, pb, stock, True, True, zk)
    extra = (per["bytes_ms"] - cs._k12_bound(ct, pb, stock, True, False,
                                             zk)["bytes_ms"])
    assert extra * k1_bench.HBM_BYTES_PER_S / 1e3 == pytest.approx(
        pb.n_pods * ct.n_nodes * 48)


# ------------------------------------------------ the kernel's layout paths

LAYOUT = [n for n, c in CASES if "pins" in c]


def _path(case, need_per):
    ct, pb, _ = port_inputs(case)
    all_rows = need_per and not case["skip_zero_weight"]
    return ct, pb, kernels.score_pass_path(
        ct, pb, case["weights"], all_rows, case["zone_key"],
        tprio.ipa_gathers(ct, pb, case["weights"], all_rows))


@pytest.mark.parametrize("name", LAYOUT)
def test_layout_case_takes_the_path_it_pins(name):
    """kernels.score_pass_path, with need_per on and off, takes each
    layout case down the path it was made for (k12_cases.PINS)."""
    case = dict(CASES)[name]
    assert case["pins"]
    for need_per in (True, False):
        ct, pb, path = _path(case, need_per)
        assert path.cluster == kernels.K12_CLUSTER
        for pin in case["pins"]:
            assert k12_cases.PINS[pin](path, pb.n_pods, ct.n_nodes), (
                pin, path)


def test_score_pass_paths_by_size():
    """The paths the main path's shapes take: a sidecar request's pod over
    16 blocks of 384 threads, a node a thread; a batch of pods at two
    nodes a thread, 16 pods a cluster where the block's shared memory
    stays within K12_TILE_SMEM (a round's, no per-pod array) and 8 where
    it does not (the IPA and spread arrays: the smaller tile); three or more nodes a thread
    past 512 threads a block; the workspace past the shared-memory budget;
    and no size refused."""
    p = kernels.score_pass_paths(1, 6144, zones=8, arrays=3)
    assert (p.cluster, p.threads, p.per_thread, p.tile, p.tiles, p.slice,
            p.smem, p.inbox) == (16, 384, 1, 1, 1, 384, True,
                                 16 * (kernels.K12_PARTS + 8))
    p = kernels.score_pass_paths(2048, 6144, zones=0, arrays=0)
    assert (p.threads, p.per_thread, p.tile, p.tiles, p.region, p.smem) == (
        192, 2, 16, 128, kernels.K12_NODE_ARRAYS * 384, True)
    p = kernels.score_pass_paths(2048, 6144, zones=8, arrays=2)
    assert (p.threads, p.per_thread, p.tile, p.tiles, p.smem) == (
        192, 2, 8, 256, True)
    p16 = kernels.score_pass_paths(2048, 6144, zones=8, arrays=2, tile=16)
    assert (p16.region + p16.inbox) * 4 > kernels.K12_TILE_SMEM
    assert p.inbox == 16 * 8 * (kernels.K12_PARTS + 8)
    p = kernels.score_pass_paths(1, 16400)
    assert (p.threads, p.per_thread, p.slice) == (512, 3, 1056)
    assert p.threads * p.per_thread * p.cluster >= 16400
    p = kernels.score_pass_paths(3, 200, zones=12000, arrays=3)
    assert not p.smem and p.region == (
        kernels.K12_NODE_ARRAYS * 32 + 3 * 3 * 32 + 2 * 3 * 12000)
    assert p.inbox == 16 * 3 * kernels.K12_PARTS
    p = kernels.score_pass_paths(13, 5, tile=8)
    assert (p.slice, p.threads, p.tile, p.tiles) == (32, 32, 8, 2)
    p = kernels.score_pass_paths(5, 2_000_000, zones=3, arrays=3)
    assert not p.smem and p.per_thread == -(-p.slice // 512)
    for bad in ((0, 5), (1, 0)):
        with pytest.raises(ValueError):
            kernels.score_pass_paths(*bad)


def _zone_against_twin(ct, zone_key):
    """node_pair[n, zslot], and the pair's rank, against the twin's
    zone_layout: in a zone where the twin says so, at its zone pair,
    ranked in pair order among the zone key's pairs."""
    from kubernetes_tpu_torch.ops import predicates as tpred

    pairs = tpred.node_pair_table(ct)
    zslot = pairs.slot_of(zone_key)
    in_zone, zone_of_node, have = tprio.zone_layout(ct, zone_key)
    zone_pairs = torch.nonzero(ct.pair_topo_key == zone_key)[:, 0]
    if zslot < 0:
        assert zone_pairs.numel() == 0 and not bool(have)
        return 0
    got = pairs.table[:, zslot]
    assert torch.equal(got >= 0, in_zone)
    assert torch.equal(got[in_zone].long(), zone_of_node[in_zone])
    assert pairs.sizes[zslot] == zone_pairs.numel()
    assert torch.equal(pairs.rank[zone_pairs].long(),
                       torch.arange(zone_pairs.numel()))
    return int(in_zone.sum())


@pytest.mark.parametrize("name", [n for n, _ in CASES])
def test_zone_from_the_node_pair_table(name):
    """K12 reads each node's zone as node_pair[n, zslot]: it equals the
    twin's zone_layout on every case."""
    case = dict(CASES)[name]
    ct, _, _ = port_inputs(case)
    _zone_against_twin(ct, case["zone_key"])


def test_zone_from_the_node_pair_table_after_updates():
    """The same on the encoder's snapshots through DeviceSnapshotCache:
    a commit, then node events that add zones and rewrite topo_pairs."""
    from kubernetes_tpu_torch import loop
    from kubernetes_tpu_torch.api.factory import make_node, make_pod
    from kubernetes_tpu_torch.codec.transfer import DeviceSnapshotCache

    enc = loop.build_encoder(loop.bench_nodes(24))
    cache = DeviceSnapshotCache("cpu")
    zk = enc.getzone_key
    dev = cache.update(enc.snapshot())
    assert _zone_against_twin(dev, zk) == 24
    enc.add_pod(make_pod("p0", cpu="500m", mem="512Mi", node_name="node-1"))
    dev = cache.update(enc.snapshot(), dirty_rows=enc.take_dirty_rows())
    assert _zone_against_twin(dev, zk) == 24
    topo = dev.topo_pairs
    for i in range(24, 40):
        enc.add_node(make_node(f"x{i}", cpu="4", mem="8Gi", labels={
            loop.ZONE_KEY: f"zone-new-{i % 5}"} if i % 3 else {}))
    dev = cache.update(enc.snapshot(), dirty_rows=enc.take_dirty_rows())
    assert dev.topo_pairs is not topo or not torch.equal(dev.topo_pairs,
                                                         topo)
    assert _zone_against_twin(dev, zk) == 24 + sum(
        1 for i in range(24, 40) if i % 3)
