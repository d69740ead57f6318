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
    neither the zone index nor the group columns, so fewer operations and
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
