"""Kernels K11 (filter_pass.cu) and K12 (score_pass.cu) against their plain
twins on the card, bit for bit, on every kernels/k11_cases.py and
k12_cases.py case and on the encoder-made affinity batches of
kernels/k14_cases.py (their pair terms gathered over each node's pairs):
the stack and the mask (K11), the total and every row with need_per on
and off (K12), each layout case on the path it pins; K11's candidates
mode against its twin (models/preemption.py preempt_eval_plain) on every
k11_cases.candidates_cases and layout case; and the node-pair table's
kernel against its twin.

The tests carry the `cuda` marker and skip where there is no card.  The
file imports neither JAX nor the JAX package (the machine with the card
has no JAX), so it runs there on its own, without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_passes_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.codec import schema as ts
from kubernetes_tpu_torch.kernels import k11_cases, k12_cases, k14_cases
from kubernetes_tpu_torch.ops import predicates as tpred
from kubernetes_tpu_torch.ops import priorities as tprio


def _on_card(case):
    """The case's snapshot and batch as the port's dataclasses on the
    card."""
    ct = ts.ClusterTensors(**{k: torch.from_numpy(np.array(v))
                              for k, v in case["cluster"].items()})
    pb = ts.PodBatch(**{k: torch.from_numpy(np.array(v))
                        for k, v in case["pods"].items()})
    return ts.cluster_to_torch(ct, "cuda"), ts.pods_to_torch(pb, "cuda")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K11 and K12 have no CPU mode")


def _encoded_cases():
    """The encoder-made affinity batches of k14_cases (not its random
    worlds, which k11_cases' already cover)."""
    return [(n, c) for n, c in k14_cases.affinity_cases()
            if not n.startswith("aff-")]


@pytest.mark.cuda
def test_k11_matches_plain_twin_on_card():
    """Every case and encoded batch, stack and mask; each layout case takes
    the path it pins."""
    from kubernetes_tpu_torch import kernels

    _need_card()
    for name, case in k11_cases.cases() + _encoded_cases():
        ct, pb = _on_card(case)
        cfg = ts.FilterConfig(**case["cfg"])
        key = case["unsched_key"]
        path = kernels.filter_pass_path(ct, pb)
        for pin in case.get("pins", ()):
            assert k11_cases.PINS[pin](path, pb.n_pods, ct.n_nodes), \
                (name, pin, path)
        want_mask, want_stack = tpred.filter_batch_plain(ct, pb, cfg, key)
        assert torch.equal(tpred.predicate_stack(ct, pb, cfg, key),
                           want_stack), name
        mask, _ = tpred.filter_batch(ct, pb, cfg, key, need_per=False)
        assert torch.equal(mask, want_mask), name
        mask, _ = tpred.filter_batch(ct, pb, cfg, key)
        assert torch.equal(mask, want_mask), name


@pytest.mark.cuda
def test_k11_candidates_mode_matches_plain_twin_on_card():
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.models import preemption as pp

    _need_card()
    kernels.reset_launch_counts()
    cases = k11_cases.candidates_cases() + k11_cases.layout_cases()
    for name, case in cases:
        ct, pb = _on_card(case)
        cfg = ts.FilterConfig(**case["cfg"])
        key = case["unsched_key"]
        got = pp.make_preempt_eval(cfg, key)(ct, pb)
        assert torch.equal(got, pp.preempt_eval_plain(ct, pb, cfg, key)), \
            name
    launches = kernels.settle_launches()
    assert (launches["filter_pass"] == launches["filter_pass_candidates"]
            == len(cases))
    assert launches["fold_predicates"] == launches["filter_pass_stack"] == 0


@pytest.mark.cuda
def test_k12_matches_plain_twin_on_card():
    """Every case and encoded batch, need_per on and off, one launch a
    call; each layout case takes the path it pins."""
    from kubernetes_tpu_torch import kernels

    _need_card()
    kernels.reset_launch_counts()
    calls = 0
    for name, case in k12_cases.cases() + [
            (n, dict(c, skip_zero_weight=False)) for n, c in
            _encoded_cases()]:
        ct, pb = _on_card(case)
        kw = dict(weights=case["weights"], zone_key_id=case["zone_key"],
                  skip_zero_weight=case["skip_zero_weight"],
                  score_cfg=ts.ScoreConfig(**case["score_cfg"]))
        for need_per in (True, False):
            got = tprio.score_batch(ct, pb, need_per=need_per, **kw)
            want = tprio.score_batch_plain(ct, pb, need_per=need_per, **kw)
            calls += 1
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32)), name
            if need_per:
                assert torch.equal(got[1].view(torch.int32),
                                   want[1].view(torch.int32)), name
            all_rows = need_per and not case["skip_zero_weight"]
            path = kernels.score_pass_path(
                ct, pb, case["weights"], all_rows, case["zone_key"],
                tprio.ipa_gathers(ct, pb, case["weights"], all_rows))
            for pin in case.get("pins", ()):
                assert k12_cases.PINS[pin](path, pb.n_pods, ct.n_nodes), \
                    (name, pin, path)
    assert kernels.settle_launches()["score_pass"] == calls


@pytest.mark.cuda
def test_node_pair_build_matches_its_twin_on_card():
    """The kernel, given the host's keys and slots, against the twin; the
    table the upload made (cluster_to_torch) is the same; a snapshot with
    a node in two pairs of one key is refused where its table is read."""
    from kubernetes_tpu_torch import kernels

    _need_card()
    for name, case in k11_cases.cases() + _encoded_cases():
        if name == "no-zones":          # two pairs of one key on a node
            continue
        ct, _ = _on_card(case)
        want = tpred.node_pair_table_plain(ct.topo_pairs, ct.pair_topo_key)
        keys, slot = tpred.pair_key_slots(ct.pair_topo_key.cpu().numpy())
        got = kernels.node_pair_build(
            ct.topo_pairs, torch.from_numpy(slot).cuda(), keys.size)
        assert torch.equal(got, want.table), name
        assert keys.tolist() == want.keys.tolist(), name
        made = tpred.node_pair_table(ct)
        assert torch.equal(made.table, want.table), name
        assert torch.equal(made.keys, want.keys), name
        assert torch.equal(made.rank.cpu(), want.rank.cpu()), name
        assert (made.host_keys, made.sizes) == (want.host_keys,
                                                want.sizes), name
    ct, _ = _on_card(dict(k11_cases.cases())["no-zones"])
    with pytest.raises(ValueError, match="two topology pairs"):
        tpred.node_pair_table(ct)
