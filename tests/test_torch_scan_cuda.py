"""Kernels K13 (seq_scan.cu), K14 (round_commit.cu), K15 (round_fold.cu)
and K16 (round_pairs.cu) against their plain twins on the card, bit for
bit, on every kernels/k13_cases.py and k14_cases.py case, the affinity
cases included: each case through the sequential engine (static pass +
K13) and the speculative engine (K11, K12, K15, K1, [K3], K14 a round,
and K16 for an affinity batch) against the same engine with
select_impl="plain" (the twins) on the same card: hosts, the committed
columns, the top-k, and for the speculative engine its rounds and redo
flag.  K16 is also held to round_pairs_plain directly on every
kernels/k16_cases.py case, and an affinity batch runs through both
engines with the twins made to raise.

The tests carry the `cuda` marker and skip where there is no card.  The
file imports neither JAX nor the JAX package, so it runs on the machine
with the card on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_scan_cuda.py -q
"""

from __future__ import annotations

import pytest
import torch

from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.kernels import k13_cases, k14_cases, k16_cases


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K13, K14 and K15 have no CPU mode")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, want, name):
    assert torch.equal(got[0], want[0]), f"{name}: hosts"
    for f in ("requested", "nonzero_req"):
        assert torch.equal(_bits(getattr(got[1], f)),
                           _bits(getattr(want[1], f))), f"{name}: {f}"
    assert len(got) == len(want), name
    if len(got) == 3:
        for k, (a, b) in enumerate(zip(got[2], want[2])):
            assert torch.equal(_bits(a), _bits(b)), f"{name}: top-k {k}"


@pytest.mark.cuda
def test_k13_matches_plain_twin_on_card():
    _need_card()
    for name, case in k13_cases.cases():
        before = kernels.settle_launches()["seq_scan"]
        got, _ = k13_cases.run_case(case, "sequential", "cuda", "kernel")
        assert kernels.settle_launches()["seq_scan"] == before + 1, name
        want, _ = k13_cases.run_case(case, "sequential", "cuda", "plain")
        _assert_same(got, want, name)


@pytest.mark.cuda
def test_k14_k15_match_plain_twins_on_card():
    _need_card()
    for name, case in k14_cases.cases():
        before = kernels.settle_launches()
        got, kfn = k14_cases.run_case(case, "speculative", "cuda", "kernel")
        # the graph's body launches count once its rounds are read back
        after = kernels.settle_launches()
        rounds = int(kfn.last_rounds)
        assert after["round_graph"] == before["round_graph"] + 1, name
        for k in ("round_commit", "round_fold", "select_hosts"):
            assert after[k] == before[k] + rounds, (name, k)
        assert after["seq_scan"] == before["seq_scan"] + bool(
            kfn.last_redo), name
        want, pfn = k14_cases.run_case(case, "speculative", "cuda", "plain")
        _assert_same(got, want, name)
        assert int(kfn.last_rounds) == int(pfn.last_rounds), name
        assert bool(kfn.last_redo) == bool(pfn.last_redo), name


@pytest.mark.cuda
def test_k13_affinity_mode_matches_plain_twin_on_card():
    _need_card()
    for name, case in k14_cases.affinity_cases():
        before = kernels.settle_launches()["seq_scan"]
        got, _ = k13_cases.run_case(case, "sequential", "cuda", "kernel")
        assert kernels.settle_launches()["seq_scan"] == before + 1, name
        want, _ = k13_cases.run_case(case, "sequential", "cuda", "plain")
        _assert_same(got, want, name)


@pytest.mark.cuda
def test_affinity_rounds_match_plain_twins_on_card():
    """An affinity batch's graph: K16 once before the loop and once a
    round beside K15, K1 and K14, K13 once when it redoes."""
    _need_card()
    for name, case in k14_cases.affinity_cases():
        before = kernels.settle_launches()
        got, kfn = k14_cases.run_case(case, "speculative", "cuda", "kernel")
        after = kernels.settle_launches()
        rounds = int(kfn.last_rounds)
        assert after["round_graph"] == before["round_graph"] + 1, name
        for k in ("round_commit", "round_fold", "select_hosts"):
            assert after[k] == before[k] + rounds, (name, k)
        assert after["round_pairs"] == before["round_pairs"] + rounds + 1
        assert after["seq_scan"] == before["seq_scan"] + bool(
            kfn.last_redo), name
        want, pfn = k14_cases.run_case(case, "speculative", "cuda", "plain")
        _assert_same(got, want, name)
        assert int(kfn.last_rounds) == int(pfn.last_rounds), name
        assert bool(kfn.last_redo) == bool(pfn.last_redo), name


@pytest.mark.cuda
def test_k16_matches_plain_twin_on_card():
    from kubernetes_tpu_torch.models.speculative import round_pairs_plain
    from kubernetes_tpu_torch.ops.predicates import batch_pairs

    _need_card()
    for name, case in k16_cases.cases():
        for commit in (True, False):
            ct, pb, aff, c, hosts, accept, hard_w = k16_cases.round_state(
                case, "cuda")
            if not commit:
                hosts = accept = None
            want = round_pairs_plain(c, hosts, accept, pb, aff, ct, hard_w)
            kernels.round_pairs(c, hosts, accept, pb, aff,
                                batch_pairs(ct, pb, aff.pref_topo_key),
                                hard_w)
            for k, w in want.items():
                assert torch.equal(_bits(c[k]), _bits(w)), (name, commit, k)


@pytest.mark.cuda
def test_affinity_batch_reaches_no_twin_on_card(monkeypatch):
    """Through the kernels, an affinity batch on the card reaches no
    pair product and no twin of the rounds or the scan: each is made to
    raise, and both engines run."""
    from kubernetes_tpu_torch.models import batched, speculative
    from kubernetes_tpu_torch.ops import predicates, priorities

    _need_card()

    def refuse(*a, **k):
        raise AssertionError("a twin ran on the card")

    for mod, name in ((predicates, "pair_hits"),
                      (predicates, "node_pair_table_plain"),
                      (batched, "scan_plain"),
                      (speculative, "round_fold_plain"),
                      (speculative, "round_commit_plain"),
                      (speculative, "round_pairs_plain"),
                      (predicates, "exact_bool_matmul"),
                      (predicates, "filter_batch_plain"),
                      (predicates, "predicate_stack_plain"),
                      (priorities, "score_batch_plain"),
                      (batched, "ipa_normalize")):
        monkeypatch.setattr(mod, name, refuse)
    case = dict(k14_cases.affinity_cases())["anti-two-slots"]
    for engine in ("sequential", "speculative"):
        out, _ = k13_cases.run_case(case, engine, "cuda", "kernel")
        torch.cuda.synchronize()
        assert int((out[0] >= 0).sum()) > 0
