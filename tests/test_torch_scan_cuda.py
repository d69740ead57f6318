"""Kernels K13 (seq_scan.cu), K14 (round_commit.cu) and K15
(round_fold.cu) against their plain twins on the card, bit for bit, on
every kernels/k13_cases.py and k14_cases.py case: each case through the
sequential engine (static pass + K13) and the speculative engine (K11,
K12, K15, K1, [K3], K14 a round) against the same engine with
select_impl="plain" (the twins) on the same card: hosts, the committed
columns, the top-k, and for the speculative engine its rounds and redo
flag.

The tests carry the `cuda` marker and skip where there is no card.  The
file imports neither JAX nor the JAX package, so it runs on the machine
with the card on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_scan_cuda.py -q
"""

from __future__ import annotations

import pytest
import torch

from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.kernels import k13_cases, k14_cases


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
