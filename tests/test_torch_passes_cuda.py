"""Kernels K11 (filter_pass.cu) and K12 (score_pass.cu) against their plain
twins on the card, bit for bit, on every kernels/k11_cases.py and
k12_cases.py case: the stack and the mask (K11), the total and every row
with need_per on and off (K12).

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
from kubernetes_tpu_torch.kernels import k11_cases, k12_cases
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


@pytest.mark.cuda
def test_k11_matches_plain_twin_on_card():
    _need_card()
    for name, case in k11_cases.cases():
        ct, pb = _on_card(case)
        cfg = ts.FilterConfig(**case["cfg"])
        key = case["unsched_key"]
        want_mask, want_stack = tpred.filter_batch_plain(ct, pb, cfg, key)
        assert torch.equal(tpred.predicate_stack(ct, pb, cfg, key),
                           want_stack), name
        mask, _ = tpred.filter_batch(ct, pb, cfg, key, need_per=False)
        assert torch.equal(mask, want_mask), name
        mask, _ = tpred.filter_batch(ct, pb, cfg, key)
        assert torch.equal(mask, want_mask), name


@pytest.mark.cuda
def test_k12_matches_plain_twin_on_card():
    _need_card()
    for name, case in k12_cases.cases():
        ct, pb = _on_card(case)
        kw = dict(weights=case["weights"], zone_key_id=case["zone_key"],
                  skip_zero_weight=case["skip_zero_weight"],
                  score_cfg=ts.ScoreConfig(**case["score_cfg"]))
        for need_per in (True, False):
            got = tprio.score_batch(ct, pb, need_per=need_per, **kw)
            want = tprio.score_batch_plain(ct, pb, need_per=need_per, **kw)
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32)), name
            if need_per:
                assert torch.equal(got[1].view(torch.int32),
                                   want[1].view(torch.int32)), name
