"""Kernel K8 (binpack_counts.cu) against its plain twin on the card, bit
for bit, on every kernels/k8_cases.py case: used, placed, the loads and
(per-bin) touched, each case on the path kernels.binpack_counts_path
names (the kernel writes the path it took) and each layout case pinning
what its "pins" name (k8_cases.PINS).

The test carries the `cuda` marker and skips where there is no card.  The
file imports neither JAX nor the JAX package (the machine with the card
has no JAX), so it runs there on its own, without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_counts_cuda.py -q
"""

from __future__ import annotations

import pytest
import torch

from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.kernels import k8_cases
from kubernetes_tpu_torch.models.binpack import binpack_counts_plain


@pytest.mark.cuda
def test_k8_matches_plain_twin_on_card_on_its_path():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K8 has no CPU mode")
    took = torch.zeros(3, dtype=torch.int32, device="cuda")
    for name, c in k8_cases.cases():
        args = [torch.from_numpy(c[k]).cuda()
                for k in ("reqs", "counts", "caps", "order")]
        got = kernels.binpack_counts(*args, c["n_bins"], c["per_bin"], True,
                                     path_out=took)
        want = binpack_counts_plain(*args, c["n_bins"], c["per_bin"], True)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w), name
        path = kernels.binpack_counts_path(args[0], args[2], args[3],
                                           c["n_bins"], c["per_bin"])
        assert kernels.binpack_counts_took(took, path), (name, path)
        for pin in c.get("pins", ()):
            assert k8_cases.PINS[pin](path, c), (name, pin, path)
