"""Kernel K13 (kernels/seq_scan.cu) and its plain twin, on the CPU.

The port's sequential engine on CPU tensors runs its step loop
(models/batched.py scan_plain, K13's twin); it is held bit for bit against
the jitted JAX sequential engine on every kernels/k13_cases.py case:
hosts, the committed requested and nonzero_req columns and the top-k.
The affinity mode's twin (scan_plain with the in-batch affinity state) is
held the same way on every kernels/k14_cases.py affinity case.  The
ctypes struct K13 takes mirrors the C struct; the wrapper refuses CPU
tensors and the engine sends them to the twin.  The kernel itself is held
to the twin on the card by tests/test_torch_scan_cuda.py and
chip_smoke.py.  Tolerance: none.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_tpu.codec import schema as jschema
from kubernetes_tpu.models import batched as jbatched
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.kernels import k13_cases, k14_cases

from test_torch_filter_pass import _c_struct_fields, jax_inputs
from torch_port_helpers import TORCH_TEST_THREADS  # noqa: F401  (caps threads)

CASES = k13_cases.cases()
AFFINITY = k14_cases.affinity_cases()


def jax_engine(case, engine="sequential"):
    """The case through the jitted JAX engine, with its in-batch affinity
    state where it has one: (outputs, engine)."""
    from kubernetes_tpu.models import speculative as jspec

    ct, pb, cfg = jax_inputs(case)
    make = (jbatched.make_sequential_scheduler if engine == "sequential"
            else jspec.make_speculative_scheduler)
    fn = make(cfg=cfg, weights=case["weights"],
              unsched_taint_key=case["unsched_key"],
              zone_key_id=case["zone_key"],
              score_cfg=jschema.ScoreConfig(**case["score_cfg"]),
              percentage_of_nodes_to_score=case["pct"],
              quality_topk=case["topk"])
    nom = (None if case["nominated"] is None
           else jbatched.NominatedState(**case["nominated"]))
    aff = (None if case.get("aff") is None
           else jbatched.BatchAffinityState(**case["aff"]))
    out = fn(ct, pb, jbatched.BatchPortState(**case["ports"]),
             np.int32(case["last_index0"]), nominated=nom,
             extra_mask=case["extra_mask"], extra_score=case["extra_score"],
             aff_state=aff)
    return out, fn


def assert_outputs_equal(jout, tout, name):
    np.testing.assert_array_equal(np.asarray(jout[0]), tout[0].numpy(),
                                  err_msg=f"{name}: hosts")
    assert tout[0].dtype == torch.int32
    for f in ("requested", "nonzero_req"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jout[1], f)), getattr(tout[1], f).numpy(),
            err_msg=f"{name}: {f}")
    assert len(jout) == len(tout), name
    if len(tout) == 3:
        for k, (a, b) in enumerate(zip(jout[2], tout[2])):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"{name}: top-k leaf {k}")


@pytest.mark.parametrize("name", [n for n, _ in CASES])
def test_twin_matches_jax_on_k13_case(name):
    case = dict(CASES)[name]
    jout, _ = jax_engine(case)
    tout, _ = k13_cases.run_case(case)
    assert_outputs_equal(jout, tout, name)


@pytest.mark.parametrize("name", [n for n, _ in AFFINITY])
def test_twin_matches_jax_on_affinity_case(name):
    case = dict(AFFINITY)[name]
    jout, _ = jax_engine(case)
    tout, _ = k13_cases.run_case(case)
    assert_outputs_equal(jout, tout, name)


def test_affinity_cases_place_and_refuse():
    """Every affinity case places pods, and the random worlds refuse some
    (their filters, the pair terms)."""
    placed = {}
    for name, case in AFFINITY:
        out, _ = k13_cases.run_case(case)
        placed[name] = (int((out[0] >= 0).sum()),
                        int(case["pods"]["valid"].sum()))
    assert all(p > 0 for p, _ in placed.values())
    assert any(p < v for p, v in placed.values())
    assert placed["ipa-floor-boundary"] == (6, 6)


def test_k13_cases_cover_their_corners():
    names = dict(CASES)
    assert names["sample-50-wrap"]["last_index0"] + 24 > (1 << 31) - 1
    assert names["r32-ports-top3"]["cluster"]["allocatable"].shape[1] == 32
    assert names["dense-spread"]["pods"]["spread_counts"].shape[1] == 40
    assert np.isnan(names["nan-and-ties"]["extra_score"]).any()
    assert names["nominated"]["nominated"]["node"].min() == -1
    assert names["quality-past-n"]["topk"] > 5
    # the cluster's edges: fewer nodes than 16 blocks; 6,500 nodes, more
    # than 16 blocks of 384 threads hold one a thread, and no multiple of
    # their 32-node warps; ties across blocks; a sampled start inside a
    # block, with more zone pairs (64) and a wider top-k (8) than a
    # block's partial carries; R = 256 at 1,800 nodes
    assert names["cluster-short"]["cluster"]["valid"].shape[0] < 16
    n_ragged = names["cluster-ragged"]["cluster"]["valid"].shape[0]
    assert n_ragged > 16 * 384 and n_ragged % 32
    assert names["cluster-ragged"]["pods"]["group_ids"].shape[1] == 3
    assert (names["ties-across-blocks"]["cluster"]["allocatable"]
            == names["ties-across-blocks"]["cluster"]["allocatable"][0]).all()
    mid = names["sample-mid-block"]
    assert mid["last_index0"] % 19
    assert mid["topk"] > 8
    assert (mid["cluster"]["pair_topo_key"] == mid["zone_key"]).sum() > 64
    assert names["global-state"]["cluster"]["allocatable"].shape == (1800,
                                                                     256)
    # the affinity mode's: more pods than a block's 32 threads commit
    # pairs for, and more than 32 tie words (1,024 nodes) a block
    aff = dict(k13_cases.affinity_cases())
    assert aff["aff-across-blocks"]["pods"]["valid"].shape[0] > 32
    assert aff["aff-wide-blocks"]["cluster"]["valid"].shape[0] > 16 * 1024
    # the sampling case has more feasible nodes than the limit keeps: the
    # first pod sees exactly the limit
    from kubernetes_tpu_torch.ops.select import num_feasible_nodes_to_find

    case = names["sample-50-wrap"]
    out, _ = k13_cases.run_case(case)
    limit = num_feasible_nodes_to_find(int(case["cluster"]["valid"].sum()), 50)
    assert limit < 250 and int(out[2].feasible[0]) == limit


def test_args_struct_mirrors_the_c_struct():
    assert [f[0] for f in kernels.SeqScanArgs._fields_] == _c_struct_fields(
        "seq_scan.cu", "SeqScanArgs")


def test_cpu_tensors_take_the_twin(monkeypatch):
    """On the CPU the engine runs scan_plain, never the kernel's wrapper,
    which refuses CPU tensors."""
    def refuse(*a, **k):
        raise AssertionError("the kernel wrapper ran on the CPU")

    monkeypatch.setattr(kernels, "seq_scan", refuse)
    k13_cases.run_case(dict(CASES)["two-slots"])
    with pytest.raises(ValueError, match="CUDA"):
        kernels._bind("seq_scan", kernels.SeqScanArgs(),
                      [("req", torch.zeros((2, 2)), torch.float32, "B R")])


def test_barrier_count_follows_the_options():
    """(block barriers, cluster stages) a step: the select's and the
    commit's block barriers and the select's cluster stage; the spread
    maxima add a cluster stage and a block barrier, the sample's prefix a
    cluster stage and two block barriers; the top-k rides on the select."""
    base = kernels.seq_scan_barriers(False, False, 0)
    assert base == (2, 1)
    assert kernels.seq_scan_barriers(True, False, 0) == (base[0] + 1,
                                                         base[1] + 1)
    assert kernels.seq_scan_barriers(False, True, 0) == (base[0] + 2,
                                                         base[1] + 1)
    assert kernels.seq_scan_barriers(False, False, 3) == base


def test_affinity_mode_adds_its_barriers():
    """The IPA extremes are one more cluster stage and block barrier.
    Without spread the affinity mode keeps the first cluster stage, the
    fence behind the pair commits."""
    base = kernels.seq_scan_barriers(True, False, 0)
    assert kernels.seq_scan_barriers(True, False, 0, True) == (base[0] + 1,
                                                               base[1] + 1)
    assert kernels.seq_scan_barriers(False, False, 0, True) == (3, 3)
