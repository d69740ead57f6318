"""Kernels K14 (kernels/round_commit.cu) and K15 (kernels/round_fold.cu)
and their plain twins, on the CPU.

The port's speculative engine on CPU tensors runs a plain batch's rounds
through the twins (models/speculative.py round_fold_plain between the score
pass and the selector, round_commit_plain after it); it is held bit for bit
against the jitted JAX speculative engine on every kernels/k14_cases.py
case: hosts, the committed requested and nonzero_req columns, the top-k,
the rounds and the redo flag.  So is an affinity batch's round (K15's and
K14's affinity modes beside K16's twin, round_pairs_plain) on every
kernels/k14_cases.py affinity case, which cover the same round's anti
conflicts (with bounced and with accepted peers), the inversion sentinel
and the deferred retirement.  The twins' carry layout (spread counts
carried with the snapshot's counts in them, the pair state as unions) gives
the counts the eager round gave.  The ctypes structs mirror the C structs;
the wrappers refuse CPU tensors.  The kernels themselves are held to the
twins on the card by tests/test_torch_scan_cuda.py and chip_smoke.py.
Tolerance: none.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.kernels import k14_cases
from kubernetes_tpu_torch.models import speculative as tspec

from test_torch_filter_pass import _c_struct_fields
from test_torch_seq_scan import assert_outputs_equal, jax_engine

CASES = k14_cases.cases()
AFFINITY = k14_cases.affinity_cases()


@pytest.mark.parametrize("name", [n for n, _ in CASES])
def test_twins_match_jax_on_k14_case(name):
    case = dict(CASES)[name]
    jout, jfn = jax_engine(case, "speculative")
    tout, tfn = k14_cases.run_case(case, "speculative")
    assert_outputs_equal(jout, tout, name)
    assert tfn.last_rounds == int(jfn.last_rounds), name
    assert tfn.last_redo == bool(np.asarray(jfn.last_redo)), name


def test_k14_cases_cover_their_corners():
    """Redone and kept batches, several rounds, both spread layouts."""
    rounds, redos, lean = [], [], []
    for name, case in CASES:
        _, fn = k14_cases.run_case(case, "speculative")
        rounds.append(fn.last_rounds)
        redos.append(fn.last_redo)
        lean.append(k14_cases.spread_lean(case))
    assert max(rounds) >= 3 and min(rounds) == 1
    assert any(redos) and not all(redos)
    assert any(lean) and not all(lean)


@pytest.mark.parametrize("name", [n for n, _ in AFFINITY])
def test_twins_match_jax_on_affinity_case(name):
    case = dict(AFFINITY)[name]
    jout, jfn = jax_engine(case, "speculative")
    tout, tfn = k14_cases.run_case(case, "speculative")
    assert_outputs_equal(jout, tout, name)
    assert tfn.last_rounds == int(jfn.last_rounds), name
    assert tfn.last_redo == bool(np.asarray(jfn.last_redo)), name


def test_affinity_cases_cover_their_corners(monkeypatch):
    """Each corner of the affinity mode acts in some round of the cases:
    against the same round without it, a proposer that fits loses to an
    earlier one in an anti domain; an order inversion raises the redo
    flag; an infeasible pod stays active; a bounced pod's ban is lifted
    because its conflict is with an accepted peer."""
    seen = {"aviol": 0, "inversion": 0, "deferred": 0, "no_ban": 0}
    commit = tspec.round_commit_plain

    def recording(c, hosts, feasible, top, pods, ports, cluster, nom, sm,
                  tril, aff=None):
        out = commit(c, hosts, feasible, top, pods, ports, cluster, nom,
                     sm, tril, aff)
        if aff is not None:
            base = commit(c, hosts, feasible, top, pods, ports, cluster,
                          nom, sm, tril)
            seen["aviol"] += int(((base["hosts"] != c["hosts"])
                                  & ~out["accept"]).sum())
            seen["inversion"] += int(bool(out["inv"])
                                     and not bool(base["inv"]))
            seen["deferred"] += int((out["active"] & ~base["active"]).sum())
            seen["no_ban"] += int((out["emask"] & ~base["emask"]).sum())
        return out

    monkeypatch.setattr(tspec, "round_commit_plain", recording)
    rounds = []
    for _, case in AFFINITY:
        _, fn = k14_cases.run_case(case, "speculative")
        rounds.append(fn.last_rounds)
    assert all(v > 0 for v in seen.values()), seen
    assert min(rounds) == 1 and max(rounds) >= 5


@pytest.mark.parametrize("source,cls", [
    ("round_fold.cu", kernels.RoundFoldArgs),
    ("round_commit.cu", kernels.RoundCommitArgs),
])
def test_args_struct_mirrors_the_c_struct(source, cls):
    assert [f[0] for f in cls._fields_] == _c_struct_fields(
        source, cls.__name__)


def test_plain_carry_holds_the_snapshot_counts():
    """The twins' carry starts from the snapshot's spread counts (group
    columns for a spread-lean batch, each pod's row else) and the host
    rotation counter; the kernels' carry is a fresh copy with device
    counters."""
    from kubernetes_tpu_torch.codec import schema as ts

    for name in ("plain-b24-n40", "dense-spread"):
        case = dict(CASES)[name]
        ct = ts.cluster_to_torch(ts.ClusterTensors(**{
            k: torch.from_numpy(np.array(v))
            for k, v in case["cluster"].items()}), "cpu")
        pb = ts.pods_to_torch(ts.PodBatch(**{
            k: torch.from_numpy(np.array(v))
            for k, v in case["pods"].items()}), "cpu")
        emask = torch.ones((pb.n_pods, ct.n_nodes), dtype=torch.bool)
        ports = torch.zeros((pb.n_pods, 4), dtype=torch.bool)
        twin = tspec.plain_carry(ct, pb, ports, 5, emask, 3, False)
        dev = tspec.plain_carry(ct, pb, ports, 5, emask, 3, True)
        want = (ct.group_counts.T if k14_cases.spread_lean(case)
                else pb.spread_counts)
        assert torch.equal(twin["spread"], want)
        assert torch.equal(dev["spread"], want)
        assert dev["spread"].data_ptr() != want.data_ptr()
        assert twin["li"] == 5 and int(dev["li_dev"]) == 5
        assert dev["emask"].data_ptr() != emask.data_ptr()
        assert twin["topn"].shape == (pb.n_pods, 3)


def test_wrappers_refuse_cpu_tensors():
    t = torch.zeros((2, 3))
    for cls in (kernels.RoundFoldArgs, kernels.RoundCommitArgs):
        with pytest.raises(ValueError, match="CUDA"):
            kernels._bind("round", cls(), [("hosts", t, torch.float32,
                                            "B N")])


class _Ran:
    """A finished graph launch's event, for settling on the CPU."""

    def query(self):
        return True

    def synchronize(self):
        pass


def test_capture_records_launches_by_section():
    """Inside a capture the wrappers' counts are recorded by section and
    LAUNCHES stays as it is; a settled graph launch adds the WHILE body's
    once a round, the IF body's once if it redid, the rest once."""
    kernels.reset_launch_counts()
    with kernels.capturing() as rec:
        kernels._count("round_graph")
        rec.into("while")
        for name in ("filter_pass", "score_pass", "round_commit",
                     "select_hosts", "select_hosts"):
            kernels._count(name)
        rec.into("if")
        kernels._count("seq_scan")
        with pytest.raises(ValueError, match="section"):
            rec.into("body")
    assert not any(kernels.LAUNCHES.values())
    assert rec.launched == {
        "once": {"round_graph": 1},
        "while": {"filter_pass": 1, "score_pass": 1, "round_commit": 1,
                  "select_hosts": 2},
        "if": {"seq_scan": 1}}
    kernels._count("select_topk")       # outside a capture: counted
    for rounds, redo in ((3, 0), (2, 1)):
        kernels._GRAPH_PENDING.append(
            (_Ran(), torch.tensor([rounds, redo], dtype=torch.int32),
             rec.launched))
    got = kernels.settle_launches()
    assert got["select_hosts"] == 2 * 5 and got["filter_pass"] == 5
    assert got["seq_scan"] == 1 and got["round_graph"] == 2
    assert got["select_topk"] == 1 and not kernels._GRAPH_PENDING
    kernels.reset_launch_counts()
