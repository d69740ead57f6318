"""Scheduling profiles: algorithm providers + legacy Policy.

The reference builds a runnable scheduler from either an AlgorithmProvider
name or a JSON Policy (scheduler.go:162-192 CreateFromProvider/
CreateFromConfig; registries in factory/plugins.go; stock sets in
algorithmprovider/defaults/defaults.go).  A SchedulingProfile is the compiled
result: the enabled predicate tuple, the priority weight vector, and the
static kernel configs — everything the device pipeline needs, hashable so
the engines' caches can key on it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.codec.schema import (
    DEFAULT_PRIORITY_WEIGHTS,
    FilterConfig,
    PREDICATE_ORDER,
    PRIO_INDEX,
    PRIORITY_ORDER,
    ScoreConfig,
)
from kubernetes_tpu_torch.config.featuregates import FeatureGates

DEFAULT_PROVIDER = "DefaultProvider"
CLUSTER_AUTOSCALER_PROVIDER = "ClusterAutoscalerProvider"

# defaults.go defaultPredicates() — by name
_DEFAULT_PREDICATES = (
    "NoVolumeZoneConflict",
    "MaxEBSVolumeCount",
    "MaxGCEPDVolumeCount",
    "MaxAzureDiskVolumeCount",
    "MaxCSIVolumeCount",
    "MatchInterPodAffinity",
    "NoDiskConflict",
    "GeneralPredicates",
    "PodFitsHost",          # components of GeneralPredicates, kept for
    "PodFitsHostPorts",     # failure attribution granularity
    "PodMatchNodeSelector",
    "PodFitsResources",
    "CheckNodeMemoryPressure",
    "CheckNodeDiskPressure",
    "CheckNodePIDPressure",
    "CheckNodeCondition",
    "PodToleratesNodeTaints",
    "CheckVolumeBinding",
)

_DEFAULT_PRIORITIES = {
    "SelectorSpreadPriority": 1.0,
    "InterPodAffinityPriority": 1.0,
    "LeastRequestedPriority": 1.0,
    "BalancedResourceAllocation": 1.0,
    "NodePreferAvoidPodsPriority": 10000.0,
    "NodeAffinityPriority": 1.0,
    "TaintTolerationPriority": 1.0,
    "ImageLocalityPriority": 1.0,
}


@dataclass(frozen=True)
class SchedulingProfile:
    name: str
    filter_config: FilterConfig
    score_config: ScoreConfig
    weights: tuple  # len == NUM_PRIORITIES, PRIORITY_ORDER order
    hard_pod_affinity_weight: float = 1.0
    always_check_all_predicates: bool = False
    # Policy "extenders" entries (api/types.go:203-240), as
    # extender.client.ExtenderConfig
    extender_configs: tuple = ()

    def weights_array(self) -> np.ndarray:
        return np.asarray(self.weights, np.float32)


def _apply_feature_gates(pred_set: set, prio: Dict[str, float], gates: FeatureGates):
    """defaults.go ApplyFeatureGates: TaintNodesByCondition removes the
    condition predicates and makes taint/unschedulable checks mandatory;
    ResourceLimitsPriorityFunction registers its priority at weight 1."""
    if gates.enabled("TaintNodesByCondition"):
        pred_set -= {
            "CheckNodeCondition",
            "CheckNodeMemoryPressure",
            "CheckNodeDiskPressure",
            "CheckNodePIDPressure",
        }
        pred_set |= {"PodToleratesNodeTaints", "CheckNodeUnschedulable"}
    if not gates.enabled("VolumeScheduling"):
        pred_set -= {"CheckVolumeBinding"}
    if gates.enabled("ResourceLimitsPriorityFunction"):
        prio["ResourceLimitsPriority"] = 1.0


def _weights_vector(prio: Dict[str, float]) -> tuple:
    w = np.zeros(len(PRIORITY_ORDER), np.float32)
    for name, weight in prio.items():
        if name not in PRIO_INDEX:
            raise ValueError(f"unknown priority {name!r}")
        w[PRIO_INDEX[name]] = weight
    return tuple(float(x) for x in w)


def algorithm_provider(
    name: str = DEFAULT_PROVIDER,
    gates: Optional[FeatureGates] = None,
    hard_pod_affinity_weight: float = 1.0,
) -> SchedulingProfile:
    """CreateFromProvider (scheduler.go:164-173)."""
    gates = gates or FeatureGates()
    pred_set = set(_DEFAULT_PREDICATES)
    prio = dict(_DEFAULT_PRIORITIES)
    if name == CLUSTER_AUTOSCALER_PROVIDER:
        # copyAndReplace(LeastRequested -> MostRequested), defaults.go:105
        prio.pop("LeastRequestedPriority")
        prio["MostRequestedPriority"] = 1.0
    elif name != DEFAULT_PROVIDER:
        raise ValueError(f"unknown algorithm provider {name!r}")
    _apply_feature_gates(pred_set, prio, gates)
    return SchedulingProfile(
        name=name,
        filter_config=FilterConfig(
            enabled=tuple(sorted(pred_set)),
            hard_pod_affinity_weight=hard_pod_affinity_weight,
        ),
        score_config=ScoreConfig(),
        weights=_weights_vector(prio),
        hard_pod_affinity_weight=hard_pod_affinity_weight,
    )


def profile_from_policy(
    policy: dict,
    interner=None,
    gates: Optional[FeatureGates] = None,
) -> SchedulingProfile:
    """Legacy Policy JSON (pkg/scheduler/api/types.go Policy; loaded from a
    file or ConfigMap, scheduler.go:172-192).  Shape:

      {"kind": "Policy", "predicates": [{"name": ...,
          "argument": {"labelsPresence": {"labels": [...], "presence": true}}}],
       "priorities": [{"name": ..., "weight": w,
          "argument": {"labelPreference": ..., "requestedToCapacityRatioArguments": ...}}],
       "hardPodAffinitySymmetricWeight": 1, "alwaysCheckAllPredicates": false}

    An empty predicates/priorities list means "use defaults" (factory
    CreateFromConfig).  `interner` is needed to resolve label strings for
    label-presence arguments.
    """
    gates = gates or FeatureGates()
    label_keys: list = []
    label_presence = True
    label_prefs: list = []
    svc_aff_labels: list = []
    rtc_shape = None

    preds = policy.get("predicates")
    if preds is None:
        pred_set = set(_DEFAULT_PREDICATES)
    else:
        pred_set = set()
        for p in preds:
            name = p["name"]
            arg = p.get("argument") or {}
            if "labelsPresence" in arg:
                lp = arg["labelsPresence"]
                name = "CheckNodeLabelPresence"
                for lab in lp.get("labels", []):
                    label_keys.append(
                        interner.intern(lab) if interner is not None else lab
                    )
                label_presence = bool(lp.get("presence", True))
            elif "serviceAffinity" in arg:
                name = "CheckServiceAffinity"
                for lab in arg["serviceAffinity"].get("labels", []):
                    svc_aff_labels.append(
                        interner.intern(lab) if interner is not None else lab
                    )
            if name == "GeneralPredicates":
                pred_set |= {
                    "PodFitsHost", "PodFitsHostPorts",
                    "PodMatchNodeSelector", "PodFitsResources",
                }
            if name not in PREDICATE_ORDER:
                raise ValueError(f"unknown predicate {name!r}")
            pred_set.add(name)

    prios = policy.get("priorities")
    if prios is None:
        prio = dict(_DEFAULT_PRIORITIES)
    else:
        prio = {}
        for p in prios:
            name = p["name"]
            weight = float(p.get("weight", 1))
            arg = p.get("argument") or {}
            if "labelPreference" in arg:
                lp = arg["labelPreference"]
                key = lp.get("label", "")
                label_prefs.append(
                    (
                        interner.intern(key) if interner is not None else key,
                        bool(lp.get("presence", True)),
                        weight,
                    )
                )
                prio["NodeLabelPriority"] = 1.0  # weights folded per-pref
                continue
            if "requestedToCapacityRatioArguments" in arg:
                shape = arg["requestedToCapacityRatioArguments"].get("shape", [])
                rtc_shape = tuple(
                    (float(pt["utilization"]), float(pt["score"])) for pt in shape
                )
                prio["RequestedToCapacityRatioPriority"] = weight
                continue
            if name not in PRIO_INDEX:
                raise ValueError(f"unknown priority {name!r}")
            prio[name] = weight

    _apply_feature_gates(pred_set, prio, gates)
    hard_w = float(policy.get("hardPodAffinitySymmetricWeight", 1))
    fc = FilterConfig(
        enabled=tuple(sorted(pred_set)),
        hard_pod_affinity_weight=hard_w,
        label_presence_keys=tuple(label_keys),
        label_presence_present=label_presence,
        service_affinity_labels=tuple(svc_aff_labels),
    )
    sc = ScoreConfig(
        label_prefs=tuple(label_prefs),
        rtc_shape=rtc_shape if rtc_shape else ScoreConfig.rtc_shape,
    )
    from kubernetes_tpu_torch.extender.client import ExtenderConfig

    return SchedulingProfile(
        name="policy",
        filter_config=fc,
        score_config=sc,
        weights=_weights_vector(prio),
        hard_pod_affinity_weight=hard_w,
        always_check_all_predicates=bool(policy.get("alwaysCheckAllPredicates", False)),
        extender_configs=tuple(
            ExtenderConfig.from_dict(e) for e in policy.get("extenders") or ()
        ),
    )
