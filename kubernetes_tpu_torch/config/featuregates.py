"""Runtime feature gates.

Reference: pkg/features/kube_features.go (66 gates, queried through
utilfeature.DefaultFeatureGate.Enabled) — the scheduler-relevant subset with
the reference's v1.15 defaults.  Gates rewire the active predicate/priority
sets (algorithmprovider/defaults/defaults.go ApplyFeatureGates).
"""

from __future__ import annotations

from typing import Dict, Optional

# scheduler-relevant gates and their v1.15 defaults
DEFAULT_GATES: Dict[str, bool] = {
    "TaintNodesByCondition": True,     # conditions become taints; condition
                                       # predicates removed (defaults.go:59-97)
    "ResourceLimitsPriorityFunction": False,
    "BalanceAttachedNodeVolumes": False,
    "AttachVolumeLimit": True,         # per-node attachable-volumes-* limits
    "PodPriority": True,
    "TaintBasedEvictions": False,
    "ScheduleDaemonSetPods": True,
    "VolumeScheduling": True,          # CheckVolumeBinding enabled
    "LocalStorageCapacityIsolation": True,  # ephemeral-storage accounting
}


class FeatureGates:
    def __init__(self, overrides: Optional[Dict[str, bool]] = None):
        self._gates = dict(DEFAULT_GATES)
        for k, v in (overrides or {}).items():
            self._gates[k] = bool(v)

    def enabled(self, name: str) -> bool:
        return self._gates.get(name, False)

    @staticmethod
    def from_string(s: str) -> "FeatureGates":
        """Parse the --feature-gates flag format: "A=true,B=false"."""
        overrides = {}
        for part in filter(None, (p.strip() for p in s.split(","))):
            k, _, v = part.partition("=")
            overrides[k] = v.lower() in ("true", "1", "t")
        return FeatureGates(overrides)
