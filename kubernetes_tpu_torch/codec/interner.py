"""String interning: the host-side bridge from label/taint/name strings to
device int32 ids.

The reference does string compares in the hot loop (label map lookups in every
predicate, e.g. predicates.go PodMatchNodeSelector); on TPU strings cannot
exist, so every string the kernels consume is interned once at snapshot-encode
time.  Id 0 is reserved as the wildcard/empty id (used e.g. for host-port IP
"" / "0.0.0.0" which conflicts with every address, predicates host_ports
semantics); -1 is the universal padding value.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence


class Interner:
    WILDCARD = 0

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {"": self.WILDCARD}
        self._strs: List[str] = [""]

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._strs)
            self._ids[s] = i
            self._strs.append(s)
        return i

    def lookup(self, s: str) -> int:
        """Return the id for s, or -1 if never interned (matches nothing)."""
        return self._ids.get(s, -1)

    def string(self, i: int) -> str:
        return self._strs[i]

    def __len__(self) -> int:
        return len(self._strs)

    def intern_many(self, strs: Sequence[str]) -> List[int]:
        """Batch intern: id assignment order is exactly intern() called per
        string in sequence order (novel strings get consecutive ids).  The
        common shape — most strings already interned — is one C-speed dict
        lookup comprehension; only the misses walk the python patch loop.
        The bulk node ingest path stacks ~10 strings per node through
        this, and per-string method resolution dominated at 5k-node
        re-sync scale."""
        get = self._ids.get
        out = [get(s) for s in strs]
        if None in out:
            ids = self._ids
            lst = self._strs
            for idx, i in enumerate(out):
                if i is None:
                    s = strs[idx]
                    i = ids.get(s)  # a dup earlier in the batch may have won
                    if i is None:
                        i = ids[s] = len(lst)
                        lst.append(s)
                    out[idx] = i
        return out

    def intern_all(self, strs: Iterable[str]) -> List[int]:
        return self.intern_many(
            strs if isinstance(strs, (list, tuple)) else list(strs)
        )
