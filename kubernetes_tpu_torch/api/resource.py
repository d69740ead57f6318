"""Resource quantities.

Reference: staging/src/k8s.io/apimachinery/pkg/api/resource (the `Quantity`
type).  The reference implements infinite-precision decimal arithmetic with
canonical serialization; the scheduler only ever uses quantities through
`MilliValue()` (CPU) and `Value()` (memory/storage/counts) — see
pkg/scheduler/nodeinfo/node_info.go:139-148 (`Resource{MilliCPU, Memory, ...}`).

We therefore parse to exact integers where possible and hold a float fallback,
which is lossless for every practically-occurring quantity ("100m", "2Gi",
"1.5G", "250M", plain integers).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from fractions import Fraction

_BIN_SUFFIX = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}
_DEC_SUFFIX = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}

_QTY_RE = re.compile(
    r"^\s*(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)"
    r"(?:[eE](?P<exp>[+-]?\d+))?"
    r"(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|n|u|m|k|M|G|T|P|E)?\s*$"
)


@dataclass(frozen=True)
class Quantity:
    """An exact rational quantity; arithmetic stays exact."""

    value: Fraction

    def __hash__(self) -> int:
        # Fraction.__hash__ is modular-inverse arithmetic; quantities are
        # hashed on every (req, nonzero) memo lookup in the cache-commit
        # path, so memoize it on the (frozen) instance.
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash(self.value)
            object.__setattr__(self, "_hash", h)
        return h

    @property
    def milli(self) -> int:
        """MilliValue(): value * 1000 rounded up (ref resource.Quantity.MilliValue)."""
        return math.ceil(self.value * 1000)

    @property
    def scalar(self) -> int:
        """Value(): rounded up to the nearest integer."""
        return math.ceil(self.value)

    def __float__(self) -> float:
        return float(self.value)

    def __add__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.value + other.value)

    def __sub__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.value - other.value)

    def __lt__(self, other: "Quantity") -> bool:
        return self.value < other.value

    def __le__(self, other: "Quantity") -> bool:
        return self.value <= other.value

    def __str__(self) -> str:
        if self.value.denominator == 1:
            return str(self.value.numerator)
        return str(float(self.value))


_PARSE_MEMO: dict = {}


def parse_quantity(s: "str | int | float | Quantity") -> Quantity:
    """Parse a Kubernetes quantity string ("100m", "2Gi", "1e3", 4) exactly.

    String parses are memoized to a canonical instance: workloads stamp
    thousands of pods with identical request strings, and sharing the
    instance lets downstream dict/tuple comparisons take the identity
    fast path (Quantity is immutable, so sharing is safe)."""
    if isinstance(s, Quantity):
        return s
    if isinstance(s, str):
        q = _PARSE_MEMO.get(s)
        if q is None:
            if len(_PARSE_MEMO) > 65536:
                _PARSE_MEMO.clear()
            q = _PARSE_MEMO[s] = _parse_quantity_str(s)
        return q
    if isinstance(s, int):
        # ints memoize like strings (pods: 110 across a 5k-node fleet):
        # sharing the canonical instance lets downstream memo keys take the
        # identity fast path; bool is an int subtype, fine to share too
        q = _PARSE_MEMO.get(s)
        if q is None:
            if len(_PARSE_MEMO) > 65536:
                _PARSE_MEMO.clear()
            q = _PARSE_MEMO[s] = Quantity(Fraction(s))
        return q
    if isinstance(s, float):
        return Quantity(Fraction(s).limit_denominator(10**9))
    raise ValueError(f"invalid quantity {s!r}")


def _parse_quantity_str(s: str) -> Quantity:
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity {s!r}")
    num_str = m.group("num")
    if num_str.startswith("."):
        num_str = "0" + num_str
    if num_str.endswith("."):
        num_str += "0"
    num = Fraction(num_str)
    if m.group("sign") == "-":
        num = -num
    exp = m.group("exp")
    if exp is not None:
        num *= Fraction(10) ** int(exp)
    suffix = m.group("suffix")
    if suffix in _BIN_SUFFIX:
        num *= _BIN_SUFFIX[suffix]
    elif suffix:
        num *= _DEC_SUFFIX[suffix]
    return Quantity(num)
