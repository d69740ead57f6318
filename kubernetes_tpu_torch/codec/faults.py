"""Device-fault model: classified errors + a deterministic injection seam.

The PyTorch port's copy of the JAX package's codec/faults.py.  The
reference treats fault tolerance as a first-class harness, but its faults
all live at the CLUSTER layer (pods die, nodes go dark, leaders crash).  A
device control plane has a second failure domain: the accelerator itself,
and each of its failures deserves a different response from the loop:

  transient   retry the SAME in-flight batch with jittered backoff
              (on CUDA: an allocation failure)
  persistent  stop using the device NOW (trip the breaker); on CUDA the
              sticky context errors (illegal memory access, device-side
              assert, unspecified launch failure, misaligned address)
  corrupt     a fetch that *returned* but fails structural validation
              (winner rows out of range); treated as transient — re-run
  slow        not an error: injected latency, exercises the overlap math

This module owns (a) the classified exception types, (b) the mapping from
real CUDA errors to a fault class (the PyTorch port's twin of the JAX
package's XLA status mapping), and (c) `FaultInjector` — a
seeded, deterministic injector the chaos harness (runtime/chaos.py
Disruptions) arms per SITE:

  dispatch         engine launch in Scheduler._encode_and_dispatch
  fence            the ready-fence (AsyncFetch.result / ready_fence)
  fetch            D2H materialization (host_fetch / the fetch worker)
  snapshot_update  DeviceSnapshotCache.update (H2D delta upload)
  scatter          the dirty-row scatter into a resident buffer
                   (_scatter_rows / _scatter_rows_sharded — per-shard on
                   a mesh, so this is the shard-attributable H2D seam)

Injection is OFF unless an injector is installed (`install_injector`); the
instrumented code calls `check(site)` / `corrupt(site, arr)` which are
no-ops otherwise, so the hot path pays one module-global load per site.
"""

from __future__ import annotations

import random
import re
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np

# fault classes (the breaker's retry-policy vocabulary + metrics label)
FAULT_TRANSIENT = "transient"
FAULT_PERSISTENT = "persistent"
FAULT_CORRUPT = "corrupt"
FAULT_SLOW = "slow"

# injection sites (the seams instrumented in codec/transfer.py and
# runtime/scheduler.py)
SITE_DISPATCH = "dispatch"
SITE_FENCE = "fence"
SITE_FETCH = "fetch"
SITE_SNAPSHOT_UPDATE = "snapshot_update"
# the dirty-row scatter into a resident device buffer (H2D delta path,
# _scatter_rows / _scatter_rows_sharded): on a mesh each scatter lands on
# the shard that owns the rows, so a scatter-side fault is exactly the
# per-shard failure the elastic ladder attributes
SITE_SCATTER = "scatter"
SITES = (SITE_DISPATCH, SITE_FENCE, SITE_FETCH, SITE_SNAPSHOT_UPDATE,
         SITE_SCATTER)


class DeviceFault(RuntimeError):
    """Base for classified device-path failures (injected or mapped from
    real runtime errors).  `fault_class` drives the retry/breaker policy;
    `device_index` (when known) attributes the fault to ONE device of the
    mesh — its device index — so the scheduler can lose that shard instead
    of the whole mesh (runtime/scheduler.py elastic degradation ladder)."""

    fault_class = FAULT_TRANSIENT
    device_index: Optional[int] = None


class TransientDeviceError(DeviceFault):
    """Clears on its own: retry the same batch with backoff."""

    fault_class = FAULT_TRANSIENT


class PersistentDeviceError(DeviceFault):
    """Device lost: trip the breaker, degrade to the CPU engine."""

    fault_class = FAULT_PERSISTENT


class CorruptedFetchError(DeviceFault):
    """A fetch returned structurally-invalid data (winner rows out of
    range).  Retried like a transient fault — the wire, not the program."""

    fault_class = FAULT_TRANSIENT


# CUDA error text -> fault class (the port's twin of the JAX package's XLA
# status mapping).  An allocation failure clears once the caching allocator
# frees blocks (or the next cycle is smaller): retry.  The sticky context
# errors leave the CUDA context unusable for the rest of the process: every
# later call on it fails the same way, so retrying is pointless.
_CUDA_PERSISTENT_MARKERS = (
    "illegal memory access",
    "device-side assert",
    "unspecified launch failure",
    "misaligned address",
)
_CUDA_TRANSIENT_MARKERS = (
    "CUDA out of memory",
)


def classify_cuda_error(err: BaseException) -> Optional[str]:
    """Map an exception from a CUDA call to a fault class, or None when it
    is not a device fault.  torch raises an allocation failure as
    torch.OutOfMemoryError (a RuntimeError) and the sticky context errors
    as torch.AcceleratorError or a RuntimeError whose message carries
    "CUDA error:"; names and messages are matched, so this module imports
    no torch."""
    if not isinstance(err, RuntimeError):
        return None
    msg = str(err)
    if type(err).__name__ == "OutOfMemoryError" or any(
            m in msg for m in _CUDA_TRANSIENT_MARKERS):
        return FAULT_TRANSIENT
    if type(err).__name__ == "AcceleratorError" or "CUDA error:" in msg:
        if any(m in msg for m in _CUDA_PERSISTENT_MARKERS):
            return FAULT_PERSISTENT
    return None


def classify_device_error(err: BaseException) -> Optional[str]:
    """Map an exception raised on the device path to a fault class, or None
    when it is NOT a device fault (a programming error must propagate, not
    be retried into oblivion): the class of an injected or classified
    DeviceFault, else classify_cuda_error."""
    if isinstance(err, DeviceFault):
        return err.fault_class
    return classify_cuda_error(err)


# "device 3", "device: 3", "device #3", "TPU_2" — the message shapes real
# runtimes use when they can name the failing chip.  Deliberately narrow:
# a miss means "unattributed" (whole-mesh policy), never a wrong shard.
_DEVICE_ID_RE = re.compile(r"\bdevice[ :#]+(\d+)\b|\bTPU_(\d+)\b")


def fault_device_index(err: BaseException) -> Optional[int]:
    """Which device (by index) a classified device fault blames, or None
    when the error names no single device.  Injected faults carry the
    index as an attribute; real runtime errors are matched against
    the narrow message patterns above."""
    idx = getattr(err, "device_index", None)
    if idx is not None:
        return int(idx)
    if isinstance(err, RuntimeError):
        mt = _DEVICE_ID_RE.search(str(err))
        if mt is not None:
            return int(mt.group(1) or mt.group(2))
    return None


@dataclass
class _Arm:
    kind: str
    p: float
    count: Optional[int]        # max fires; None = unlimited
    latency_s: float
    # shard-targeted arm: fire only when the instrumented call reports
    # one of these devices (by index) among the devices it touches — the
    # "mesh device(s) are dead" chaos primitive.  None = untargeted (the
    # historical behavior: every call at the site faults).
    device_index: Optional[frozenset] = None
    fired: int = 0


class FaultInjector:
    """Seeded, deterministic per-site fault injection.

    arm(site, kind, ...) arms one site with one fault kind; `count` bounds
    how many times it fires (the deterministic lever the fault-matrix
    tests use: count=1 == "exactly the first call faults"), `p` makes it
    probabilistic from the injector's own seeded rng.  `log` records every
    fire as (site, kind) for assertions."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._arms: dict = {}
        self.log: list = []

    def arm(
        self,
        site: str,
        kind: str = FAULT_TRANSIENT,
        p: float = 1.0,
        count: Optional[int] = None,
        latency_s: float = 0.01,
        device_index: Optional[int] = None,
    ) -> "FaultInjector":
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (sites: {SITES})")
        if kind not in (FAULT_TRANSIENT, FAULT_PERSISTENT, FAULT_CORRUPT,
                        FAULT_SLOW):
            raise ValueError(f"unknown fault kind {kind!r}")
        if device_index is not None and not isinstance(
            device_index, (set, frozenset, list, tuple)
        ):
            device_index = (device_index,)
        self._arms[site] = _Arm(
            kind=kind, p=p, count=count, latency_s=latency_s,
            device_index=(
                frozenset(int(d) for d in device_index)
                if device_index is not None else None
            ),
        )
        return self

    def arm_devices(
        self,
        site: str,
        devices: Iterable[int],
        kind: str = FAULT_PERSISTENT,
        count: Optional[int] = None,
    ) -> "FaultInjector":
        """Merge device targets into the site's arm (creating it when
        absent).  Unlike re-arming, an existing same-kind targeted arm
        keeps its consumed fire budget (`fired`) — the accumulate
        primitive Disruptions.shard_lost builds on (losing a second
        device must not refresh the first one's count= budget)."""
        targets = frozenset(int(d) for d in devices)
        arm = self._arms.get(site)
        if arm is not None and arm.device_index and arm.kind == kind:
            arm.device_index = arm.device_index | targets
            if count is not None:
                arm.count = count
            return self
        return self.arm(site, kind=kind, count=count, device_index=targets)

    def clear_devices(
        self, site: str, devices: Optional[Iterable[int]] = None
    ) -> None:
        """Remove device targets from the site's TARGETED arm (None =
        all of them), disarming the site when none remain; the arm's
        remaining budget is preserved.  Untargeted arms are never
        touched — they belong to other primitives."""
        arm = self._arms.get(site)
        if arm is None or arm.device_index is None:
            return
        remaining = (
            arm.device_index - frozenset(int(d) for d in devices)
            if devices is not None else frozenset()
        )
        if remaining:
            arm.device_index = remaining
        else:
            del self._arms[site]

    def is_armed(self, site: str) -> bool:
        return site in self._arms

    def disarm(self, site: Optional[str] = None) -> None:
        if site is None:
            self._arms.clear()
        else:
            self._arms.pop(site, None)

    def _should_fire(self, a: _Arm) -> bool:
        if a.count is not None and a.fired >= a.count:
            return False
        if a.p < 1.0 and self._rng.random() >= a.p:
            return False
        return True

    def fire(self, site: str,
             devices: Optional[Iterable[int]] = None) -> None:
        """Raise/sleep per the site's armed fault; corrupt-kind arms are
        handled by maybe_corrupt (they alter data, not control flow).

        `devices` reports which device ids the instrumented call touches
        (the mesh's device set at dispatch/scatter, the fetched buffer's
        sharding at fetch/fence; None = unknown).  A shard-targeted arm
        (device_index set) fires only when its device is among them — a
        dead shard faults every computation that involves it, lets
        everything else through, and the half-open probe of exactly that
        device (devices=(d,)) keeps failing until the arm clears."""
        a = self._arms.get(site)
        if a is None or a.kind == FAULT_CORRUPT:
            return
        hit: Optional[int] = None
        if a.device_index is not None:
            if devices is None:
                return
            common = a.device_index.intersection(
                int(d) for d in devices
            )
            if not common:
                return
            # the error blames ONE device (the attribution contract);
            # min() keeps repeated fires deterministic
            hit = min(common)
        if not self._should_fire(a):
            return
        a.fired += 1
        self.log.append((site, a.kind))
        if a.kind == FAULT_SLOW:
            time.sleep(a.latency_s)
            return
        if a.kind == FAULT_PERSISTENT:
            err: DeviceFault = PersistentDeviceError(
                f"injected device-lost at {site} (fire #{a.fired})"
            )
        else:
            err = TransientDeviceError(
                f"injected transient XLA error at {site} (fire #{a.fired}): "
                "UNAVAILABLE: fabric tunnel reset"
            )
        err.device_index = hit
        raise err

    def maybe_corrupt(self, site: str, arr):
        """Scramble a fetched array when the site is armed with a corrupt
        fault: winner rows are pushed far out of range so structural
        validation (scheduler._validate_hosts) catches it — the seam has no
        checksum, so in-range corruption is out of scope by design."""
        a = self._arms.get(site)
        if a is None or a.kind != FAULT_CORRUPT or not self._should_fire(a):
            return arr
        a.fired += 1
        self.log.append((site, FAULT_CORRUPT))
        out = np.array(arr)
        if out.dtype.kind in ("i", "u"):
            out = out + (1 << 20)
        else:
            out = out + np.float32(3.0e38)
        return out


# ------------------------------------------------------- the global seam

_INJECTOR: Optional[FaultInjector] = None


def install_injector(inj: FaultInjector) -> Callable[[], None]:
    """Install `inj` as the process-wide injector; returns a remover that
    restores whatever was installed before (tests stack cleanly)."""
    global _INJECTOR
    prev = _INJECTOR
    _INJECTOR = inj

    def remove() -> None:
        global _INJECTOR
        _INJECTOR = prev

    return remove


def current_injector() -> Optional[FaultInjector]:
    return _INJECTOR


def check(site: str, devices: Optional[Iterable[int]] = None) -> None:
    """Instrumentation hook: fire the armed fault for `site`, if any.
    `devices` (optional) names the device ids the call touches so
    shard-targeted arms can fire selectively (see FaultInjector.fire)."""
    inj = _INJECTOR
    if inj is not None:
        inj.fire(site, devices=devices)


def corrupt(site: str, arr):
    """Instrumentation hook: corrupt fetched data for `site`, if armed."""
    inj = _INJECTOR
    if inj is not None:
        return inj.maybe_corrupt(site, arr)
    return arr
