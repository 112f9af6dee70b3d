"""Deterministic fault injection for the advisor stack.

A long-lived advisor session has to survive transient estimation
failures, poisoned deltas and lost replay state, and its exact-parity
contract (a session recommends what a fresh `DesignAdvisor` recommends)
has to hold THROUGH those failures.  Testing that needs failures that are
perfectly reproducible: `FaultInjector` draws every fire/no-fire decision
from a per-site seed-derived NumPy stream indexed by that site's own check
counter, so the fault schedule is a pure function of (seed, site,
per-site check index), independent of how checks at different sites
interleave, like `SampleManager`'s order-independent sample streams.
Schedules are bit-identical to the JAX package's for the same seed.

Sites (where the stack calls `check()` / `fires()`):

* ``estimation``     -- `AdvisorSession._estimate_sizes`, before the
  SampleCF execution of a recommend.
* ``costing``        -- `AdvisorSession.recommend`, before what-if costing.
* ``planner_replay`` -- `PlannerEngine._run`: a firing here does not
  raise; it DROPS the replay state (the per-record decisions on numpy,
  the memoized walks on torch), so the next run recomputes, bit-
  identically.
* ``apply_delta``    -- top of `AdvisorSession.apply`, before any state is
  touched (so a faulted delta is cleanly retryable).
* ``prefetch``       -- `AdvisorFleetService._prefetch`, before each
  union-batched SampleCF call.
* ``disk_write``, ``fsync``, ``bit_flip`` -- `DurableStore.log_delta`: a
  torn append, a failed group commit, a silently flipped payload bit.

Site streams are seeded independently per site -- (seed, crc32(site)) --
so enabling one site never shifts another's draws.

`FaultError` marks a fault as transient: the caller retries the operation
that raised it.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Tuple, Union

import numpy as np

#: The named sites, in the JAX package's order; a site's stream is seeded
#: by (seed, crc32(site)), not by its position here.
SITES = ("estimation", "costing", "planner_replay", "prefetch",
         "apply_delta", "disk_write", "fsync", "bit_flip")


class FaultError(RuntimeError):
    """An injected, transient fault (the caller may retry)."""

    def __init__(self, site: str, n: int, detail: str = ""):
        msg = f"injected fault at site {site!r} (check #{n})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.site = site
        self.n = n


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """When a site fires.

    `rate` fires each check independently with that probability (drawn
    from the site's own RNG stream).  `at` additionally fires at the given
    0-based check indices.  `max_fires` caps the total fires at the site
    (the stream keeps advancing, so the schedule of a capped site is a
    prefix of the uncapped one)."""
    rate: float = 0.0
    at: Tuple[int, ...] = ()
    max_fires: Optional[int] = None


class FaultInjector:
    """Seeded, per-site deterministic fault source.

    Usage::

        inj = FaultInjector(seed=7, specs={
            "estimation": 0.05,                  # shorthand for rate
            "apply_delta": FaultSpec(at=(0, 3)), # scripted checks
        })
        inj.check("estimation")    # raises FaultError when it fires
        if inj.fires("planner_replay"): ...   # poll form (no raise)
    """

    def __init__(self, seed: int = 0,
                 specs: Optional[Dict[str, Union[float, FaultSpec]]] = None):
        self.seed = int(seed)
        self.specs: Dict[str, FaultSpec] = {}
        for site, sp in (specs or {}).items():
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; known sites: {SITES}")
            self.specs[site] = (sp if isinstance(sp, FaultSpec)
                                else FaultSpec(rate=float(sp)))
        self._rng = {
            site: np.random.default_rng(
                (self.seed, zlib.crc32(site.encode("utf-8"))))
            for site in SITES}
        self.checks: Dict[str, int] = {s: 0 for s in SITES}
        self.fired: Dict[str, int] = {s: 0 for s in SITES}

    def fires(self, site: str) -> bool:
        """Advance `site`'s stream one check; True when the fault fires."""
        n = self.checks[site]
        self.checks[site] = n + 1
        sp = self.specs.get(site)
        if sp is None:
            return False
        hit = n in sp.at
        if sp.rate > 0.0:
            # always draw, so the stream position is a pure function of
            # the check index (scripted `at` hits don't shift it)
            hit = bool(self._rng[site].random() < sp.rate) or hit
        if not hit:
            return False
        if sp.max_fires is not None and self.fired[site] >= sp.max_fires:
            return False
        self.fired[site] += 1
        return True

    def check(self, site: str, detail: str = "") -> None:
        """Raise `FaultError` when the fault at `site` fires."""
        if self.fires(site):
            raise FaultError(site, self.checks[site] - 1, detail)

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {"checks": dict(self.checks), "fired": dict(self.fired)}
