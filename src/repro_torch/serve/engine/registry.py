"""Snapshot registry: the serving engine's source of ensemble members.

Promotion is GATED: a candidate stack must pass the ensemble-spread check
(``repro_torch.diagnostics.ensemble_spread_device``) — a collapsed ensemble
(spread below ``min_rel_spread``) silently degrades Bayesian model
averaging to one model's predictions, and the registry is where that must
be caught, before the stack ever serves.  Stale members keep serving until
a candidate passes.  Two surfaces:

* ``propose(candidate)`` — gate and swap at once;
* ``stage(candidate)`` + ``flip_staged()`` — reduce now (queued on the
  device), fetch the verdict and swap later.

The background sampler that feeds it (``ChainRefresher``) is ported with
the sampler slice.
"""
from __future__ import annotations

from typing import Any

from repro_torch.diagnostics import ensemble_spread_device
from repro_torch.models.common import tree_leaves
from repro_torch.obs import trace as obs_trace


class SnapshotRegistry:
    """Holds the currently-serving (K, ...)-stacked ensemble; ``propose``
    swaps it iff the candidate passes the spread gate, and the
    ``stage``/``flip_staged`` pair does the same with the verdict's host
    fetch deferred."""

    def __init__(self, members, *, min_rel_spread: float = 1e-6, validate: bool = False):
        self.min_rel_spread = float(min_rel_spread)
        self.members = members
        self.num_members = int(tree_leaves(members)[0].shape[0])
        self.version = 0
        self.promoted = 0
        self.rejected = 0
        self.staged_total = 0
        self.last_health: dict | None = None
        self._staged: tuple[Any, dict] | None = None
        if validate:
            health = self._fetch_health(ensemble_spread_device(members))
            self.last_health = health
            if health["collapsed"]:
                raise ValueError(
                    f"initial ensemble is collapsed (rel_spread={health['rel_spread']:.3e})"
                )

    def health_device(self, candidate) -> dict:
        """The spread reduction of ``candidate`` as 0-d device tensors."""
        return ensemble_spread_device(candidate)

    def _fetch_health(self, health_dev: dict) -> dict:
        health = {k: float(v) for k, v in health_dev.items()}
        health["num_chains"] = self.num_members
        health["collapsed"] = bool(health["rel_spread"] < self.min_rel_spread)
        return health

    def _check_k(self, candidate) -> None:
        k = int(tree_leaves(candidate)[0].shape[0])
        if k != self.num_members:
            raise ValueError(f"candidate has K={k}, registry serves K={self.num_members}")

    def propose(self, candidate) -> bool:
        """Gate + swap.  Returns True iff ``candidate`` was promoted; on
        rejection the previous members keep serving unchanged."""
        self.stage(candidate)
        with obs_trace.get().span("refresh.flip", cat="refresh", sync=True):
            return self.flip_staged()

    def stage(self, candidate, health=None) -> None:
        """Park ``candidate`` and queue its spread verdict; replaces any
        previously staged candidate.  Nothing here waits on the device."""
        self._check_k(candidate)
        if health is None:
            health = self.health_device(candidate)
        self._staged = (candidate, health)
        self.staged_total += 1
        obs_trace.get().instant("refresh.stage", cat="refresh", staged=self.staged_total)

    def flip_staged(self) -> bool:
        """Fetch the staged verdict and promote or reject.  Promotion
        rebinds ``members``."""
        if self._staged is None:
            return False
        candidate, health_dev = self._staged
        self._staged = None
        health = self._fetch_health(health_dev)
        self.last_health = health
        if health["collapsed"]:
            self.rejected += 1
            return False
        self.members = candidate
        self.version += 1
        self.promoted += 1
        return True

    def stats(self) -> dict:
        return {
            "version": self.version,
            "promoted": self.promoted,
            "rejected": self.rejected,
            "staged_total": self.staged_total,
            "staged_pending": self._staged is not None,
            "num_members": self.num_members,
            "last_health": self.last_health,
        }
