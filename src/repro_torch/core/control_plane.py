"""Adapter control plane: shadow eval, regression gate, rollback policy.

Counterpart of ``repro.core.control_plane``, which imports no JAX: this is a
copy, whole. Bitwise parity of a session with the offline trainer says the
adaptation is *reproducible*, not that it helped; this module is the policy
half of noticing an ``adapt`` that made a tenant worse:

  - **shadow eval**: every tenant holds out a deterministic slice of its
    ingested rows (``batch_plan.shadow_split``: local row ``r`` is held out
    iff ``(r + 1) % holdout_every == 0``). The session runtime computes the
    pre- and post-adapt held-out loss from the *cached* activations, in the
    same epoch call as training, so shadow eval never runs the backbone.
  - **regression gate**: a write-back whose held-out loss regressed by more
    than ``threshold`` is not installed. ``mode="reject"`` also freezes the
    tenant's training state (the next adapt retrains the same rows from the
    served version); ``mode="quarantine"`` lets training state advance but
    keeps serving the old version and flags the tenant.
  - **rollback ledger**: gate decisions, eval deltas and rollback counts per
    tenant (``metrics``), and the scheduler's ``quality_metrics``.

The *mechanism* lives elsewhere: ``AdapterPool`` owns versioned slots and
applies the gate inside ``register_many``; ``SessionRuntime`` owns the eval
and the reject/quarantine state semantics. This module only decides and
records. It holds no tensors, so its whole state is a small JSON-able dict.

Everything here is opt-in: a session without a ``ControlConfig`` plans,
trains and writes back exactly as before.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

GATE_MODES = ("reject", "quarantine")


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Control-plane policy knobs.

    holdout_every: every N-th ingested row per tenant is held out for
        shadow eval (>= 2; row 0 always trains). Tenants with fewer rows
        than ``holdout_every`` have an empty eval set and pass ungated.
    threshold: max tolerated held-out regression, ``post - pre`` in nats.
        0.0 = any regression gates; ``float("inf")`` = gate never fires
        (eval/metrics only).
    mode: what a gated write-back does to the tenant's *training* state —
        "reject" freezes it (retrain from the served version next adapt),
        "quarantine" advances it but keeps serving the old payload and
        flags the tenant.
    history_depth: previous adapter versions kept per tenant for
        ``rollback`` (>= 1 so the gate always has a version to protect).
    auto_rollback_after: N consecutive gated (non-accept) write-backs for
        the same tenant trigger an automatic ``rollback(tenant)`` plus an
        optimizer-state reset in the runtime — the served version is
        presumed stale-bad, not merely one noisy epoch. ``None`` (default)
        disables the policy; the manual ``rollback`` path is unaffected.
    """

    holdout_every: int = 4
    threshold: float = 0.0
    mode: str = "reject"
    history_depth: int = 2
    auto_rollback_after: Optional[int] = None

    def __post_init__(self):
        if self.auto_rollback_after is not None and self.auto_rollback_after < 1:
            raise ValueError(
                f"auto_rollback_after {self.auto_rollback_after} < 1 would "
                "roll back unconditionally"
            )
        if self.holdout_every < 2:
            raise ValueError(
                f"holdout_every {self.holdout_every} < 2 leaves no train rows"
            )
        if self.mode not in GATE_MODES:
            raise ValueError(f"unknown gate mode {self.mode!r}")
        if self.history_depth < 1:
            raise ValueError(
                f"history_depth {self.history_depth} < 1: the gate needs at "
                "least one archived version to protect"
            )


class ControlPlane:
    """Per-tenant gate ledger: decides write-backs, records the outcomes.

    One instance per session. Tenant keys are whatever the session uses
    (ints or strings); state round-trips through JSON as lists of pairs,
    so int tenant ids survive a manifest (JSON objects would stringify
    them).
    """

    def __init__(self, config: ControlConfig):
        self.config = config
        #: tenant -> {"pre", "post", "delta", "decision", "step"} of the
        #: most recent gated adapt (None fields while no eval ran).
        self._last: dict[Any, dict] = {}
        #: tenants currently quarantined (served from the pre-adapt
        #: version, flagged for re-adapt / operator attention).
        self._quarantined: set = set()
        #: tenant -> consecutive non-accept gate decisions (the
        #: auto-rollback trigger; reset by an accept or any rollback).
        self._consec_gated: dict[Any, int] = {}
        self.accepted = 0
        self.rejected = 0
        self.quarantined = 0
        self.rollbacks = 0
        self.auto_rollbacks = 0

    # -- decisions -----------------------------------------------------------

    def decide(self, tenant, pre: Optional[float], post: Optional[float]) -> str:
        """Gate one tenant's write-back from its held-out losses.

        ``None`` (no eval rows, or first-ever version) always accepts: a
        fresh tenant has no served version to protect, and a tenant below
        ``holdout_every`` rows has nothing to measure. Otherwise the
        write-back is gated iff ``post - pre > threshold``.
        """
        if pre is None or post is None:
            return "accept"
        if post - pre > self.config.threshold:
            return self.config.mode
        return "accept"

    def record(
        self,
        tenant,
        decision: str,
        *,
        pre: Optional[float] = None,
        post: Optional[float] = None,
        step: int = 0,
    ) -> None:
        """Ledger one gate outcome (the runtime calls this right after
        write-back, whatever ``decide`` said)."""
        self._last[tenant] = {
            "pre": pre,
            "post": post,
            "delta": None if pre is None or post is None else post - pre,
            "decision": decision,
            "step": int(step),
        }
        if decision == "accept":
            self.accepted += 1
            self._quarantined.discard(tenant)
            self._consec_gated.pop(tenant, None)
        elif decision == "reject":
            self.rejected += 1
            self._consec_gated[tenant] = self._consec_gated.get(tenant, 0) + 1
        elif decision == "quarantine":
            self.quarantined += 1
            self._quarantined.add(tenant)
            self._consec_gated[tenant] = self._consec_gated.get(tenant, 0) + 1
        else:
            raise ValueError(f"unknown gate decision {decision!r}")

    def should_auto_rollback(self, tenant) -> bool:
        """True when the auto-rollback policy fires for this tenant: the
        config enables it and the tenant's consecutive non-accept streak
        reached ``auto_rollback_after``. The runtime consults this right
        after ``record``; the streak resets on accept or on any rollback."""
        after = self.config.auto_rollback_after
        return after is not None and self._consec_gated.get(tenant, 0) >= after

    def record_rollback(self, tenant, *, auto: bool = False) -> None:
        self.rollbacks += 1
        if auto:
            self.auto_rollbacks += 1
        self._quarantined.discard(tenant)
        self._consec_gated.pop(tenant, None)
        self._last.pop(tenant, None)

    # -- introspection -------------------------------------------------------

    def is_quarantined(self, tenant) -> bool:
        return tenant in self._quarantined

    def quarantined_tenants(self) -> list:
        return sorted(self._quarantined, key=repr)

    def last(self, tenant) -> Optional[dict]:
        rec = self._last.get(tenant)
        return dict(rec) if rec is not None else None

    def metrics(self) -> dict:
        """JSON-able ledger snapshot."""
        return {
            "config": {
                "holdout_every": self.config.holdout_every,
                "threshold": self.config.threshold,
                "mode": self.config.mode,
                "history_depth": self.config.history_depth,
                "auto_rollback_after": self.config.auto_rollback_after,
            },
            "accepted": self.accepted,
            "rejected": self.rejected,
            "quarantined": self.quarantined,
            "rollbacks": self.rollbacks,
            "auto_rollbacks": self.auto_rollbacks,
            "quarantined_tenants": self.quarantined_tenants(),
            "tenants": [[t, dict(rec)] for t, rec in self._last.items()],
        }

    # -- checkpoint plane ----------------------------------------------------

    def state(self) -> dict:
        """JSON-able state for a checkpoint manifest. Tenant-keyed maps go
        as lists of pairs so int tenant ids round-trip."""
        return {
            "last": [[t, dict(rec)] for t, rec in self._last.items()],
            "quarantined": list(self._quarantined),
            "gated_streaks": [[t, n] for t, n in self._consec_gated.items()],
            "counters": [
                self.accepted, self.rejected, self.quarantined, self.rollbacks,
                self.auto_rollbacks,
            ],
        }

    def load_state(self, state: dict) -> None:
        self._last = {t: dict(rec) for t, rec in state.get("last", [])}
        self._quarantined = set(state.get("quarantined", ()))
        self._consec_gated = {
            t: int(n) for t, n in state.get("gated_streaks", [])
        }
        # Pre-auto-rollback manifests stored 4 counters; pad the 5th.
        counters = list(state.get("counters", ())) + [0] * 5
        acc, rej, quar, rb, arb = counters[:5]
        self.accepted, self.rejected = int(acc), int(rej)
        self.quarantined, self.rollbacks = int(quar), int(rb)
        self.auto_rollbacks = int(arb)
