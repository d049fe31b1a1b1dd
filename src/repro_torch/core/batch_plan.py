"""Epoch batch planning, a copy of ``repro.core.batch_plan`` (numpy only).

One planner for every trainer: visit a permutation in batches and decide
what to do with a non-dividing tail (``index_matrix``):

  - ``tail="wrap"``: the last batch wraps around to the front of the
    permutation, so every row is visited at least once and every batch is
    full (the populate-safe choice: a dropped remainder would leave cache
    rows unpopulated);
  - ``tail="mask"``: the tail is padded with wrapped ids and a boolean
    validity mask flags the padding, so every row is visited exactly once.

``fleet_index_matrix`` plans a tenant-contiguous fleet epoch (one RNG stream
per tenant, so a tenant sees the order it would see training alone),
``shadow_split`` / ``fleet_eval_index`` the deterministic held-out split of
shadow eval, and ``plan_admissions`` a scheduler's admission wave.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.data.pipeline import epoch_permutation


def index_matrix(
    perm, batch_size: int, *, tail: str = "wrap"
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Batch a visitation order. ``perm``: (n,) row ids (any integer dtype).

    ``tail="wrap"`` -> (steps, batch) ids;
    ``tail="mask"`` -> ((steps, batch) ids, (steps, batch) bool validity).
    ``batch_size`` is clamped to n; steps = ceil(n / batch).
    """
    if tail not in ("wrap", "mask"):
        raise ValueError(f"unknown tail semantics {tail!r}")
    perm = np.asarray(perm)
    n = perm.shape[0]
    if n == 0:
        raise ValueError("empty permutation")
    bs = min(batch_size, n)
    steps = -(-n // bs)  # ceil
    pad = steps * bs - n
    ids = np.concatenate([perm, perm[:pad]]) if pad else perm
    ids = ids.reshape(steps, bs)
    if tail == "wrap":
        return ids
    valid = np.ones(steps * bs, bool)
    if pad:
        valid[n:] = False
    return ids, valid.reshape(steps, bs)


def shadow_split(
    n_rows: int, *, every: Optional[int]
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic held-out split of a tenant's ingested rows: local row
    ``r`` is held out iff ``(r + 1) % every == 0`` (every ``every``-th row).

    The rule is a pure function of the row id — no RNG — which gives the
    control plane (DESIGN.md §13) the two properties shadow eval needs:

      - *stable under append*: ingesting more rows never reassigns an
        existing row between the train and eval sides, so a tenant's eval
        set only ever grows, and a restored session splits identically;
      - *trainer-visible*: the train side is exactly the complement, so the
        epoch planner can permute train rows only (``holdout_every`` below)
        while eval rows stay untouched by any optimizer step.

    Row 0 is always a train row (``every >= 2`` enforced), so a tenant with
    any data can always train; tenants with ``n_rows < every`` simply have
    an empty eval set (the regression gate stays inactive for them).
    Returns (train_ids, eval_ids), both sorted ascending.
    """
    ids = np.arange(n_rows)
    if every is None:
        return ids, np.empty(0, dtype=ids.dtype)
    if every < 2:
        raise ValueError(f"holdout every {every} < 2 leaves no train rows")
    hold = (ids + 1) % every == 0
    return ids[~hold], ids[hold]


def fleet_eval_index(
    n_tenants: int,
    samples_per_tenant: int,
    *,
    holdout_every: int,
    partitions: Optional[Sequence[int]] = None,
    partition_stride: Optional[int] = None,
) -> np.ndarray:
    """(N * n_eval,) global sample ids of every tenant's held-out rows,
    tenant-contiguous in fleet order (the layout ``per_tenant_loss``
    reduces over). Deterministic — the eval visitation is the identity
    order of ``shadow_split``'s eval side, no RNG stream — so pre- and
    post-adapt eval read the identical rows. Partition/stride semantics
    match ``fleet_index_matrix``."""
    stride = (
        partition_stride if partition_stride is not None else samples_per_tenant
    )
    parts = list(partitions) if partitions is not None else list(range(n_tenants))
    if len(parts) != n_tenants:
        raise ValueError(f"{len(parts)} partitions for {n_tenants} tenants")
    _, eval_ids = shadow_split(samples_per_tenant, every=holdout_every)
    if eval_ids.size == 0:
        raise ValueError(
            f"no held-out rows: {samples_per_tenant} rows at "
            f"holdout_every={holdout_every}"
        )
    return np.concatenate([part * stride + eval_ids for part in parts])


def fleet_index_matrix(
    epoch: int,
    n_tenants: int,
    samples_per_tenant: int,
    batch_per_tenant: int,
    *,
    seed: int = 0,
    partitions: Optional[Sequence[int]] = None,
    partition_stride: Optional[int] = None,
    streams: Optional[Sequence[int]] = None,
    tail: str = "wrap",
    holdout_every: Optional[int] = None,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """(steps, N * bpt) global sample ids of a tenant-contiguous fleet epoch.

    Column block g belongs to the tenant in fleet position g, who owns cache
    partition ``partitions[g]`` (default: position g owns partition g, the
    offline ``fleet_finetune`` convention). Each tenant has its own RNG
    stream (``seed + streams[g]``, default ``streams = partitions``), so a
    tenant sees the same visitation order it would training alone regardless
    of who else is in the fleet — the session runtime relies on this when an
    ``adapt`` group is a subset (or reordering) of the ingested tenants.
    Sharded sessions split stream from partition: the stream follows the
    tenant's *global* partition id (so a re-sharded session replays the same
    orders) while ``partitions`` offsets into the shard-local id space.

    ``samples_per_tenant`` is the *visited fill* (the rows each tenant has
    actually ingested this epoch); ``partition_stride`` is the *allocated*
    partition width in the global id space (default: equal to the fill, the
    offline trainer's fully-packed layout). The runtime passes its fixed
    allocation stride so partially-filled partitions still address their
    own rows. Tail semantics per ``index_matrix``; ``tail="mask"``
    additionally returns the stacked validity mask.

    ``holdout_every`` activates the shadow split (``shadow_split``): each
    tenant's epoch permutes its *train* rows only — every ``holdout_every``-
    th ingested row is reserved for held-out eval and never appears in a
    training batch. ``None`` (the default) is bitwise the historical plan.
    """
    stride = partition_stride if partition_stride is not None else samples_per_tenant
    if stride < samples_per_tenant:
        raise ValueError(
            f"partition stride {stride} < fill {samples_per_tenant}"
        )
    parts = list(partitions) if partitions is not None else list(range(n_tenants))
    if len(parts) != n_tenants:
        raise ValueError(f"{len(parts)} partitions for {n_tenants} tenants")
    strm = list(streams) if streams is not None else parts
    if len(strm) != n_tenants:
        raise ValueError(f"{len(strm)} streams for {n_tenants} tenants")
    train_rows, _ = shadow_split(samples_per_tenant, every=holdout_every)
    if train_rows.size == 0:
        raise ValueError("shadow split left no train rows")
    cols, masks = [], []
    for part, stream in zip(parts, strm):
        # The permutation is drawn over the train count and mapped through
        # the (sorted) train ids, so the holdout-free plan (train_rows ==
        # arange(n)) is bitwise the historical one.
        perm = train_rows[
            epoch_permutation(seed + stream, epoch, train_rows.size)
        ]
        planned = index_matrix(perm, batch_per_tenant, tail=tail)
        if tail == "mask":
            planned, valid = planned
            masks.append(valid)
        cols.append(part * stride + planned)
    ids = np.concatenate(cols, axis=1)
    if tail == "mask":
        return ids, np.concatenate(masks, axis=1)
    return ids


def plan_admissions(
    pending: Sequence,
    in_flight,
    free_rows: int,
    *,
    cap: int,
    bucket: int,
) -> list[int]:
    """Pick which queued requests the scheduler admits into the live batch.

    ``pending`` is the arrival-ordered queue, each element exposing a
    ``tenant`` attribute; ``in_flight`` maps tenant -> rows it currently
    occupies; ``free_rows`` is how many batch rows are open; ``cap`` bounds
    a single tenant's total rows (in-flight + admitted now); ``bucket`` is
    the admission width of one dispatch. Returns indices into ``pending``
    in arrival order.

    The walk is a single pass over the global FIFO that *skips* (rather
    than waits on) requests whose tenant is at cap, which yields exactly
    the ISSUE's fairness contract: FIFO within each tenant (a tenant's own
    requests are only ever admitted in arrival order), a hard per-tenant
    occupancy bound, and no head-of-line blocking — one chatty tenant at
    cap cannot stall the tenants queued behind it.
    """
    if cap < 1:
        raise ValueError(f"per-tenant in-flight cap {cap} < 1")
    budget = min(free_rows, bucket)
    counts = dict(in_flight)
    admitted: list[int] = []
    for i, req in enumerate(pending):
        if len(admitted) >= budget:
            break
        c = counts.get(req.tenant, 0)
        if c >= cap:
            continue
        counts[req.tenant] = c + 1
        admitted.append(i)
    return admitted
