"""Radix-tree prefix index over the paged KV block pool.

A copy of ``repro.core.prefix_index`` (pure Python over ``KVBlockPool``'s
host accounting), importing the port's pool.

Maps ``(tenant, token-prefix)`` onto ordered KV pool block ids (SGLang's
radix-cache idea, at block granularity): one tree node per *block* of
tokens, keyed by that block's token tuple, scoped per tenant (a tenant's
system prompt never collides with another's, and dropping a tenant drops
its subtree). The scheduler:

  - ``match`` on admission — the longest indexed block-prefix of the
    prompt (capped so at least one tail token always remains: the tail
    prefill produces the next-token logits, so an exact-full-prompt hit
    still dispatches a 1-token tail);
  - ``acquire``/``release`` around a reusing row's lifetime (pool refs
    protect blocks from eviction while in flight);
  - ``insert`` after a dense admission — missing blocks allocate from
    the pool (evicting LRU unreferenced leaves under pressure) and the
    scheduler publishes the row's fresh K/V into them.

Invariants:

  - every node holds exactly ONE pool ref on its block for its lifetime;
    extra refs on the same block are in-flight admissions.
  - a node exists only if its parent does (paths are complete prefixes),
    so eviction removes leaves only — a freed parent would orphan the
    descendants' token paths.
  - eviction never touches a block with in-flight refs (refs > 1).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Optional

import numpy as np

from repro_torch.core.kv_pool import KVBlockPool, KVPoolExhausted


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_used")

    def __init__(self, key, block: int, parent: "_Node", last_used: int):
        self.key = key                      # token tuple of THIS block
        self.block = block                  # pool block id
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.last_used = last_used


class _Root:
    __slots__ = ("children",)

    def __init__(self):
        self.children: dict[tuple, _Node] = {}


class RadixPrefixIndex:
    def __init__(self, pool: KVBlockPool):
        self.pool = pool
        self.roots: dict[Any, _Root] = {}
        self._clock = 0
        self.counters: Counter = Counter()

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _chunks(self, tokens, n: int) -> list[tuple]:
        blk = self.pool.block
        t = np.asarray(tokens).reshape(-1)
        return [tuple(int(x) for x in t[i * blk:(i + 1) * blk])
                for i in range(n)]

    # -- queries -------------------------------------------------------------

    def match(self, tenant, tokens) -> list[int]:
        """Longest indexed block-prefix of ``tokens``: ordered pool block
        ids, capped at ``(len(tokens) - 1) // block`` so >= 1 tail token
        survives for the tail prefill. Bumps recency on the matched path."""
        n = np.asarray(tokens).reshape(-1).size
        cap = max(0, (n - 1) // self.pool.block)
        root = self.roots.get(tenant)
        if root is None or cap == 0:
            return []
        ids: list[int] = []
        node: Any = root
        for key in self._chunks(tokens, cap):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._tick()
            ids.append(child.block)
            node = child
        return ids

    def acquire(self, ids) -> tuple[int, np.ndarray]:
        """Pin matched blocks for an in-flight row: +1 pool ref each.
        Returns the release handle (pool generation + ids) — release via
        ``release`` when the row retires (stale handles after a pool
        reset no-op)."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        self.pool.ref(ids)
        return (self.pool.generation, ids)

    def release(self, handle: Optional[tuple]) -> None:
        if handle is None:
            return
        generation, ids = handle
        self.pool.deref(ids, generation=generation)

    # -- growth --------------------------------------------------------------

    def insert(self, tenant, tokens) -> list[tuple[int, int]]:
        """Index every full block of ``tokens``, allocating pool blocks for
        the missing suffix. Returns ``[(pool_id, slot)]`` for the NEWLY
        created nodes (slot = block index within the prompt) — the caller
        must publish those slots' K/V into the pool. Under pool pressure,
        evicts LRU unreferenced leaves; if allocation still fails the
        insert stops at the last indexable block (paths stay complete
        prefixes) and the tail simply isn't indexed."""
        n_full = np.asarray(tokens).reshape(-1).size // self.pool.block
        if n_full == 0:
            return []
        root = self.roots.setdefault(tenant, _Root())
        node: Any = root
        created: list[tuple[int, int]] = []
        for slot, key in enumerate(self._chunks(tokens, n_full)):
            child = node.children.get(key)
            if child is None:
                try:
                    bid = self.pool.alloc(1)[0]
                except KVPoolExhausted:
                    if self.evict(1) == 0 or not self.pool.free:
                        self.counters["insert_stopped"] += 1
                        break
                    bid = self.pool.alloc(1)[0]
                child = _Node(key, bid, node, self._tick())
                node.children[key] = child
                created.append((bid, slot))
                self.counters["nodes_created"] += 1
            else:
                child.last_used = self._tick()
            node = child
        return created

    # -- shrinkage -----------------------------------------------------------

    def _leaves(self) -> list[tuple[Any, _Node]]:
        out = []
        stack = [
            (tenant, node)
            for tenant, root in self.roots.items()
            for node in root.children.values()
        ]
        while stack:
            tenant, node = stack.pop()
            if node.children:
                stack.extend((tenant, c) for c in node.children.values())
            else:
                out.append((tenant, node))
        return out

    def evict(self, n: int) -> int:
        """Free up to ``n`` pool blocks by removing least-recently-used
        *unreferenced* leaves (refs == 1: only the index holds them).
        Removing a leaf can expose its parent — the loop re-ranks until
        ``n`` blocks came free or nothing is evictable."""
        freed = 0
        while freed < n:
            victims = [
                (t, nd) for t, nd in self._leaves()
                if self.pool.refs[nd.block] == 1
            ]
            if not victims:
                break
            _, victim = min(victims, key=lambda tn: tn[1].last_used)
            self._remove(victim)
            freed += 1
            self.counters["evicted"] += 1
        return freed

    def _remove(self, node: _Node) -> None:
        parent = node.parent
        del parent.children[node.key]
        self.pool.deref([node.block])

    def drop_tenant(self, tenant) -> int:
        """Forget a tenant's whole subtree (``SessionRuntime.release``
        hook). Blocks still pinned by in-flight rows stay allocated until
        those rows retire; the index's own refs drop now."""
        root = self.roots.pop(tenant, None)
        if root is None:
            return 0
        dropped = 0
        stack = list(root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.pool.deref([node.block])
            dropped += 1
        self.counters["dropped"] += dropped
        return dropped

    def reset(self) -> None:
        """Drop every scope and reset the pool (generation bump: handles
        held by in-flight rows become stale no-ops)."""
        self.roots.clear()
        self.pool.reset()

    def n_nodes(self) -> int:
        return sum(
            1 for _ in self._iter_nodes()
        )

    def _iter_nodes(self):
        for tenant, root in self.roots.items():
            stack = [(node, [node.key]) for node in root.children.values()]
            while stack:
                node, path = stack.pop()
                yield tenant, node, path
                stack.extend(
                    (c, path + [c.key]) for c in node.children.values()
                )

    # -- checkpoint ----------------------------------------------------------

    def state(self) -> list[dict]:
        """JSON-serialisable node list: tenant scope, full token path
        (flattened), block id, recency."""
        return [
            {
                "tenant": tenant,
                "tokens": [int(x) for key in path for x in key],
                "block": int(node.block),
                "used": int(node.last_used),
            }
            for tenant, node, path in self._iter_nodes()
        ]

    def load_state(self, entries: list[dict]) -> None:
        """Rebuild the tree from ``state()`` output and make the pool's
        accounting agree: exactly one ref per restored node (in-flight
        refs never survive a restore — there are no in-flight rows in a
        fresh session). Entries are sorted shortest-path-first so parents
        restore before children."""
        self.roots.clear()
        self.pool.refs[:] = 0
        self.pool.free = list(range(self.pool.n_blocks - 1, -1, -1))
        blk = self.pool.block
        for ent in sorted(entries, key=lambda e: len(e["tokens"])):
            tokens = ent["tokens"]
            if len(tokens) % blk:
                raise ValueError(
                    f"radix entry path length {len(tokens)} not a multiple "
                    f"of block {blk}"
                )
            root = self.roots.setdefault(ent["tenant"], _Root())
            node: Any = root
            n_full = len(tokens) // blk
            for slot, key in enumerate(self._chunks(tokens, n_full)):
                child = node.children.get(key)
                if child is None:
                    if slot != n_full - 1:
                        raise ValueError(
                            "radix entry restored before its parent: "
                            f"{ent!r}"
                        )
                    bid = int(ent["block"])
                    if self.pool.refs[bid] != 0:
                        raise ValueError(
                            f"radix restore: block {bid} claimed twice"
                        )
                    self.pool.refs[bid] = 1
                    self.pool.free.remove(bid)
                    child = _Node(key, bid, node, int(ent["used"]))
                    node.children[key] = child
                node = child
        self._clock = max(
            [int(e["used"]) for e in entries], default=self._clock
        )
