"""Measured tuning of the grouped Skip-LoRA kernels' knobs on the card.

The counterpart of ``repro.kernels.autotune``. The CUDA kernels' knobs are
not the TPU's: the row tile ``tm`` (1 to ``kernel.TM_MAX`` rows; untuned
``ops.TM`` = 16), which sets the grouping plan's padding (``m_pad =
ceil(m / tm) tm + min(n, m) tm``), and the block geometry of the
tensor-core route (``"few_rows"`` or ``"many_rows"``, or ``"rule"``:
``kernel.grouped_fwd_geometry``'s pick from M and M_pad alone).

  - ``tune_grouped`` sweeps (tm, geometry) for one kernel variant (K5
    ``grouped``, K6 ``grouped_int8``, K7 ``grouped_int4`` / ``grouped_nf4``)
    at one batch shape, timing the launch with its plan built beforehand,
    as a decode call reuses one plan for every step (median of repeats,
    CUDA events), and records the roofline prediction
    (``launch.roofline.PEAK_FLOPS`` / ``HBM_BW``) next to each measurement.
    The untuned default (``ops.TM``, ``"rule"``) is always a candidate, so
    the winner is never slower than it by construction: the argmin runs
    over a set containing it.
  - ``tune_decode_unroll`` sweeps the decode's ``unroll``: the reference
    times a ``lax.scan`` of ``steps`` grouped dispatches; the card's form is
    one CUDA-graph replay of ``unroll`` dispatches, ``steps / unroll`` times
    (``core.cuda_graph``, the tool ``core.decode_graph`` captures with). On
    the CPU it is the eager loop.
  - ``tune_kv_block`` sweeps the paged-KV block size over one ``publish``
    plus one ``gather_blocks`` (K10 on the card).
  - ``AutotuneCache`` persists winners in a deterministic JSON file keyed on
    ``config_key|device_kind|variant``, the reference's schema: the same
    config and device kind always resolve to the same choice, and a warm
    cache times nothing.
  - ``apply_choice`` installs a winner as the process-wide default
    (``ops.set_default_tile``) and ``apply_kv_block`` a block size
    (``kv_pool.set_default_block``). Resolution happens when a plan is built
    (the tile) and a kernel launched (the geometry): a CUDA graph captured
    before the call keeps what it was captured with.

``Choice.grid_order`` carries the geometry (``"rule"``, ``"few_rows"``,
``"many_rows"``), as ``Choice.tm`` carries the KV block in
``tune_kv_block``'s entries: one schema for every tuned knob.

The tuners run on the tensors they are given. On CUDA tensors every timed
call launches the kernel (or raises); on CPU tensors the wrappers run their
plain versions, which ignore the tile and geometry (``device_kind``
"cpu-plain"), so a CPU sweep exercises the machinery, not the knobs.

Usage:
    PYTHONPATH=src python -m repro_torch.kernels.autotune --device cpu --quick
    PYTHONPATH=src python -m repro_torch.kernels.autotune --cache build/at.json   # on the card
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch

from repro_torch.kernels.skip_lora import kernel as K
from repro_torch.kernels.skip_lora import ops as O
from repro_torch.kernels.skip_lora import quant as Q
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

#: Smallest row tile per route (``kernel.grouped_fwd_route``). Both take one
#: row: ``kernel._check_plan`` allows 1..TM_MAX, and the tensor-core route's
#: ``block_span`` (``csrc/skip_sum_tc.cuh``) covers any tile, a block taking
#: up to 16 positions of one tile (ceil(tm / 16) blocks a tile) in the
#: few-row geometry and any consecutive positions in the many-row one.
_MIN_TILE = {"tensor_cores": 1, "cuda_cores": 1}

GEOMETRIES = O.GEOMETRIES
UNROLL_CANDIDATES = (1, 2, 4)
#: KV block sizes swept by ``tune_kv_block`` (tokens per paged block).
#: Smaller blocks match longer prefixes (match granularity is the block);
#: larger blocks amortise gather/publish dispatch overhead.
KV_BLOCK_CANDIDATES = (4, 8, 16)
#: the variants ``tune_grouped`` sweeps
VARIANTS = ("grouped", "grouped_int8", "grouped_int4", "grouped_nf4")
#: GPU cycles the timer holds the stream for before each timed call (~1 ms),
#: longer than the host's enqueue of one call, so host time does not count
SPIN_CYCLES = 2_000_000


def tile_candidates(m: int, dtype=torch.float32, *, max_tile: int = K.TM_MAX) -> tuple[int, ...]:
    """Valid row tiles for a batch of ``m`` rows of ``dtype``: powers of two
    from the route's floor up to ``max_tile``, the untuned ``ops.TM`` always
    included. Tiles far above the row count only add padding, so the sweep
    stops one doubling past ``m`` once ``TM`` is reached."""
    lo = _MIN_TILE[K.grouped_fwd_route(dtype)]
    out = []
    t = lo
    while t <= max_tile:
        out.append(t)
        if t >= 2 * m and t >= O.TM:
            break
        t *= 2
    if O.TM not in out:
        out.append(O.TM)
    return tuple(sorted(set(out)))


def config_key(cfg, rank: int) -> str:
    """Stable identity of the model shape the kernels serve: everything the
    grouped dispatch geometry depends on."""
    name = getattr(cfg, "name", "anon")
    return f"{name}-d{cfg.d_model}-L{cfg.n_layers}-r{rank}"


def device_kind(where=None) -> str:
    """Hardware identity for the cache key of work on ``where`` (a tensor or
    a device; None: the current CUDA device if there is one): the card's
    name with spaces replaced, or ``"cpu-plain"`` on the CPU (the plain
    versions, whose cost surface has nothing to do with the kernels')."""
    if where is None:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    else:
        dev = where.device if isinstance(where, torch.Tensor) else torch.device(where)
    if dev.type != "cuda":
        return "cpu-plain"
    return torch.cuda.get_device_name(dev).replace(" ", "_")


@dataclasses.dataclass(frozen=True)
class Choice:
    """One tuned parameter set + the evidence that chose it."""

    tm: int
    grid_order: str               # the geometry: "rule" | "few_rows" | "many_rows" ("na": a KV block)
    unroll: int = 1
    time_s: float = 0.0           # measured median for the winner
    default_time_s: float = 0.0   # measured median for (ops.TM, "rule")
    predicted_s: float = 0.0      # roofline prediction for the winner
    source: str = "measured"      # "measured" | "cache" | "default"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Choice":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d})


class AutotuneCache:
    """Deterministic JSON store of tuned choices.

    Entries are keyed ``config_key|device_kind|variant``; the file is written
    with sorted keys so identical tuning runs produce byte-identical caches,
    through a temporary file and an atomic replace. ``hits``/``misses``
    count lookups since construction."""

    VERSION = 1

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        if path and os.path.exists(path):
            with open(path) as f:
                blob = json.load(f)
            if blob.get("version") == self.VERSION:
                self.entries = blob.get("entries", {})

    @staticmethod
    def key(config: str, device: str, variant: str) -> str:
        return f"{config}|{device}|{variant}"

    def get(self, config: str, device: str, variant: str) -> Optional[Choice]:
        entry = self.entries.get(self.key(config, device, variant))
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        return Choice.from_dict({**entry, "source": "cache"})

    def put(self, config: str, device: str, variant: str, choice: Choice) -> None:
        self.entries[self.key(config, device, variant)] = choice.as_dict()
        if self.path:
            self.save(self.path)

    def save(self, path: str) -> None:
        blob = {"version": self.VERSION, "entries": self.entries}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Measurement + prediction
# ---------------------------------------------------------------------------


def median_timer(iters: int = 3, warmup: int = 1) -> Callable:
    """Default timer: the median of ``iters`` post-warm-up calls of ``fn``,
    in seconds. A call that returns a CUDA tensor is timed with CUDA events
    around it, after ``torch.cuda.synchronize()`` and with the stream held
    by a spin kernel while the host enqueues it, so only device time counts
    (work that waits for the stream, as a pageable host-to-device copy
    does, exposes its host time); any other with the host clock. Tests
    inject a deterministic fake with the same signature."""

    def timer(fn: Callable[[], object]) -> float:
        out = None
        for _ in range(max(warmup, 1)):
            out = fn()
        times = []
        if isinstance(out, torch.Tensor) and out.is_cuda:
            torch.cuda.synchronize()
            for _ in range(iters):
                torch.cuda._sleep(SPIN_CYCLES)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
        else:
            for _ in range(iters):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
        return statistics.median(times)

    return timer


def predict_grouped_time(
    m: int, d: int, r: int, lnum: int, n_groups: int, tm: int,
    bytes_per_elt: int = 4,
) -> float:
    """Roofline estimate for one grouped dispatch at tile ``tm``, the
    reference's formula over the card's peaks.

    FLOPs: two (tm, d) x (d, r) / (tm, r) x (r, d) dots per (row-tile,
    layer) step over the PADDED row count -- padding is real work. Bytes: per
    step, the x tile in, the out tile read+written (layer accumulation), and
    one (d, r) + (r, d) adapter block gathered. The max of the two terms
    over the peak rates is the modelled time."""
    m_pad = (m + tm - 1) // tm * tm + min(n_groups, m) * tm
    steps = (m_pad // tm) * lnum
    flops = 4.0 * m_pad * d * r * lnum
    tile_bytes = tm * d * bytes_per_elt
    pool_bytes = 2 * d * r * bytes_per_elt
    bytes_moved = steps * (3 * tile_bytes + pool_bytes)
    return max(flops / PEAK_FLOPS, bytes_moved / HBM_BW)


def _variant_dispatch(variant: str):
    """variant -> (``build``, ``prepare``). ``build`` turns a float
    (a_pool, b_pool) pair into the variant's payload; ``prepare(x, pools,
    idx, tm, geometry)`` builds the grouping plan at ``tm`` (on the card) and
    returns the call that runs one grouped forward over rows x (L, M, D) at
    (tm, geometry) through the port's wrapper -> (M, D)."""
    if variant == "grouped":
        wrapper = O.skip_lora_grouped

        def build(a_pool, b_pool):
            return (a_pool, b_pool)

    elif variant == "grouped_int8":
        from repro_torch.core.lm_skiplora import quantize_int8

        wrapper = O.skip_lora_grouped_int8

        def build(a_pool, b_pool):
            qa, sa = quantize_int8(a_pool)
            qb, sb = quantize_int8(b_pool)
            return (qa, sa, qb, sb)

    elif variant in ("grouped_int4", "grouped_nf4"):
        kind = variant.split("_")[1]
        wrapper = O.skip_lora_grouped_q4

        def build(a_pool, b_pool):
            qa, sa = Q.quantize_q4(a_pool, kind)
            qb, sb = Q.quantize_q4(b_pool, kind)
            return (qa, sa, qb, sb, Q.codebook(kind, device=a_pool.device))

    else:
        raise ValueError(f"unknown kernel variant {variant!r}; options: {VARIANTS}")

    def prepare(x, pools, idx, tm, geometry):
        acts = x[:, :, None]
        plan = O.grouped_plan(idx, pools[0].shape[0], tm=tm) if x.is_cuda else None

        def run():
            return wrapper(acts, *pools, idx, tm=tm, geometry=geometry, plan=plan)[:, 0]

        return run

    return build, prepare


def tune_grouped(
    x: torch.Tensor,
    a_pool: torch.Tensor,
    b_pool: torch.Tensor,
    idx: torch.Tensor,
    variant: str = "grouped",
    *,
    config: str,
    cache: Optional[AutotuneCache] = None,
    device: Optional[str] = None,
    tiles: Optional[Sequence[int]] = None,
    geometries: Sequence[str] = GEOMETRIES,
    timer: Optional[Callable] = None,
    record: Optional[list] = None,
) -> Choice:
    """Pick (tm, geometry) for one variant at one batch shape.

    x: (L, M, D) rows; pools (N, L, D, R) / (N, L, R, D) float -- ``build``
    quantises them for the int8 and 4-bit variants; idx: (M,) slot per row.
    Every candidate is timed on the real launch; the untuned default
    (``ops.TM``, ``"rule"``) is always a candidate, so the winner is <= the
    default by construction. A cache hit returns without timing anything.
    ``record``, when given, receives one (tm, geometry, time_s, predicted_s,
    output) tuple per candidate, in sweep order, for a caller that holds
    the candidates' outputs against each other."""
    device = device or device_kind(x)
    if cache is not None:
        hit = cache.get(config, device, variant)
        if hit is not None:
            return hit
    timer = timer or median_timer()
    build, prepare = _variant_dispatch(variant)
    pools = build(a_pool, b_pool)
    lnum, m, d = x.shape
    n, r = a_pool.shape[0], a_pool.shape[-1]
    g = int(min(n, m))
    tiles = tuple(tiles) if tiles is not None else tile_candidates(m, x.dtype)
    cands = [(tm, geo) for tm in tiles for geo in geometries]
    if (O.TM, "rule") not in cands:
        cands.append((O.TM, "rule"))

    results = []  # (time_s, predicted_s, tm, geometry); tuple order breaks ties
    for tm, geo in cands:
        run = prepare(x, pools, idx, tm, geo)
        if record is not None:
            out = run()
        t = timer(run)
        p = predict_grouped_time(m, d, r, lnum, g, tm, x.element_size())
        results.append((t, p, tm, geo))
        if record is not None:
            record.append((tm, geo, t, p, out))
    default_t = min(t for t, _, tm, geo in results if tm == O.TM and geo == "rule")
    best_t, best_p, best_tm, best_geo = min(results)
    choice = Choice(
        tm=best_tm, grid_order=best_geo, time_s=best_t,
        default_time_s=default_t, predicted_s=best_p,
    )
    if cache is not None:
        cache.put(config, device, variant, choice)
    return choice


class _UnrollGraphs:
    """CUDA graphs of ``n`` grouped dispatches each over static rows, pools
    and plan; ``run(steps, unroll)`` replays ``steps // unroll`` graphs of
    ``unroll`` dispatches and one of the remainder."""

    def __init__(self, run: Callable[[], torch.Tensor], out: torch.Tensor):
        self.run, self.out, self.graphs = run, out, {}

    def _body(self, n: int) -> None:
        for _ in range(n):
            self.out.copy_(self.run())

    def graph(self, n: int):
        from repro_torch.core.cuda_graph import capture, on_side_stream

        g = self.graphs.get(n)
        if g is None:
            on_side_stream(lambda: self._body(1), self.out.device)
            g = torch.cuda.CUDAGraph()
            capture(g, lambda: self._body(n), what=f"{n} grouped dispatch(es) of the unroll sweep")
            self.graphs[n] = g
        return g

    def replays(self, steps: int, unroll: int) -> Callable[[], torch.Tensor]:
        full, rest = divmod(steps, unroll)
        graphs = [self.graph(unroll)] * full + ([self.graph(rest)] if rest else [])

        def replay():
            for g in graphs:
                g.replay()
            return self.out

        return replay

    def free(self) -> None:
        for g in self.graphs.values():
            g.reset()
        self.graphs.clear()


def tune_decode_unroll(
    x: torch.Tensor,
    a_pool: torch.Tensor,
    b_pool: torch.Tensor,
    idx: torch.Tensor,
    *,
    tm: int,
    grid_order: str,
    steps: int = 16,
    candidates: Sequence[int] = UNROLL_CANDIDATES,
    timer: Optional[Callable] = None,
) -> tuple[int, float]:
    """Pick the decode's ``unroll`` by timing ``steps`` grouped dispatches
    at decode shape (float pool, at ``tm`` and the geometry ``grid_order``):
    on the card, ``steps / unroll`` replays of a CUDA graph of ``unroll``
    dispatches (and one of the remainder when ``unroll`` does not divide
    ``steps``) -- the structure ``lm.decode_scan`` replays, minus the
    backbone; on the CPU, the eager loop of ``steps`` dispatches. Returns
    (unroll, time_s)."""
    timer = timer or median_timer()
    _, prepare = _variant_dispatch("grouped")
    run = prepare(x, (a_pool, b_pool), idx, tm, grid_order)
    results = []
    if x.is_cuda:
        graphs = _UnrollGraphs(run, torch.empty((x.shape[1], x.shape[2]), dtype=x.dtype, device=x.device))
        try:
            for u in candidates:
                results.append((timer(graphs.replays(steps, u)), u))
        finally:
            graphs.free()
    else:
        def loop():
            for _ in range(steps):
                out = run()
            return out

        for u in candidates:
            results.append((timer(loop), u))
    best_t, best_u = min(results)
    return best_u, best_t


def apply_choice(choice: Choice) -> None:
    """Install a tuned winner as the process-wide kernel default. Resolved
    when a plan is built and a kernel launched: call before warm-up and
    graph capture, not under live traffic."""
    O.set_default_tile(tm=choice.tm, geometry=choice.grid_order)


def tune_kv_block(
    cfg,
    *,
    config: str,
    seq: int = 64,
    batch: int = 4,
    candidates: Sequence[int] = KV_BLOCK_CANDIDATES,
    cache: Optional[AutotuneCache] = None,
    device: Optional[str] = None,
    timer: Optional[Callable] = None,
    on: str = "cuda",
) -> Choice:
    """Pick the paged-KV block size by timing the pool round trip the
    scheduler's prefix reuse dispatches: one ``publish`` (a live row -> pool
    blocks) plus one ``gather_blocks`` (block tables -> admission layout)
    with ``use_kernel=True``, so it times K10 on the card, the gather the
    scheduler launches (the reference's tuner times its oracle, the
    default), over a ``seq``-token prompt for ``batch`` rows, on the
    torch device ``on``. The live row comes from ``lm.init_stacked_caches``,
    the stacked layout the port's ``publish`` reads.

    The winner rides the shared ``Choice``/``AutotuneCache`` machinery with
    the block size in the ``tm`` field (one schema for every tuned knob);
    ``apply_kv_block`` installs it via ``kv_pool.set_default_block``. The
    untuned ``DEFAULT_BLOCK`` is always a candidate, so tuned is never
    worse than untuned by construction."""
    from repro_torch.core import kv_pool as KV
    from repro_torch.models.lm import init_stacked_caches

    dev = torch.device(on)
    device = device or device_kind(dev)
    if cache is not None:
        hit = cache.get(config, device, "kv_block")
        if hit is not None:
            return hit
    timer = timer or median_timer()

    blocks = sorted(set(
        b for b in (*candidates, KV.DEFAULT_BLOCK) if seq % b == 0
    ))
    caches = init_stacked_caches(cfg, 1, seq, device=dev)
    results = []  # (time_s, block)
    for blk in blocks:
        per_row = seq // blk
        pool = KV.KVBlockPool(cfg, n_blocks=batch * per_row, block=blk, device=dev)
        ids = pool.alloc(per_row)
        slots = list(range(per_row))
        tables = torch.tensor(ids, dtype=torch.int32, device=dev)[None].repeat(batch, 1)

        def run(pool=pool, ids=ids, slots=slots, tables=tables):
            pool.publish(caches, 0, ids, slots)
            return KV.gather_blocks(pool.data, tables, use_kernel=True)["k"]

        results.append((timer(run), blk))
    default_t = min(t for t, blk in results if blk == KV.DEFAULT_BLOCK)
    best_t, best_blk = min(results)
    choice = Choice(
        tm=best_blk, grid_order="na", time_s=best_t, default_time_s=default_t,
    )
    if cache is not None:
        cache.put(config, device, "kv_block", choice)
    return choice


def apply_kv_block(choice: Choice) -> None:
    """Install a tuned KV block size as the process-wide pool default
    (``tm`` carries the block; see ``tune_kv_block``). Applies to pools
    built AFTER the call -- existing pools keep their geometry."""
    from repro_torch.core import kv_pool as KV

    KV.set_default_block(choice.tm)


# ---------------------------------------------------------------------------
# CLI smoke: a tiny sweep twice, the second all cache hits with the same
# choice.
# ---------------------------------------------------------------------------


def _smoke_inputs(device: str, m: int = 8, d: int = 32, r: int = 4, lnum: int = 2, n: int = 4):
    """Rows (bf16 on the card, the tensor-core route; fp32 on the CPU),
    fp32 pools and slots, from a seeded generator."""
    g = torch.Generator(device=device).manual_seed(0)
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    x = torch.randn((lnum, m, d), generator=g, device=device).to(dtype)
    a_pool = torch.randn((n, lnum, d, r), generator=g, device=device) * 0.1
    b_pool = torch.randn((n, lnum, r, d), generator=g, device=device) * 0.1
    idx = torch.arange(m, dtype=torch.int32, device=device) % n
    return x, a_pool, b_pool, idx


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache", default=os.path.join(tempfile.gettempdir(), "skiplora_autotune_torch.json"))
    ap.add_argument("--quick", action="store_true", help="tiny sweep (smoke)")
    ap.add_argument("--variant", default="grouped", choices=VARIANTS, help="kernel variant to tune")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    x, a_pool, b_pool, idx = _smoke_inputs(args.device)
    tiles = (4, O.TM) if args.quick else None
    timer = median_timer(iters=2, warmup=1) if args.quick else None
    if os.path.exists(args.cache):
        os.unlink(args.cache)

    cache = AutotuneCache(args.cache)
    first = tune_grouped(
        x, a_pool, b_pool, idx, args.variant,
        config="smoke", cache=cache, tiles=tiles, timer=timer,
    )
    assert cache.misses == 1 and cache.hits == 0, (cache.hits, cache.misses)

    cache2 = AutotuneCache(args.cache)  # re-read from disk: warm
    second = tune_grouped(
        x, a_pool, b_pool, idx, args.variant,
        config="smoke", cache=cache2, tiles=tiles, timer=timer,
    )
    assert cache2.hits == 1 and cache2.misses == 0, (cache2.hits, cache2.misses)
    assert (second.tm, second.grid_order) == (first.tm, first.grid_order)
    assert second.source == "cache"
    print(
        f"autotune smoke OK ({args.variant}, {device_kind(x)}): tm={first.tm} geometry={first.grid_order} "
        f"t={first.time_s * 1e3:.3f}ms (default {first.default_time_s * 1e3:.3f}ms), "
        f"warm run hit cache"
    )


if __name__ == "__main__":
    main()
