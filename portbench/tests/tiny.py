"""A cell of the benchmark cut to a size the CPU runs in seconds: the same
files, the widths and counts of its configuration and traffic shrunk."""

from __future__ import annotations

import json

from portbench import harness as H


def tiny_config(name: str, dtype: str | None = None) -> dict:
    c = H.read_json(H.HERE / "configs" / f"{name}.json")
    c.update(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, vocab_size=2048)
    if dtype:
        c["dtype"] = dtype
    if c.get("moe"):
        c["moe"] = dict(c["moe"], n_experts=8, top_k=2, d_ff_expert=128, shared_d_ff=512)
    else:
        c["d_ff"] = 512
    return c


def tiny_traffic(name: str) -> dict:
    tr = H.read_json(H.HERE / "traffic" / f"{name}.json")
    if tr["driver"] == "train":
        tr.update(tenants=4, samples_per_tenant=8, seq=16, rank=8, ingest_rows=4)
        tr["job"] = dict(tr["job"], batch_per_tenant=2)
        tr["check"] = {"tenants": min(tr["check"]["tenants"], 2)}
    else:
        tr.update(clients=6, tenants=2, shared_prefix=min(tr["shared_prefix"], 16),
                  prompt={"mean": 8, "std": 4, "lo": 4}, new_tokens={"mean": 12, "std": 4, "lo": 8})
        tr["scheduler"] = dict(tr["scheduler"], max_batch=4, admit_bucket=2, max_prompt=28, max_new_cap=16,
                               kv_block=8, inflight_per_tenant=4)
        tr["check"] = {"requests": 6}
    return tr


#: paths of the drivers that no cell takes yet, as changes of a cell's
#: traffic: a fine-tuning service's jobs (release, ingest a new tenant,
#: adapt it), and clients sharing a per-tenant system prompt (prefix reuse)
VARIANTS = {
    "jobs": ("stablelm-adapt", None, {"job": {"new_tenant": True, "adapt_calls": 2, "epochs": 1,
                                              "batch_per_tenant": 2}, "check": {"tenants": 1}}),
    "prefix": ("qwen2moe-sched", "stablelm-1.6b", {"shared_prefix": 16, "base_rank": None}),
}


def tiny_cell(workload: str, dtype: str | None = None) -> H.Cell:
    """A cell of ``BENCHMARK.json``, or a name of ``VARIANTS``, cut small."""
    base, config, change = VARIANTS.get(workload, (workload, None, {}))
    full = H.load_cell(base)
    cfg = tiny_config(config or full.workload["config"], dtype)
    tr = tiny_traffic(full.workload["traffic"])
    tr.update(change)
    if dtype == "float32" and "cache_dtype" in tr:
        tr["cache_dtype"] = "float32"                        # a float32 model caches float32 rows
    return H.Cell(full.workload, cfg, tr, full.limits, full.per_layer, full.end_to_end)


def dumps(obj) -> str:
    return json.dumps(obj, default=str)
