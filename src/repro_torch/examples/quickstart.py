"""Quickstart: the paper end-to-end at its native scale, on the port.

The twin of the reference's ``examples/quickstart.py``. It reproduces the
paper's storyline on a synthetic drifted dataset:
  1. pre-train a 3-layer DNN (256-96-96-3, BN+ReLU) on the pre-drift data;
  2. watch accuracy collapse on the drifted test set (Table 3 "Before");
  3. fine-tune with all eight methods (Table 4);
  4. time a train batch for each method and for the Skip2-LoRA cached fast
     path (Tables 6/7);
  5. time a cached epoch as the eager per-batch loop and as one CUDA-graph
     replay (the port's counterpart of the reference's one ``lax.scan``
     dispatch; on the CPU both are the eager loop).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import methods as M
from repro_torch.core import skip_cache as C
from repro_torch.core.finetune import (_cached_step, _populate_step, epoch_index_matrix, evaluate, finetune,
                                       make_skip2_epoch_fns)
from repro_torch.data.synthetic import make_drifted_dataset
from repro_torch.models.mlp import MLPConfig, accuracy, mlp_forward, pretrain


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    cfg = MLPConfig(in_dim=256, hidden_dim=96, out_dim=3, lora_rank=4)
    ds = make_drifted_dataset(torch.Generator().manual_seed(0), "damage1", device=dev)
    out: dict = {}

    print("=== 1. pre-train on the pre-drift distribution")
    bb = pretrain(torch.Generator().manual_seed(1), cfg, ds.x_pre, ds.y_pre, epochs=30, lr=0.05)
    with torch.no_grad():
        logits, _ = mlp_forward(bb, ds.x_pre, cfg)
        print(f"  pre-drift train accuracy : {accuracy(logits, ds.y_pre):.3f}")

        print("=== 2. data drift hits (Table 3 'Before')")
        logits, _ = mlp_forward(bb, ds.x_test, cfg)
        out["before"] = float(accuracy(logits, ds.y_test))
        print(f"  drifted test accuracy    : {out['before']:.3f}")

    print("=== 3. on-device fine-tuning, all eight methods (Table 4)")
    out["after"] = {}
    for method in M.METHODS:
        t0 = time.perf_counter()
        res = finetune(torch.Generator().manual_seed(2), method, cfg, bb, ds.x_ft, ds.y_ft,
                       epochs=40, batch_size=20, lr=0.05)
        acc = out["after"][method] = evaluate(method, cfg, res, ds.x_test, ds.y_test)
        print(f"  {method:12s} acc={acc:.3f}  wall={time.perf_counter() - t0:5.2f}s")

    print(f"=== 4. why Skip2-LoRA is fast: per-batch step time (Tables 6/7), {dev.type}")
    xb, yb = ds.x_ft[:20], ds.y_ft[:20]

    def timeit(f, n=100):
        f()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        _sync(dev)
        return (time.perf_counter() - t0) / n * 1e3

    trainable, frozen = M.init_method(torch.Generator().manual_seed(3), cfg, bb, "lora_all")
    t_lora_all = timeit(lambda: M.train_step("lora_all", cfg, trainable, frozen, xb, yb, 0.05))

    trainable, frozen = M.init_method(torch.Generator().manual_seed(3), cfg, bb, "skip2_lora")
    cache = C.cache_for_mlp(len(ds.x_ft), cfg.dims, device=dev)
    idx = torch.arange(20, device=dev)
    _populate_step(cfg)(trainable, frozen, cache, idx, xb, yb, 0.05)
    cached = _cached_step(cfg)
    t_cached = timeit(lambda: cached(trainable, cache, idx, xb, yb, 0.05))

    print(f"  LoRA-All train@batch      : {t_lora_all:.3f} ms")
    print(f"  Skip2-LoRA cached@batch   : {t_cached:.3f} ms")
    print(f"  reduction                 : {100 * (1 - t_cached / t_lora_all):.1f}% (paper: ~90%)")

    print("=== 5. one dispatch an epoch: the eager per-batch loop against one graph replay")
    # At paper scale the per-batch step costs kernel launches, not arithmetic;
    # a CUDA graph of the whole epoch issues it in one launch.
    trainable, frozen = M.init_method(torch.Generator().manual_seed(3), cfg, bb, "skip2_lora")
    cache = C.cache_for_mlp(len(ds.x_ft), cfg.dims, device=dev)
    idx_mat = epoch_index_matrix(torch.Generator().manual_seed(5), len(ds.x_ft), 20, device=dev)
    populate_epoch, cached_epoch = make_skip2_epoch_fns(cfg)
    _, cached_loop = make_skip2_epoch_fns(cfg, loop=True)
    trainable, cache, _ = populate_epoch(trainable, frozen, cache, ds.x_ft, ds.y_ft, idx_mat, 0.05)
    steps = int(idx_mat.shape[0])
    t_loop = timeit(lambda: cached_loop(trainable, cache, ds.x_ft, ds.y_ft, idx_mat, 0.05), n=20)
    t_graph = timeit(lambda: cached_epoch(trainable, cache, ds.x_ft, ds.y_ft, idx_mat, 0.05), n=20)
    how = "1 CUDA-graph replay" if dev.type == "cuda" else "eager (no graphs on the CPU)"
    print(f"  cached epoch, {steps} per-batch steps : {t_loop:.3f} ms")
    print(f"  cached epoch, {how:22s}: {t_graph:.3f} ms")
    print(f"  dispatch amortisation              : {t_loop / t_graph:.1f}x")
    out.update(lora_all_ms=t_lora_all, cached_ms=t_cached, loop_epoch_ms=t_loop, graph_epoch_ms=t_graph)
    return out


if __name__ == "__main__":
    main()
