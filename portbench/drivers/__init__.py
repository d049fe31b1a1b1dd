"""Drivers: one general loop per kind of traffic, its parameters read from
the traffic file (``traffic/<name>.json``, key ``driver``)."""

import gc


def free_program() -> None:
    """Drop the program's global graph caches and return freed memory to
    the card, so that the reference runs with the program's state gone."""
    import torch
    from repro_torch.core import decode_graph, lm_skiplora, prefill_graph

    for cache in (decode_graph.GRAPHS, prefill_graph.GRAPHS, lm_skiplora.GRAPHS):
        cache.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
