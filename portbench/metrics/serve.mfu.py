"""serve.mfu: the model work of the window's requests as the benchmark
counts it (``flops``: each real prompt token, each generated token, the
attention over its context, readouts and skip sums; no padding), over
the window's time, as a share of the card's bf16 peak."""

from portbench import flops as FL


def read(ctx):
    return 100.0 * ctx.window["flops"] / ctx.window["window_s"] / FL.PEAK_BF16
