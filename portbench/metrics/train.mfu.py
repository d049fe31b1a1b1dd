"""train.mfu: the window's fine-tuning work as the benchmark counts it
(``flops``: each adapt call's cached steps, each ingested row's forward),
over the window's time, as a share of the card's bf16 peak."""

from portbench import flops as FL


def read(ctx):
    return 100.0 * ctx.driver.window_flops() / ctx.window["window_s"] / FL.PEAK_BF16
