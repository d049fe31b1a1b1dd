"""sched.admit_step_ms: median host time of the window's ``step()`` calls
that issued an admission (the scheduler's ``dispatch/admit*`` counters
moved)."""

from portbench.harness import median


def read(ctx):
    t = [s * 1e3 for s, admit in ctx.window["steps"] if admit]
    return median(t) if t else None
