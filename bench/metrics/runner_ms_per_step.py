"""Milliseconds a step of the traced window outside every step's
``forward`` … ``end`` interval: the chunk runner's eager batch and scalar
writes between replays, and the idle at chunk edges while the host binds,
observes and fetches (``phases.py``).  The six phase metrics times the
window's steps make the window."""
import phases


def read(ctx):
    return phases.phase_ms(ctx.trace, "runner")
