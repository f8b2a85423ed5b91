"""Device milliseconds a step from the ``first_order`` phase mark to the
``apply`` one: the first-order optimizer, LAMB (``phases.py``)."""
import phases


def read(ctx):
    return phases.phase_ms(ctx.trace, "first_order")
