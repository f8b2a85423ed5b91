"""Device milliseconds a step from the ``second_order`` phase mark to the
``first_order`` one: MKOR's factor updates, preconditioning,
stabilisation and glue (``phases.py``)."""
import phases


def read(ctx):
    return phases.phase_ms(ctx.trace, "second_order")
