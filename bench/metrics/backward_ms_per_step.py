"""Device milliseconds a step from the ``backward`` phase mark to the next
(``second_order`` under MKOR, else ``first_order``): the model's backward
(``phases.py``)."""
import phases


def read(ctx):
    return phases.phase_ms(ctx.trace, "backward")
