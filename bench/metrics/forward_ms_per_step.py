"""Device milliseconds a step from the ``forward`` phase mark to the
``backward`` one: MKOR's staleness-1 tick when there is one, the model's
forward and the loss (``phases.py``)."""
import phases


def read(ctx):
    return phases.phase_ms(ctx.trace, "forward")
