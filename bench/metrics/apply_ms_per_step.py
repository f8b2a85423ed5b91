"""Device milliseconds a step from the ``apply`` phase mark to the ``end``
one: the parameter update, the step's global norms, and the chunk
runner's write-back into its static buffers and metrics row
(``phases.py``)."""
import phases


def read(ctx):
    return phases.phase_ms(ctx.trace, "apply")
