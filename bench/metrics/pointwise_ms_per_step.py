"""Device milliseconds a step in kernels that are neither library GEMMs nor
the program's own: LAMB's and MKOR's elementwise passes, the model's
norms, activations, softmax and casts, copies and sets."""


def read(ctx):
    t = ctx.trace
    ms = t.seconds_by_kind().get("other", 0.0) * 1e3
    return ms / t.steps if t.steps and ms > 0 else None
