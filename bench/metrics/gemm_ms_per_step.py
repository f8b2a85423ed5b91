"""Device milliseconds a step in library GEMM kernels (cuBLAS, CUTLASS:
the model's dense products forward and backward), by name
(``trace.LIBRARY_GEMM``)."""


def read(ctx):
    t = ctx.trace
    ms = t.seconds_by_kind().get("gemm", 0.0) * 1e3
    return ms / t.steps if t.steps and ms > 0 else None
