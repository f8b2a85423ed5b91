"""The precondition kernels' share of their bound: Σ over MKOR's layers of
the bound of ΔW = R⁻¹ G L⁻¹ (``flops.precond_bound_s_per_step``), over the
device time a step of the program's precondition kernels (the GEMMs of
``csrc/matmul.cu`` and the kernels of ``csrc/precond.cu``)."""
import flops


def read(ctx):
    t = ctx.trace
    if ctx.traffic["optimizer"]["name"] != "mkor" or not t.steps:
        return None
    spent = t.seconds_by_kind().get("precond", 0.0) / t.steps
    if spent <= 0:
        return None
    return 100.0 * flops.precond_bound_s_per_step(ctx.cfg) / spent
