"""The SMW kernels' share of their bound: Σ over MKOR's factors of the
rank-1 update's bound (J read and written once at its storage dtype) over
``inv_freq`` (``flops.smw_bound_s_per_step``), over the device time a step
of the program's SMW kernels (``csrc/block_smw.cu``, ``csrc/rank1_smw.cu``)."""
import flops


def read(ctx):
    t = ctx.trace
    opt = ctx.traffic["optimizer"]
    if opt["name"] != "mkor" or not t.steps:
        return None
    spent = t.seconds_by_kind().get("smw", 0.0) / t.steps
    if spent <= 0:
        return None
    bound = flops.smw_bound_s_per_step(
        ctx.cfg, opt["inv_freq"], flops.FACTOR_BYTES[opt["factor_quant"]])
    return 100.0 * bound / spent
