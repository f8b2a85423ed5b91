"""The whole step's share of the bf16 peak: the model's operations a step
(``flops.model_flops_per_step``: dense products with lm_head, the score
outer product and the value product, × 3) times the steps of the traced
window, over its wall time, over 989 TFLOP/s."""
import flops


def read(ctx):
    t = ctx.trace
    if t.steps <= 0 or t.window_s <= 0:
        return None
    ops = flops.model_flops_per_step(ctx.cfg, ctx.traffic["batch"],
                                     ctx.traffic["seq_len"]) * t.steps
    return 100.0 * ops / t.window_s / flops.PEAK_BF16_FLOPS
