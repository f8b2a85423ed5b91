"""The yardstick's arithmetic against counts worked out by hand."""
import json

import pytest

from conftest import BENCH
import flops


@pytest.fixture(scope="module")
def bert():
    return json.loads((BENCH / "configs" / "bert-large.json").read_text())


def test_bert_large_model_flops_per_step(bert):
    # dense: 24 × (4·1024² + 2·1024·4096) + 1024·30720 = 333,447,168
    # weights, 2 × 8192 tokens each; attention: 64·16·128² = 16,777,216
    # pairs a layer, an outer product and a 64-wide value product each
    dense = 333_447_168 * 2 * 8192
    attn = 24 * (16_777_216 + 2 * 16_777_216 * 64)
    assert dense == 5_463_198_400_512
    assert flops.model_flops_per_step(bert, 64, 128) == 3 * (dense + attn)
    assert flops.model_flops_per_step(bert, 64, 128) == 16_545_421_983_744


def test_bert_large_precondition_ops_and_bound(bert):
    # per layer: four 1024² projections, 2·1024·1024·2048 each, and the
    # two MLP layers, 2·1024·4096·5120 each; all operation-bound
    per_layer = 4 * 4_294_967_296 + 2 * 42_949_672_960
    assert per_layer == 103_079_215_104
    assert flops.precond_cost(1024, 1024) == (10_485_760.0, 4_294_967_296.0)
    assert flops.precond_cost(1024, 4096)[0] == 60_817_408.0
    bound = flops.precond_bound_s_per_step(bert)
    assert bound == pytest.approx(24 * per_layer / 989e12, rel=1e-12)
    assert bound * 1e3 == pytest.approx(2.5014, abs=1e-4)


def test_bert_large_smw_bytes_and_bound(bert):
    # J read and written once in bf16, the fp32 vector and coefficient
    assert flops.smw_cost(1024) == (4_198_404.0, 5 * 1024 ** 2 + 4 * 1024)
    assert flops.smw_cost(4096)[0] == 67_125_252.0
    # per layer: q, k, v, o have two 1024 factors each, the MLP layers a
    # 1024 and a 4096 one: ten 1024² and two 4096² factors, bytes-bound
    per_layer = 10 * 4_198_404 / 3.35e12 + 2 * 67_125_252 / 3.35e12
    assert flops.smw_bound_s_per_step(bert, 10) == pytest.approx(
        24 * per_layer / 10, rel=1e-12)
    # int8 codes: one byte an element, the same vector and coefficient
    assert flops.smw_cost(1024, flops.FACTOR_BYTES["int8"])[0] == \
        2 * 1024 ** 2 + 4 * 1024 + 4

