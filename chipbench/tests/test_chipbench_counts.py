"""The counts against numbers worked by hand."""
from __future__ import annotations

import json

import pytest

from chipbench import counts

from .conftest import ROOT


def run_of(name):
    return json.loads((ROOT / "chipbench" / "configs" / f"{name}.json")
                      .read_text())["run"]


def test_grok_weights_and_decode_bound():
    """6 layers of 4,919,980,032 parameters (projections 88,080,384,
    norms 12,288, router 49,152, experts 4,831,838,208) plus embedding
    and head of 805,306,368 each and the final norm: 31,130,499,072, in
    bf16 62.26 GB, 18.59 ms at 3.35 TB/s."""
    run = run_of("grok-1")
    assert counts.attn_params(run) == 88_080_384
    assert counts.layer_params(run) == 4_919_980_032
    assert counts.param_count(run) == 31_130_499_072
    nbytes = counts.weight_bytes(run, "bfloat16")
    assert nbytes == 62_260_998_144
    assert nbytes / counts.HBM_BYTES_PER_S * 1e3 == pytest.approx(18.585,
                                                                 abs=1e-3)


def test_granite_train_step_flops():
    """Matmul parameters 40 x 60,817,408 + the head's 100,669,440 =
    2,533,365,760; 6 a token over 32,768 tokens is 4.98080e14; causal
    attention 12 x 64 x 32 x 524,800 pairs x 40 layers x 32 sequences is
    1.65086e13: 5.14589e14 a step (6 N with N the 2.63 B parameters,
    embedding included, is the 5.2e14 quoted elsewhere)."""
    run = run_of("granite-3-2b")
    assert counts.matmul_params_per_token(run) + 2048 * 49155 \
        == 2_533_365_760
    assert counts.causal_pairs(1024) == 524_800
    want = 6 * 2_533_365_760 * 32_768 + 12 * 64 * 32 * 524_800 * 40 * 32
    assert counts.train_step_flops(run, 32, 1024) == pytest.approx(want,
                                                                  rel=1e-12)
    assert want == pytest.approx(5.14589e14, rel=1e-5)
    # embedding and head 100,669,440 each, 40 x (60,817,408 + two norms of
    # 2,048), the final norm
    assert counts.param_count(run) == 2_634_201_088


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(3.35e12, 1.0) == (1.0, "bytes")
    assert counts.least_seconds(1.0, 989e12) == (1.0, "operations")
    assert counts.least_seconds(1.0, 67e12, "float32") == (1.0,
                                                           "operations")


@pytest.mark.parametrize("kw,nbytes,flops", [
    # (4,1024,32,64) causal over (4,1024,8,64) in bf16
    (dict(b=4, sq=1024, skv=1024, h=32, kvh=8, dh=64),
     2 * (2 * 4 * 1024 * 32 * 64 + 2 * 4 * 1024 * 8 * 64),
     4 * 4 * 32 * 64 * 524_800),
])
def test_flash_attention_least(kw, nbytes, flops):
    assert counts.flash_attention_least(**kw) == pytest.approx(
        max(nbytes / 3.35e12, flops / 989e12))


def test_decode_and_rmsnorm_least():
    # Grok-1's decode: q and out (32,48,128), 300 live rows of (8,128)
    nbytes = 2 * (2 * 32 * 48 * 128 + 2 * 32 * 300 * 8 * 128)
    assert counts.flash_decode_least(32, 48, 8, 128, 300) == pytest.approx(
        nbytes / 3.35e12)
    assert counts.rmsnorm_least(4096, 2048) == pytest.approx(
        2 * (2 * 4096 * 2048 + 2048) / 3.35e12)


def test_decode_step_least_counts_routed_experts():
    """All experts routed reads the whole model; two a layer reads six
    experts a layer fewer."""
    run = run_of("grok-1")
    full = counts.step_weight_bytes(run, "bfloat16", 32)
    two = counts.step_weight_bytes(run, "bfloat16", 32, [2] * 6)
    assert full - two == 2 * 6 * 6 * 3 * 6144 * 32768
    # the embedding rows looked up are 32 of 131072
    assert full == 62_260_998_144 - 2 * (131072 - 32) * 6144


def test_prefill_flops_counts_last_position_logits():
    run = run_of("grok-1")
    per_tok = 6 * (88_080_384 + 2 * 3 * 6144 * 32768 + 6144 * 8)
    attn = 6 * 4 * 2 * 2 * 48 * 128 * counts.causal_pairs(2048)
    want = 2 * per_tok * 4 * 2048 + attn + 2 * 6144 * 131072 * 4
    assert counts.prefill_flops(run, 4, 2048) == pytest.approx(want)
