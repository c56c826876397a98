"""The work counts against the hand numbers, from the published sizes."""

import json

import pytest

from bench_fixture import REPO
from port_bench.lib import work


def spec(name):
    return work.Spec.from_config(json.loads(
        (REPO / "port_bench" / "configs" / f"{name}.json").read_text()))


def test_mistral_weights_and_bytes():
    s = spec("mistral-7b")
    assert s.attn_weights + s.mlp_weights == 218_103_808
    assert s.n_layers * s.layer_bytes() == 3_925_868_544
    assert s.head_weights * work.BYTES_PER_WEIGHT["q6_k"] == 107_520_000
    assert s.token_bytes() == 4_033_388_544
    assert s.kv_bytes_per_pos == 131_072
    assert s.token_bytes() / work.PEAK_BYTES_S == pytest.approx(1.204e-3,
                                                                abs=5e-7)


def test_steps_and_peaks():
    s = spec("mistral-7b")
    by, ops = s.decode_step([99])
    assert by == s.token_bytes() + 100 * s.kv_bytes_per_pos
    w = 32 * 218_103_808 + 32000 * 4096
    assert ops == 2 * w + 32 * 4 * 32 * 128 * 100
    # a batch-1 step is bound by bytes; int8 is its stated precision
    assert s.bound_s(by, ops, 1) == by / work.PEAK_BYTES_S
    assert s.peak_ops(1) == 1979e12 and s.peak_ops(16) == 989e12
    by, ops = s.prefill(512)
    assert ops == (512 * 32 * 2 * 218_103_808 + 2 * 32000 * 4096
                   + 32 * 2 * 512 * 512 * 128 * 32)
    assert s.bound_s(by, ops, 512) == ops / 989e12
    # a request: one prefill and steps - 1 decode steps
    t = work.request_bound_s(s, 100, 3)
    assert t == pytest.approx(
        s.bound_s(*s.prefill(100), 100) + s.bound_s(*s.decode_step([100]), 1)
        + s.bound_s(*s.decode_step([101]), 1))
    b16 = s.decode_step([32] * 16)
    assert b16[0] == s.token_bytes() + 16 * 33 * s.kv_bytes_per_pos
