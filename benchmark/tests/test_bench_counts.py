"""The yardstick's arithmetic against hand counts."""
import numpy as np
import pytest

from benchmark import cells, counts, traffic

BENCH = cells.load_benchmark()
D30 = cells.config(BENCH, "var-d30-fp4kv6")
D36 = cells.config(BENCH, "var-d36-512-int8kv")


def test_block_linears_d30():
    # 2 guidance rows x 680 tokens x 30 blocks x 12 C^2 MACs x 2
    assert counts.block_linear_flops(D30["model"]) == 2 * 680 * 30 * 12 \
        * 1920 ** 2 * 2
    assert counts.block_linear_flops(D30["model"]) == pytest.approx(
        3.61e12, rel=1e-3)


def test_block_linears_d36():
    assert counts.block_linear_flops(D36["model"]) == 2 * 2240 * 36 * 12 \
        * 2304 ** 2 * 2
    assert counts.block_linear_flops(D36["model"]) == pytest.approx(
        2.05e13, rel=3e-3)


def test_attention_term_by_hand():
    m = dict(D30["model"], patch_nums=[1, 2])
    # scale 1: 1 token over 1; scale 2: 4 tokens over 5
    hand = 2 * 30 * 4 * 1920 * (1 * 1 + 4 * 5)
    no_attn = counts.model_flops_per_image(dict(D30, model=dict(
        m, patch_nums=[1, 2]))) - hand
    assert no_attn > 0
    assert counts.scale_steps([1, 2]) == [(1, 1), (4, 5)]


def test_model_flops_d30_d36():
    f30 = counts.model_flops_per_image(D30)
    f36 = counts.model_flops_per_image(D36)
    assert 3.7e12 < f30 < 4.5e12
    assert 2.1e13 < f36 < 2.6e13


def test_decoder_flops_by_hand():
    v = dict(D30["vae"], ch_mult=[1], num_res_blocks=0)
    hw, c = 16, 160
    px = hw * hw
    attn = 2 * 3 * c * c * px + 2 * c * c * px + 4 * c * px * px
    # post-quant conv, conv_in, six 3x3 convs (two mid resnets, one up
    # resnet), mid and top attention, conv_out
    hand = (2 * 32 * 32 * 9 * px + 2 * c * 32 * 9 * px
            + 6 * 2 * c * c * 9 * px + 2 * attn + 2 * 3 * c * 9 * px)
    assert counts.decoder_flops(v, hw) == hand


def test_int8_bound_one_scale():
    m = dict(D36["model"], depth=1, patch_nums=[2])
    c, rows = 2304, 2 * 8 * 4
    want = 0.0
    for n, k, ob, calls in ((3 * c, c, 2, 1), (c, c, 2, 1), (4 * c, c, 2, 1),
                            (c, 4 * c, 4, 2)):
        b = rows * k + n * k + 4 * rows + 4 * n + ob * rows * n
        want += calls * max(b / 3.35e12, 2 * rows * n * k / 1979e12)
    assert counts.int8_gemm_bound_s(m, 8) == pytest.approx(want, rel=1e-12)


def test_arrivals_same_gaps_other_order():
    mix = {"rate": 10.0}
    q = (np.arange(300) + 0.5) / 300
    gaps = -np.log1p(-q) / 10.0
    ds = [traffic.arrivals(mix, 1000, seed, 30.0)[0] for seed in (5, 6)]
    for d in ds:
        assert len(d) == 300
        diffs = np.diff(d)
        assert np.abs(diffs[:, None] - gaps[None]).min(axis=1).max() < 1e-9
    assert (ds[0] != ds[1]).any()
    assert (ds[0] == traffic.arrivals(mix, 1000, 5, 30.0)[0]).all()


def test_bursts():
    d = traffic.arrivals({"rate": 8.0, "burst": 4}, 1000, 1, 4.0)[0]
    assert len(d) == 32 and (d.reshape(8, 4) == d.reshape(8, 4)[:, :1]).all()
