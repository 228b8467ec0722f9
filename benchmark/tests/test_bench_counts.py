"""The yardstick's arithmetic, checked by hand at small shapes."""

import math

import pytest

from benchmark.core import counts
from benchmark.tests import tiny


def test_peaks():
    assert counts.peak_flops("bf16") == 989e12
    assert counts.peak_flops("f32_tf32x3") == 165e12
    assert counts.PEAKS["hbm_bytes_per_s"] == 3.35e12


def test_bound_picks_the_larger_time():
    t, by = counts.bound_s(165e12, 1.0, "f32_tf32x3")
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = counts.bound_s(1.0, 3.35e12, "bf16")
    assert t == pytest.approx(1.0) and by == "bytes"


def test_attention_counts():
    # b=1, h=1, t=4, d=2, every key valid: QKᵀ and PV are 2·4·4·2 each
    f, n = counts.attention_fwd(1, 1, 4, 2, 4, 4, False)
    assert f == 2 * (2 * 4 * 4 * 2)
    assert n == 4 * 1 * 1 * 4 * 2 * 4 + 4       # q, k, v, out; kv_len
    f, n = counts.attention_fwd(2, 3, 5, 8, 7, 2, True)
    assert f == 4 * 3 * 5 * 7 * 8
    assert n == 4 * 2 * 3 * 5 * 8 * 2 + 8 + 3 * 25 * 2 + 2 * 3 * 5 * 4
    fb, nb = counts.attention_bwd(1, 1, 4, 2, 4, 4, False)
    assert fb == 5 * (2 * 4 * 4 * 2)
    assert nb == 8 * 4 * 2 * 4 + 2 * 4 * 4 + 4


def test_conv_chain_counts():
    # t_in 11 → (11-3)//2+1 = 5 → (5-2)//2+1 = 2; c = 3
    f, n = counts.conv_chain(1, 11, 3, [3, 2], 4)
    assert f == 2 * 3 * 3 * 3 * 5 + 2 * 3 * 3 * 2 * 2
    assert n == (11 * 3 + 2 * 3 + 5 * 9) * 4


def test_lstm_and_heads_counts():
    # one layer, d_in 4, h 2, t 3: 2 directions × 2·t·4h·(d_in+h)
    assert counts._lstm(3, 4, 2, 1) == 2 * 2 * 3 * 8 * 6
    # a second layer reads both directions (2h)
    assert counts._lstm(3, 4, 2, 2) == 2 * 2 * 3 * 8 * 6 + 2 * 2 * 3 * 8 * 6
    cfg = {"heads": {"lang_emb_dim": 1, "bilstm_num_layer": 1,
                     "conformer_ff_expansion": 2, "conformer_kernel_size": 3,
                     "num_conformer_layers": 1, "dilated_conv_depth": 1,
                     "dilated_conv_kernel": 3}}
    t, hid, n = 2, 4, 5
    want = (2 * t * 5 * 4 + counts._lstm(t, 4, 2, 1)
            + (4 * 2 * t * 4 * 8 + 2 * t * 4 * 12 + 2 * t * 16
               + 4 * t * t * 4 + 2 * t * 4 * 8 + 2 * t * 16 * 3
               + 2 * t * 16)
            + 2 * t * 16 * 3 + 2 * t * 4 * 5 + 2 * t * 16 * 3 + 2 * t * 4 * 2)
    assert counts.heads_flops(cfg, t, hid, n) == want


def test_encoder_counts():
    c = tiny.tiny_configs()["wavlm-base-plus"]
    samples = 16000
    f, t = counts.wavlm_flops(c, samples)
    assert t == 49                        # 20 ms frames, less the edge
    n, cin, conv = samples, 1, 0
    for k, s in zip(c["conv_kernel"], c["conv_stride"]):
        n = (n - k) // s + 1
        conv += 2 * n * 16 * cin * k
        cin = 16
    hid = 32
    pos = 2 * t * hid * (hid // 16) * 128
    layer = 4 * 2 * t * hid * hid + 4 * t * t * hid + 2 * 2 * t * hid * 64 \
        + 2 * t * 2 * 16 * 8
    assert f == conv + 2 * t * 16 * hid + pos + 2 * layer
    w = tiny.tiny_configs()["whisper-base"]
    f, t = counts.whisper_flops(w)
    assert t == 1500
    layer = 4 * 2 * t * 32 * 32 + 4 * t * t * 32 + 2 * 2 * t * 32 * 64
    assert f == 2 * 3000 * 80 * 32 * 3 + 2 * t * 32 * 32 * 3 + 2 * layer


def test_forward_flops_adds_the_heads_at_the_label_frames():
    c = tiny.tiny_configs()["wavlm-base-plus"]
    enc, t = counts.wavlm_flops(c, 32000)
    assert counts.forward_flops(c, 32000, 73) == \
        enc + counts.heads_flops(c, t, 32, 73)
    assert counts.forward_flops(c, 32000, 73, 120) == \
        enc + counts.heads_flops(c, 120, 32, 73)
    assert math.isclose(counts.optimizer_flops(10), 200.0)
