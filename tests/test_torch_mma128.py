"""Bias-free attention at head widths 80-128 (route ``"mma128"``: the
bias-free instantiations at head width 128 of the tensor-core forward of
``csrc/attention_fwd_bias_mma.cu`` and the passes of
``csrc/attention_bwd_bias_mma.cu``) on the CPU: the route table, the zero
padding to 128 with the true 1/√d, the plain twins the card's kernels are
held against versus the JAX kernels (interpret mode) at 80, 96, 112 and
128 with ragged key lengths and with strict dropout at 128, where the
route's launch counters rise, and that its D = 128 tiles fit a Hopper SM
at the blocks a SM their launch bounds name.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against the plain twins there.

    python -m pytest tests/test_torch_mma128.py -q
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bwd_bias_mma import SOURCE as BWD_SOURCE, bias_bwd_tiles
from test_torch_fwd_bias_mma import SOURCE as FWD_SOURCE, fwd_bias_tiles
from wfl_asr_tpu.ops.pallas.dropout_mask import seed_arr
from wfl_asr_tpu.ops.pallas.flash_attention_bwd import _fwd_impl, \
    flash_attention_trainable as jax_fat
from wfl_asr_tpu_torch.ops.kernels import _build, flash_attention, \
    flash_attention_bwd, reset_launch_counts

ATTN_TOL = 1e-5                     # forward, LSE and gradients, absolute
SM_SMEM = 233472                    # shared memory of a Hopper SM
BLOCK_SMEM = 232448                 # of it, what one block may use
BLOCK_RESERVED = 1024               # reserved by the system per block
REGS_SM = 65536                     # 32-bit registers of a SM
WIDTHS = (80, 96, 112, 128)         # the head widths route mma128 takes


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("has_bias", [False, True])
def test_route_table(has_bias):
    """Every multiple of 16 from 16 to 2048: bias-free, ≤ 64 → "mma64",
    80-128 → "mma128", 144-512 → "mma", above → "wide"; with a bias, 64 →
    "mma_bias", other widths up to 512 → "fused" ("fma" backward), above →
    "wide". The backward takes the forward's design, so a call's LSE and
    its gradients come from one route."""
    for d in range(16, 2049, 16):
        if d > 512:
            want = "wide"
        elif has_bias:
            want = "mma_bias" if d == 64 else "fused"
        else:
            want = "mma64" if d <= 64 else "mma128" if d <= 128 else "mma"
        assert flash_attention.forward_route(d, has_bias) == want, d
        assert flash_attention.backward_route(d, has_bias) == \
            ("fma" if want == "fused" else want), d
    with pytest.raises(ValueError, match="2048"):
        flash_attention.forward_route(2064, has_bias)


def _inputs(seed, b, h, t, d):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, h, t, d) * 0.5).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("d", [80, 96, 112])
def test_padding_to_128_is_the_identity(d):
    """What the mma128 launchers do to a narrower width: q, k, v (and dO)
    zero-padded on D to 128 and run with the true 1/√d. The plain twins on
    the padded tensors, sliced back to d, give the unpadded call's output,
    LSE and dq, dk, dv; the padded columns of every gradient are 0."""
    b, h, t = 2, 2, 45
    q, k, v, dout = map(torch.from_numpy, _inputs(d, b, h, t, d))
    kv = torch.tensor([t, 19], dtype=torch.int32)
    scale = 1.0 / math.sqrt(d)
    qp, kp, vp, dp = flash_attention._pad_to(128, q, k, v, dout)
    assert qp.shape == (b, h, t, 128) and qp.is_contiguous()
    out, lse = flash_attention.attention_plain(q, k, v, kv_len=kv,
                                               return_lse=True)
    out_p, lse_p = flash_attention.attention_plain(
        qp, kp, vp, kv_len=kv, return_lse=True, scale=scale)
    torch.testing.assert_close(out_p[..., :d], out, atol=1e-6, rtol=0)
    assert not out_p[..., d:].any()
    torch.testing.assert_close(lse_p, lse, atol=1e-6, rtol=0)
    want = flash_attention.attention_backward_plain(q, k, v, None, None, kv,
                                                    out, lse, dout)[:3]
    got = flash_attention.attention_backward_plain(
        qp, kp, vp, None, None, kv, out_p, lse_p, dp, scale=scale)[:3]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g[..., :d], w, atol=1e-6, rtol=0,
                                   msg=name)
        assert not g[..., d:].any(), name


@pytest.mark.parametrize("d", WIDTHS)
def test_plain_twins_match_jax(d):
    """``flash_attention_trainable`` at [2, 2, 203, d], key lengths (203,
    77), on the CPU (the plain twins the card's mma128 kernels are held
    against): forward and dq, dk, dv through autograd against jax.vjp of
    the JAX entry point (its Pallas kernels in interpret mode), and the
    plain twin's row LSE against the JAX forward kernel's, within 1e-5."""
    b, h, t = 2, 2, 203
    q, k, v, dout = _inputs(128 + d, b, h, t, d)
    kv = np.array([t, 77], np.int32)
    want_out, vjp = jax.vjp(lambda *xs: jax_fat(*xs, jnp.asarray(kv)),
                            *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    _, want_lse = _fwd_impl(*map(jnp.asarray, (q, k, v)), jnp.asarray(kv),
                            seed_arr(None), 128, 128, 0.0)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention_bwd.flash_attention_trainable(*leaves,
                                                        torch.from_numpy(kv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ATTN_TOL, rtol=0)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_TOL,
                                   rtol=0, err_msg=name)
    _, lse = flash_attention.attention_plain(
        *map(torch.from_numpy, (q, k, v)), kv_len=torch.from_numpy(kv),
        return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=ATTN_TOL, rtol=0)


def test_strict_dropout_at_128_matches_jax():
    """Strict attention dropout (rate 0.1, the hash mask of one int32 seed)
    at [2, 2, 203, 128], key lengths (203, 77): the forward and dq, dk, dv
    against the JAX Pallas kernels with the same seed, within 1e-5."""
    b, h, t, d = 2, 2, 203, 128
    q, k, v, dout = _inputs(7, b, h, t, d)
    kv = np.array([t, 77], np.int32)
    seed, rate = 987654, 0.1
    want_out, vjp = jax.vjp(
        lambda *xs: jax_fat(*xs, jnp.asarray(kv), dropout_rate=rate,
                            dropout_seed=jnp.int32(seed)),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention_bwd.flash_attention_trainable(
        *leaves, torch.from_numpy(kv), dropout_rate=rate, dropout_seed=seed)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ATTN_TOL, rtol=0)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_TOL,
                                   rtol=0, err_msg=name)
    # the mask is live: another seed moves the output
    other = flash_attention_bwd.flash_attention_trainable(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(kv),
        dropout_rate=rate, dropout_seed=seed + 1)
    assert (other - out.detach()).abs().max() > 1e-2


def _stand_in(monkeypatch, err, launcher):
    """A library that records each launcher call and returns ``err``, for
    the named launcher only. Returns (libraries asked for, calls)."""
    libs, calls = [], []

    class Library:
        def __getattr__(self, name):
            if name == "wfl_error_string":
                return lambda code: b"invalid argument"
            assert name == launcher
            return lambda *args: calls.append(args) or err
    monkeypatch.setattr(_build, "library",
                        lambda name: libs.append(name) or Library())
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return libs, calls


def _other_counts_zero(*own):
    names = ("mma_fwd_launches", "mma_bias_fwd_launches",
             "mma64_fwd_launches", "mma128_fwd_launches",
             "wide_fwd_launches", "fused_fwd_launches", "mma_bwd_launches",
             "mma_bias_bwd_launches", "mma64_bwd_launches",
             "mma128_bwd_launches", "wide_bwd_launches", "fma_bwd_launches")
    for name in names:
        if name not in own:
            assert getattr(flash_attention, name) == 0, name


@pytest.mark.parametrize("err", [0, 2])
@pytest.mark.parametrize("d", [128, 96, 80])
def test_mma128_forward_counted_where_it_launches(monkeypatch, err, d):
    """``mma128_fwd_launches`` rises in the mma128 branch, after the
    launcher of ``attention_fwd_bias_mma.cu`` returned no error: once a
    call, not when the launch failed, and no other forward count moves.
    The launcher gets null bias and gate pointers and head_dim 128,
    narrower inputs zero-padded to it, the true 1/√d as the scale, and the
    output comes back at the caller's width. (A stand-in library takes the
    launch on the CPU.)"""
    libs, calls = _stand_in(monkeypatch, err, "wfl_attention_fwd_bias_mma")
    reset_launch_counts()
    x = torch.randn(2, 3, 45, d)
    kv = torch.tensor([45, 20], dtype=torch.int32)
    lse = torch.zeros(2, 3, 45)
    args = (x, x, x, kv, lse, None, 0, 1.0)
    if err:
        with pytest.raises(_build.KernelBuildError, match="invalid"):
            flash_attention._launch_mma128_fwd(*args)
    else:
        out = flash_attention._launch_mma128_fwd(*args)
        assert out.shape == x.shape and out.dtype == x.dtype
    assert libs == ["attention_fwd_bias_mma"] and len(calls) == 1
    a = calls[0]
    assert len(a) == 18 and a[3] is None and a[4] is None
    assert a[7] == lse.data_ptr()
    assert a[9:13] == (2, 3, 45, 128)
    assert a[13] == pytest.approx(1 / np.sqrt(d))
    assert flash_attention.mma128_fwd_launches == (0 if err else 1)
    _other_counts_zero("mma128_fwd_launches")


@pytest.mark.parametrize("err", [0, 2])
@pytest.mark.parametrize("d", [128, 112])
def test_mma128_passes_counted_where_they_launch(monkeypatch, err, d):
    """``mma128_bwd_launches`` rises in the mma128 branch, after the
    launcher of ``attention_bwd_bias_mma.cu`` returned no error: once a
    call, not when the launch failed, and no other route's count moves.
    The launcher gets null bias, gate, dBias and dGate pointers, head_dim
    128 (narrower inputs zero-padded to it), a workspace row of T rounded
    up to 64 and the true 1/√d; the gradients come back at the caller's
    width. (A stand-in library takes the launch on the CPU.)"""
    libs, calls = _stand_in(monkeypatch, err, "wfl_attention_bwd_bias_mma")
    reset_launch_counts()
    x = torch.randn(2, 3, 70, d)
    lse = delta = torch.zeros(2, 3, 70)
    kv = torch.tensor([70, 33], dtype=torch.int32)
    args = (x, x, x, x, lse, delta, kv, None, 0, 1.0)
    if err:
        with pytest.raises(_build.KernelBuildError, match="invalid"):
            flash_attention._launch_mma128(*args)
    else:
        grads = flash_attention._launch_mma128(*args)
        assert [g.shape for g in grads] == [x.shape] * 3
    assert libs == ["attention_bwd_bias_mma"] and len(calls) == 1
    a = calls[0]
    assert len(a) == 26
    assert a[3] is None and a[4] is None and a[14] is None and a[15] is None
    assert a[16:21] == (2, 3, 70, 128, 128)       # B, H, T, D, ldk
    assert a[21] == pytest.approx(1 / np.sqrt(d))
    assert flash_attention.mma128_bwd_launches == (0 if err else 1)
    _other_counts_zero("mma128_bwd_launches")


def test_cpu_path_counts_no_mma128_launch():
    """On CPU tensors the entry point runs the plain twins: the launchers
    refuse CPU tensors at 96 and 128, and no count moves."""
    reset_launch_counts()
    for d in (96, 128):
        x = torch.randn(1, 2, 8, d, requires_grad=True)
        flash_attention_bwd.flash_attention_trainable(x, x, x).sum() \
            .backward()
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention.launch_kernel(x.detach(), x.detach(), x.detach())
    _other_counts_zero()
    assert flash_attention_bwd.launches == flash_attention_bwd.bwd_launches \
        == 0


@pytest.mark.parametrize("f32", [True, False])
def test_d128_tiles_fit_shared_memory(f32):
    """The D = 128 instantiations' tiles, mirrored from the sources. In
    f32: the forward's block fits the 227 KB a block may use, and the
    blocks a SM its launch bounds name fit a SM's 228 KB with 1 KB reserved
    each and its 65536 registers at up to 255 a thread (1 block of 8 warps,
    as 2 would allow 128 registers a thread; Q read from shared memory, not
    held in registers); the dK/dV pass at its blocks a SM (2, 16 queries a
    streamed tile) and not one more. In bf16 the forward and the dK/dV pass
    at 128 are attention_wgmma.cu's (route wgmma128), which both sources'
    tile tables refuse; the dQ pass, which that route runs, fits a block's
    limit in both dtypes."""
    bwd = bias_bwd_tiles(f32, bias=False, wide=True)
    assert bwd["d"] == flash_attention.MMA128_D
    assert bwd["dq_smem"] <= BLOCK_SMEM
    assert fwd_bias_tiles(f32, bias=False)["q_regs"]         # D = 64
    if not f32:
        for source in (FWD_SOURCE, BWD_SOURCE):
            assert "(D == kD128 && !BIAS && kF32)" in source.read_text()
        assert flash_attention.forward_route(128, False, torch.bfloat16) \
            == flash_attention.backward_route(128, False, torch.bfloat16) \
            == "wgmma128"
        return
    fwd = fwd_bias_tiles(f32, bias=False, wide=True)
    assert fwd["d"] == flash_attention.MMA128_D
    assert fwd["smem"] <= BLOCK_SMEM, fwd
    assert fwd["blocks"] * (fwd["smem"] + BLOCK_RESERVED) <= SM_SMEM, fwd
    threads = 32 * fwd["warps"]
    assert REGS_SM // (fwd["blocks"] * threads) >= 255, fwd
    assert (fwd["blocks"], fwd["warps"], fwd["q_regs"]) == (1, 8, False)
    assert bwd["blocks"] * (bwd["dkdv_smem"] + BLOCK_RESERVED) <= SM_SMEM
    assert (bwd["blocks"] + 1) * (bwd["dkdv_smem"] + BLOCK_RESERVED) \
        > SM_SMEM
    assert REGS_SM // (bwd["blocks"] * 128) >= 255
    assert (bwd["blocks"], bwd["bq"]) == (2, 16)
