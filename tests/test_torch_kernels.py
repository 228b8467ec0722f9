"""The port's kernel entry points on the CPU: each plain PyTorch twin
against the JAX Pallas kernel it replaces (interpret mode), and the rule
that a kernel is never quietly replaced by its twin.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each one against its twin there."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wfl_asr_tpu.ops.pallas.conv_fused import fused_conv_chain as jax_chain
from wfl_asr_tpu.ops.pallas.flash_attention import flash_attention as jax_fa
from wfl_asr_tpu.ops.pallas.flash_attention_bwd import \
    flash_attention_trainable as jax_fat
from wfl_asr_tpu_torch.ops.kernels import _build, conv_fused, \
    flash_attention, flash_attention_bwd, reset_launch_counts

TOL = 1e-5
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _qkv(rng, b, h, t, d):
    return [rng.randn(b, h, t, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("d,t", [(16, 50), (32, 64)])
def test_gated_attention_twin_matches_jax(d, t):
    rng = np.random.RandomState(d + t)
    b, h = 2, 3
    q, k, v = _qkv(rng, b, h, t, d)
    bias = rng.randn(h, t, t).astype(np.float32)
    gate = (rng.rand(b, h, t) + 0.5).astype(np.float32)
    kv_len = np.array([t, t - 17], np.int32)
    ref = np.asarray(jax_fa(*map(jnp.asarray, (q, k, v, bias, gate)),
                            kv_len=jnp.asarray(kv_len), block_q=16,
                            block_k=128))
    out = flash_attention.flash_attention(
        *map(torch.from_numpy, (q, k, v, bias, gate)),
        kv_len=torch.from_numpy(kv_len)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("kv", [None, (40, 9)])
def test_masked_attention_twin_matches_jax(kv):
    rng = np.random.RandomState(3)
    b, h, t, d = 2, 2, 40, 32
    q, k, v = _qkv(rng, b, h, t, d)
    kv_len = None if kv is None else np.array(kv, np.int32)
    ref = np.asarray(jax_fat(*map(jnp.asarray, (q, k, v)),
                             None if kv_len is None else jnp.asarray(kv_len)))
    out = flash_attention_bwd.flash_attention_trainable(
        *map(torch.from_numpy, (q, k, v)),
        None if kv_len is None else torch.from_numpy(kv_len)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("ks,t,has_norm", [
    ((3, 3, 3), 64, True),        # WavLM layers 1-3 shape-alike + GroupNorm
    ((3, 2, 2), 60, False),       # WavLM layers 4-6 shape-alike
    ((2,), 33, False),
])
def test_conv_chain_twin_matches_jax(ks, t, has_norm):
    rng = np.random.RandomState(sum(ks) + t)
    b, c = 2, 16
    x = (rng.randn(b, t, c) * 0.4).astype(np.float32)
    ws = [(rng.randn(c, c, k) * (0.5 / np.sqrt(c * k))).astype(np.float32)
          for k in ks]
    norm = None
    if has_norm:
        norm = (rng.randn(b, c).astype(np.float32) * 0.1,
                (1.0 + rng.rand(b, c)).astype(np.float32),
                rng.randn(c).astype(np.float32),
                rng.randn(c).astype(np.float32) * 0.1)
    ref = np.asarray(jax_chain(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        input_norm=None if norm is None else tuple(map(jnp.asarray, norm))))
    out = conv_fused.fused_conv_chain(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
        input_norm=None if norm is None else tuple(map(torch.from_numpy,
                                                       norm))).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_twins_leave_launch_counts_at_zero():
    """CPU tensors take the plain twin: no kernel launch is counted."""
    reset_launch_counts()
    x = torch.randn(1, 2, 8, 16)
    flash_attention.flash_attention(x, x, x)
    flash_attention_bwd.flash_attention_trainable(x, x, x)
    conv_fused.fused_conv_chain(torch.randn(1, 20, 8),
                                [torch.randn(8, 8, 3)])
    assert flash_attention.launches == 0
    assert flash_attention_bwd.launches == 0
    assert not conv_fused.launches


def test_asking_for_a_kernel_raises_without_cuda():
    """The kernel path raises here (no CUDA toolkit, no device) instead of
    falling back to the plain twin."""
    x = torch.randn(1, 2, 8, 16)
    with pytest.raises((_build.KernelBuildError, RuntimeError, ValueError)):
        _build.library("flash_attention")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.launch_kernel(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        conv_fused.launch_kernel(torch.randn(1, 20, 8),
                                 [torch.randn(8, 8, 3)])


@pytest.mark.parametrize("kwargs,exc", [
    (dict(dropout_rate=0.1), ValueError),       # a rate needs a seed
    (dict(gate=torch.ones(1, 2, 8)), ValueError),
])
def test_attention_rejects_unported_options(kwargs, exc):
    x = torch.randn(1, 2, 8, 16)
    with pytest.raises(exc):
        flash_attention.flash_attention(x, x, x, **kwargs)


@pytest.mark.parametrize("d", [520, 528, 1024])
def test_attention_takes_head_dims_above_512(d):
    """Widths above 512 (the wide route on the card; 520 padded to 528 on
    every device) run: forward and backward of both entry points match the
    plain twins on the unpadded inputs, with a ragged key length, bias-free
    and with a bias and a gate. (The JAX kernels are the reference in
    tests/test_torch_wide.py.)"""
    rng = np.random.RandomState(d)
    b, h, t = 2, 1, 12
    q, k, v, dout = (torch.from_numpy(rng.randn(b, h, t, d)
                                      .astype(np.float32)) for _ in range(4))
    bias = torch.from_numpy(rng.randn(h, t, t).astype(np.float32))
    gate = torch.from_numpy((rng.rand(b, h, t) + 0.5).astype(np.float32))
    kv = torch.tensor([t, 7], dtype=torch.int32)
    for with_bias in (False, True):
        extra = (bias, gate) if with_bias else (None, None)
        leaves = [x.clone().requires_grad_() for x in (q, k, v) + extra
                  if x is not None]
        if with_bias:
            out = flash_attention.flash_attention(*leaves, kv_len=kv)
        else:
            out = flash_attention_bwd.flash_attention_trainable(*leaves, kv)
        got = torch.autograd.grad(out, leaves, dout)
        ref, lse = flash_attention.attention_plain(q, k, v, *extra, kv,
                                                   return_lse=True)
        want = [g for g in flash_attention.attention_backward_plain(
            q, k, v, *extra, kv, ref, lse, dout) if g is not None]
        assert out.shape == (b, h, t, d)
        np.testing.assert_allclose(out.detach().numpy(), ref.numpy(),
                                   atol=TOL, rtol=0)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w.numpy(),
                                       atol=TOL * w.abs().max().item(),
                                       rtol=0)


@pytest.mark.parametrize("c", [512, 80, 48])
@pytest.mark.parametrize("f32", [True, False])
def test_conv_chain_tile_fits_shared_memory(f32, c):
    """The conv layer kernel's stage ring (``Tiles`` and ``Cfg`` in
    ``csrc/conv_fused.cu``: per stage the 2·bm + 1 input rows and 3·bn
    weight rows of one 64-byte K slice, two rows a 128-byte line, each on
    1024 bytes) and its
    epilogue tile fit a Hopper block's shared memory, at WavLM-base width
    and the smoke's small widths; each width is whole 16-byte chunks, so a
    chunk never straddles C (the kernel's zero fill is by whole chunks)."""
    text = (Path(conv_fused.__file__).parent / "csrc"
            / "conv_fused.cu").read_text()
    bm, bn, stages = map(int, re.search(
        r"struct Tiles<%s> \{ static constexpr int bm = (\d+), bn = (\d+), "
        r"wn = \d+, stages = (\d+)," % ("OpF32" if f32 else "OpBF16"),
        text).groups())
    es = 4 if f32 else 2
    a_bytes = -(-((2 * bm + 2) // 2 * 128) // 1024) * 1024
    ring = stages * (a_bytes + 3 * bn // 2 * 128)
    assert stages >= 3
    assert ring <= SMEM_LIMIT
    assert bm * (bn + 8) * 4 <= ring          # the f32 epilogue tile
    assert c * es % 16 == 0 and c % (4 if f32 else 16) == 0


# ---------------------------------------------------------------------------
# Backward: the plain twins (the CPU autograd path) against jax.vjp of the
# JAX entry points, which runs the K2b/K1b Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def _bwd_inputs(seed, b, h, t, d, mode):
    rng = np.random.RandomState(seed)
    q, k, v = [(x * 0.5).astype(np.float32) for x in _qkv(rng, b, h, t, d)]
    bias = gate = None
    if mode != "none":
        bias = (rng.randn(h, t, t) * 0.3).astype(np.float32)
    if mode == "bias+gate":
        gate = (rng.rand(b, h, t) * 2.0).astype(np.float32)
    dout = rng.randn(b, h, t, d).astype(np.float32)
    return q, k, v, bias, gate, dout


@pytest.mark.parametrize("t,d", [(130, 16), (200, 48)])
@pytest.mark.parametrize("with_kv", [False, True])
@pytest.mark.parametrize("mode", ["bias+gate", "bias", "none"])
def test_backward_matches_jax_vjp(mode, with_kv, t, d):
    """dq, dk, dv (and dbias, dgate) of the port's entry point through
    autograd on the CPU = the saved-LSE plain twin, against jax.vjp, ≤ 1e-5;
    the forward's LSE against the JAX forward's (want_lse=True)."""
    import importlib
    jfa = importlib.import_module("wfl_asr_tpu.ops.pallas.flash_attention")
    b, h = 2, 2
    q, k, v, bias, gate, dout = _bwd_inputs(t + d, b, h, t, d, mode)
    kv_len = np.array([t, t - 37], np.int32) if with_kv else None
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    tkv = None if kv_len is None else torch.from_numpy(kv_len)
    diff = [x for x in (q, k, v, bias, gate) if x is not None]

    if mode == "none":
        def jfn(*xs):
            return jax_fat(*xs, jkv)
    else:
        def jfn(q_, k_, v_, bias_, *g):
            return jax_fa(q_, k_, v_, bias=bias_, gate=g[0] if g else None,
                          kv_len=jkv)
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, diff))
    want = vjp(jnp.asarray(dout))

    leaves = [torch.from_numpy(x).requires_grad_() for x in diff]
    if mode == "none":
        out = flash_attention_bwd.flash_attention_trainable(*leaves, tkv)
    else:
        out = flash_attention.flash_attention(
            *leaves[:4], gate=leaves[4] if len(leaves) > 4 else None,
            kv_len=tkv)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, g, w in zip(("dq", "dk", "dv", "dbias", "dgate"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0, err_msg=name)

    _, lse_j = jfa._fwd_impl(
        *map(jnp.asarray, (q, k, v)),
        None if bias is None else jnp.asarray(bias),
        None if gate is None else jnp.asarray(gate), jkv,
        jnp.zeros((1, 1), jnp.int32), 128, 128, want_lse=True)
    _, lse_t = flash_attention.attention_plain(
        *map(torch.from_numpy, (q, k, v)),
        None if bias is None else torch.from_numpy(bias),
        None if gate is None else torch.from_numpy(gate), tkv,
        return_lse=True)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=TOL,
                               rtol=0)


def test_backward_counts_no_launch_on_cpu():
    """The CPU autograd path runs the plain twins: no backward launch is
    counted, and a CPU tensor never asks for the kernel library."""
    reset_launch_counts()
    x = torch.randn(1, 2, 8, 16, requires_grad=True)
    flash_attention.flash_attention(x, x, x).sum().backward()
    flash_attention_bwd.flash_attention_trainable(x, x, x).sum().backward()
    assert flash_attention.bwd_launches == 0
    assert flash_attention_bwd.bwd_launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.launch_backward(x, x, x, None, None, None, x,
                                        torch.zeros(1, 2, 8), x)

