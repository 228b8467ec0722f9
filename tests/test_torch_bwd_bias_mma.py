"""The gated-bias tensor-core attention backward
(``csrc/attention_bwd_bias_mma.cu``, K2b at head_dim 64) on the CPU: that
its tiles fit a Hopper SM, the reduction order of its dBias/dGate pass (a
numpy emulation held to f64), the plain twin it is held against on the card
against ``jax.vjp`` of the JAX entry point at head_dim 64 (with bias, gate,
ragged key lengths and dropout), and where its launch counter rises.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against the plain twin there."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wfl_asr_tpu.ops.pallas.flash_attention import flash_attention as jax_fa
from wfl_asr_tpu_torch.ops.kernels import flash_attention, \
    reset_launch_counts

SM_SMEM = 233472                    # shared memory of a Hopper SM
BLOCK_SMEM = 232448                 # of it, what one block may use
BLOCK_RESERVED = 1024               # reserved by the system per block


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


SOURCE = (Path(flash_attention.__file__).parent / "csrc"
          / "attention_bwd_bias_mma.cu")


def _source_ints(pattern: str) -> tuple:
    """The integers that ``pattern``'s groups match in the kernel's
    source, so that the mirror below cannot drift from it."""
    return tuple(int(g) for g in re.search(pattern, SOURCE.read_text())
                 .groups())


def bias_bwd_tiles(f32: bool, bias: bool = True, wide: bool = False
                   ) -> dict:
    """Mirror of ``BiasTiles`` and ``DqTiles`` in
    ``csrc/attention_bwd_bias_mma.cu`` (with a bias, or its bias-free
    instantiation; ``wide``: the bias-free one at head width ``kD128``):
    the shared memory of the dK/dV and dQ passes in bytes, with the head
    widths, the warps, the key and query tiles, and the queries of the
    dK/dV pass's streamed tile and dK/dV blocks a SM by width and dtype
    read out of the source."""
    es = 4 if f32 else 2
    (d,) = _source_ints(r"constexpr int kD128 = (\d+);" if wide
                        else r"constexpr int kD = (\d+);")
    (warps,) = _source_ints(r"constexpr int kWarps = (\d+);")
    (bk,) = _source_ints(r"constexpr int kBK = (\d+);")
    (bq_dq,) = _source_ints(r"constexpr int kBQ = (\d+);")
    f32_64, f32_wide, bf16_bq = _source_ints(
        r"int bq = kF32 \? \(D == kD \? (\d+) : (\d+)\) : (\d+);")
    bq = (f32_wide if wide else f32_64) if f32 else bf16_bq
    f32_blocks, bf16_blocks = _source_ints(
        r"int blocks = kF32 \? (\d+) : (\d+);")
    blocks = f32_blocks if f32 else bf16_blocks

    def pitch(cols):                    # D-wide rows (attention_mma.cuh)
        return (cols + 31) // 32 * 32 + 8 if f32 else cols + 8

    def pitch_s(cols):                  # score tiles
        return (cols + 31) // 32 * 32 if f32 else cols + 8
    p = pitch(d)
    pst = 16 + 16 // es                 # a warp's dS staging rows
    # K, V; two buffers of Q and dO; each warp's 16-row dS staging tile;
    # LSE, delta and (with a bias) gate rows
    dkdv = es * (2 * bk * p + 2 * 2 * bq * p + warps * 16 * pst) \
        + 4 * (3 if bias else 2) * 2 * bq
    dq = es * 2 * (bk * p + bq_dq * pitch_s(bk))  # two buffers of K and dS
    return dict(d=d, bq=bq, blocks=blocks, dkdv_smem=dkdv, dq_smem=dq)


@pytest.mark.parametrize("f32", [True, False])
def test_bias_tiles_fit_shared_memory(f32):
    """The mirror of the kernel's tile table: the dK/dV pass fits the
    blocks a SM it is sized for in a SM's 228 KB with 1 KB reserved each
    (and one block more would not fit), and the dQ pass fits a block's
    227 KB."""
    t = bias_bwd_tiles(f32)
    assert t["blocks"] * (t["dkdv_smem"] + BLOCK_RESERVED) <= SM_SMEM, t
    assert t["dq_smem"] <= BLOCK_SMEM, t
    assert (t["blocks"] + 1) * (t["dkdv_smem"] + BLOCK_RESERVED) > SM_SMEM


@pytest.mark.parametrize("f32", [True, False])
def test_bias_free_tiles_fit_shared_memory(f32):
    """The bias-free instantiation's dK/dV pass drops only the gate rows, so
    it fits the same blocks a SM as the pass with a bias, and its dQ pass
    is the same."""
    t, with_bias = bias_bwd_tiles(f32, bias=False), bias_bwd_tiles(f32)
    assert with_bias["dkdv_smem"] - t["dkdv_smem"] == 4 * 2 * t["bq"]
    assert t["blocks"] * (t["dkdv_smem"] + BLOCK_RESERVED) <= SM_SMEM, t
    assert t["dq_smem"] == with_bias["dq_smem"] <= BLOCK_SMEM
    text = SOURCE.read_text()
    assert "+ sizeof(float) * (BIAS ? 3 : 2) * 2 * bq;" in text
    assert "if (err != cudaSuccess || !BIAS) return err;" in text


def dbias_dgate_emulated(ds, bias, gate, kv_len, t):
    """The dBias/dGate pass in f32 in the kernel's order: key tiles of 256
    keys (lane l holds keys l + 32·i, i < 8); for each, b = 0..B−1 in
    order: dBias += gate·dS in one register per element, and dGate's part
    summed over the lane's 8 keys in order, then over the 32 lanes by the
    xor butterfly 16, 8, 4, 2, 1 (lane 0's order), then added to the row's
    strip tile after tile. Keys ≥ kv_len[b] read nothing."""
    f32 = np.float32
    n_b, n_h, _, ldk = ds.shape
    dbias = np.zeros((n_h, t, t), f32)
    dgate = np.zeros((n_b, n_h, t), f32)
    lanes = np.arange(32)
    for k0 in range(0, t, 256):
        keys = k0 + lanes[:, None] + 32 * np.arange(8)[None, :]   # [32, 8]
        inside = keys < t
        bv = np.where(inside, bias[:, :, np.minimum(keys, t - 1)], f32(0))
        acc = np.zeros(bv.shape, f32)
        for b in range(n_b):
            valid = keys < kv_len[b]
            d = np.where(valid, ds[b][:, :t, np.minimum(keys, ldk - 1)],
                         f32(0))
            acc = acc + gate[b][:, :, None, None] * d
            part = np.zeros(d.shape[:-1], f32)
            for i in range(8):
                part = part + bv[..., i] * d[..., i]
            for o in (16, 8, 4, 2, 1):
                part = part + part[..., lanes ^ o]
            dgate[b] = dgate[b] + part[..., 0]
        dbias[:, :, keys[inside]] = acc[..., inside]
    return dbias, dgate


def test_dbias_dgate_reduction_order():
    """The dBias/dGate pass's reduction order in f32 is within 1e-6 × max
    of the f64 sums dBias = Σ_b gate·dS, dGate = Σ_k bias·dS, at a T that
    is no multiple of the key tile, with the workspace's never-written
    columns (whole 64-key tiles past kv_len) filled with NaN and the
    masked keys of written tiles 0, as the dK/dV pass leaves them."""
    rng = np.random.RandomState(6)
    n_b, n_h, t = 8, 2, 300
    ldk = -(-t // 64) * 64
    kv_len = np.array([300, 299, 257, 256, 200, 130, 64, 1])
    ds = rng.randn(n_b, n_h, t, ldk).astype(np.float32)
    for b, kv in enumerate(kv_len):
        ds[b, :, :, kv:] = 0.0
        ds[b, :, :, -(-kv // 64) * 64:] = np.nan
    bias = rng.randn(n_h, t, t).astype(np.float32)
    gate = (rng.rand(n_b, n_h, t) + 0.5).astype(np.float32)
    dbias, dgate = dbias_dgate_emulated(ds, bias, gate, kv_len, t)
    d64 = np.nan_to_num(ds[..., :t].astype(np.float64))
    want_bias = (gate.astype(np.float64)[..., None] * d64).sum(0)
    want_gate = (bias.astype(np.float64)[None] * d64).sum(-1)
    for got, want in ((dbias, want_bias), (dgate, want_gate)):
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("t,rate", [(130, 0.0), (200, 0.0), (130, 0.1),
                                    (200, 0.15)])
def test_gated_backward_d64_matches_jax_vjp(t, rate):
    """At head_dim 64, the width of the mma passes with a bias: dq, dk, dv,
    dbias and dgate of ``flash_attention`` with bias, gate and ragged key
    lengths, with and without dropout, through autograd on the CPU (the
    plain twin the card's kernels are held against) = jax.vjp of the JAX
    entry point (its K2b Pallas kernels in interpret mode, the same int32
    seed), ≤ 1e-5 absolute in f32."""
    rng = np.random.RandomState(t + int(rate * 100))
    b, h, d = 2, 2, 64
    q, k, v = [(rng.randn(b, h, t, d) * 0.5).astype(np.float32)
               for _ in range(3)]
    bias = (rng.randn(h, t, t) * 0.5).astype(np.float32)
    gate = (rng.rand(b, h, t) + 0.5).astype(np.float32)
    kv_len = np.array([t, t - 37], np.int32)
    dout = rng.randn(b, h, t, d).astype(np.float32)
    seed = int(rng.randint(-2 ** 31, 2 ** 31 - 1))
    jseed = jnp.int32(seed) if rate else None

    def jfn(*xs):
        return jax_fa(*xs, jnp.asarray(kv_len), dropout_rate=rate,
                      dropout_seed=jseed)
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v, bias, gate)))
    want = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(x).requires_grad_()
              for x in (q, k, v, bias, gate)]
    out = flash_attention.flash_attention(
        *leaves, kv_len=torch.from_numpy(kv_len), dropout_rate=rate,
        dropout_seed=seed if rate else None)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, g, w in zip(("dq", "dk", "dv", "dbias", "dgate"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_bias_launcher_needs_cuda_tensors():
    """The mma passes with a bias are not replaced by the plain twin: the
    launcher raises on CPU tensors with a bias at head_dim 64 and counts
    no launch of any route."""
    reset_launch_counts()
    x = torch.randn(1, 2, 8, 64)
    bias, gate = torch.randn(2, 8, 8), torch.rand(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.launch_backward(x, x, x, bias, gate, None, x,
                                        torch.zeros(1, 2, 8), x)
    assert flash_attention.mma_bias_bwd_launches == 0
    assert flash_attention.mma_bwd_launches == 0
    assert flash_attention.fma_bwd_launches == 0


@pytest.mark.parametrize("err", [0, 2])
@pytest.mark.parametrize("with_gate", [True, False])
def test_mma_bias_passes_counted_where_they_launch(monkeypatch, err,
                                                   with_gate):
    """``mma_bias_bwd_launches`` rises in the branch of the mma passes with
    a bias, after the library of ``attention_bwd_bias_mma.cu`` ran its
    launcher with no error: once a call, not when the launch failed, and
    the other routes' counts never move there. The launcher gets 26
    arguments, a null dgate without gate. (A stand-in library takes the
    launch on the CPU.)"""
    from wfl_asr_tpu_torch.ops.kernels import _build
    libs, calls = [], []

    class Launcher:
        def __call__(self, *args):
            calls.append(args)
            return err

    class Library:
        def __getattr__(self, name):
            if name == "wfl_error_string":
                return lambda code: b"invalid argument"
            return Launcher()
    monkeypatch.setattr(_build, "library",
                        lambda name: libs.append(name) or Library())
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    reset_launch_counts()
    x = torch.randn(2, 3, 70, 64)
    bias = torch.randn(3, 70, 70)
    gate = torch.rand(2, 3, 70) if with_gate else None
    lse = delta = torch.zeros(2, 3, 70)
    kv = torch.tensor([70, 33], dtype=torch.int32)
    args = (x, x, x, bias, gate, x, lse, delta, kv, None, 0, 1.0)
    if err:
        with pytest.raises(_build.KernelBuildError, match="invalid"):
            flash_attention._launch_mma_bias(*args)
    else:
        dq, dk, dv, dbias, dgate = flash_attention._launch_mma_bias(*args)
        assert dq.shape == dk.shape == dv.shape == x.shape
        assert dbias.shape == (3, 70, 70) and dbias.dtype == torch.float32
        assert (dgate.shape == (2, 3, 70)) if with_gate else dgate is None
    assert libs == ["attention_bwd_bias_mma"] and len(calls) == 1
    assert len(calls[0]) == 26
    assert (calls[0][4] is None) == (calls[0][15] is None) == (not with_gate)
    assert calls[0][16:21] == (2, 3, 70, 64, 128)        # B, H, T, D, ldk
    assert flash_attention.mma_bias_bwd_launches == (0 if err else 1)
    assert flash_attention.mma_bwd_launches == 0
    assert flash_attention.fma_bwd_launches == 0


@pytest.mark.parametrize("err", [0, 2])
@pytest.mark.parametrize("d", [64, 48])
def test_mma64_passes_counted_where_they_launch(monkeypatch, err, d):
    """``mma64_bwd_launches`` rises in the bias-free D = 64 branch, after
    the launcher of ``attention_bwd_bias_mma.cu`` returned no error: once a
    call, not when the launch failed, and no other route's count moves.
    The launcher gets null bias, gate, dBias and dGate pointers, head_dim
    64 (narrower inputs zero-padded to it) and a workspace row of 64; the
    gradients come back at the caller's width. (A stand-in library takes
    the launch on the CPU.)"""
    from wfl_asr_tpu_torch.ops.kernels import _build
    libs, calls = [], []

    class Library:
        def __getattr__(self, name):
            if name == "wfl_error_string":
                return lambda code: b"invalid argument"
            assert name == "wfl_attention_bwd_bias_mma"
            return lambda *args: calls.append(args) or err
    monkeypatch.setattr(_build, "library",
                        lambda name: libs.append(name) or Library())
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    reset_launch_counts()
    x = torch.randn(2, 3, 60, d)
    lse = delta = torch.zeros(2, 3, 60)
    kv = torch.tensor([60, 33], dtype=torch.int32)
    args = (x, x, x, x, lse, delta, kv, None, 0, 1.0)
    if err:
        with pytest.raises(_build.KernelBuildError, match="invalid"):
            flash_attention._launch_mma64(*args)
    else:
        grads = flash_attention._launch_mma64(*args)
        assert [g.shape for g in grads] == [x.shape] * 3
    assert libs == ["attention_bwd_bias_mma"] and len(calls) == 1
    a = calls[0]
    assert len(a) == 26
    assert a[3] is None and a[4] is None and a[14] is None and a[15] is None
    assert a[16:21] == (2, 3, 60, 64, 64)        # B, H, T, D, ldk
    assert flash_attention.mma64_bwd_launches == (0 if err else 1)
    assert flash_attention.mma_bias_bwd_launches == 0
    assert flash_attention.mma_bwd_launches == 0
    assert flash_attention.fma_bwd_launches == 0
