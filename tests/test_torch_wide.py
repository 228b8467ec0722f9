"""Attention above head_dim 512 (the ``"wide"`` route: the column-split
forward and backward of ``csrc/attention_wide.cu``) on the CPU: the entry
points against the JAX kernels (interpret mode) at widths 528, 640 and 1280
with ragged key lengths, bias-free and with bias and gate, with strict
dropout at 640; a Conformer block at large-v3's head shape (dim 1280, 2
heads) against the JAX block; the kernel's tile table at D = 1280; what its
launcher refuses; where its launch counters rise.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against the plain twins there."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wfl_asr_tpu.models import heads as JH
from wfl_asr_tpu.ops.pallas.dropout_mask import seed_arr
from wfl_asr_tpu.ops.pallas.flash_attention import _fwd_impl as jax_fwd_bias
from wfl_asr_tpu.ops.pallas.flash_attention import flash_attention as jax_fa
from wfl_asr_tpu.ops.pallas.flash_attention_bwd import _fwd_impl, \
    flash_attention_trainable as jax_fat
from wfl_asr_tpu_torch.models import heads as PH
from wfl_asr_tpu_torch.models.convert import export_tagger
from wfl_asr_tpu_torch.ops.kernels import _build, flash_attention, \
    flash_attention_bwd, reset_launch_counts

ATTN_TOL = 1e-5                     # forward and LSE; gradients × max|grad|
MODULE_TOL = 1e-4                   # the Conformer block (a few 1e-6 of drift)
SM_SMEM = 233472                    # shared memory of a Hopper SM
BLOCK_RESERVED = 1024               # reserved by the system per block
SOURCE = (Path(flash_attention.__file__).parent / "csrc"
          / "attention_wide.cu")


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(seed, b, h, t, d):
    rng = np.random.RandomState(seed)
    q, k, v, dout = ((rng.randn(b, h, t, d) * 0.5).astype(np.float32)
                     for _ in range(4))
    bias = (rng.randn(h, t, t) * 0.3).astype(np.float32)
    gate = (rng.rand(b, h, t) + 0.5).astype(np.float32)
    return q, k, v, dout, bias, gate


def _close_grads(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), w,
                                   atol=ATTN_TOL * np.abs(w).max(), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("d", [528, 640, 1280])
def test_wide_route(d):
    """Above 512, with or without a bias, both directions take the wide
    route."""
    for has_bias in (False, True):
        assert flash_attention.forward_route(d, has_bias) == "wide"
        assert flash_attention.backward_route(d, has_bias) == "wide"


@pytest.mark.parametrize("d", [528, 640, 1280])
def test_trainable_wide_matches_jax(d):
    """``flash_attention_trainable`` at [2, 2, 40, d], key lengths (40, 23):
    forward and dq, dk, dv through autograd against jax.vjp of the Pallas
    kernel, and the plain twin's row LSE against the JAX forward's, within
    1e-5 (gradients 1e-5 × max|grad|)."""
    b, h, t = 2, 2, 40
    q, k, v, dout, _, _ = _inputs(d, b, h, t, d)
    kv = np.array([t, 23], np.int32)

    def jfn(q_, k_, v_):
        return jax_fat(q_, k_, v_, jnp.asarray(kv))
    want_out, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    _, want_lse = _fwd_impl(*map(jnp.asarray, (q, k, v)), jnp.asarray(kv),
                            seed_arr(None), 128, 128, 0.0)

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention_bwd.flash_attention_trainable(*leaves,
                                                        torch.from_numpy(kv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ATTN_TOL, rtol=0)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    _close_grads(got, want, ("dq", "dk", "dv"))
    _, lse = flash_attention.attention_plain(
        *map(torch.from_numpy, (q, k, v)), kv_len=torch.from_numpy(kv),
        return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=ATTN_TOL, rtol=0)


@pytest.mark.parametrize("with_gate", [True, False])
def test_gated_wide_matches_jax(with_gate):
    """``flash_attention`` with a bias (and a gate) at [2, 2, 40, 640], key
    lengths (40, 23): forward, LSE and dq, dk, dv, dbias (and dgate)
    against the JAX kernel, as above."""
    b, h, t, d = 2, 2, 40, 640
    q, k, v, dout, bias, gate = _inputs(7 + with_gate, b, h, t, d)
    gate = gate if with_gate else None
    kv = np.array([t, 23], np.int32)
    diff = [x for x in (q, k, v, bias, gate) if x is not None]

    def jfn(q_, k_, v_, bias_, *g):
        return jax_fa(q_, k_, v_, bias=bias_, gate=g[0] if g else None,
                      kv_len=jnp.asarray(kv))
    want_out, vjp = jax.vjp(jfn, *map(jnp.asarray, diff))
    want = vjp(jnp.asarray(dout))
    _, want_lse = jax_fwd_bias(
        *map(jnp.asarray, (q, k, v, bias)),
        None if gate is None else jnp.asarray(gate), jnp.asarray(kv),
        seed_arr(None), 128, 128, True, 0.0)

    leaves = [torch.from_numpy(x).requires_grad_() for x in diff]
    out = flash_attention.flash_attention(
        *leaves[:4], gate=leaves[4] if with_gate else None,
        kv_len=torch.from_numpy(kv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ATTN_TOL, rtol=0)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    _close_grads(got, want, ("dq", "dk", "dv", "dbias", "dgate"))
    _, lse = flash_attention.attention_plain(
        *map(torch.from_numpy, (q, k, v, bias)),
        None if gate is None else torch.from_numpy(gate),
        torch.from_numpy(kv), return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=ATTN_TOL, rtol=0)


def test_wide_dropout_matches_jax():
    """Strict attention dropout (K6) at [2, 2, 40, 640], rate 0.1, one
    seed, ragged key lengths: forward and dq, dk, dv of
    ``flash_attention_trainable`` against the JAX kernel's, whose hash mask
    the plain twins reproduce bit for bit."""
    b, h, t, d, rate, seed = 2, 2, 40, 640, 0.1, -123457
    q, k, v, dout, _, _ = _inputs(11, b, h, t, d)
    kv = np.array([t, 29], np.int32)

    def jfn(q_, k_, v_):
        return jax_fat(q_, k_, v_, jnp.asarray(kv), dropout_rate=rate,
                       dropout_seed=jnp.int32(seed))
    want_out, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention_bwd.flash_attention_trainable(
        *leaves, torch.from_numpy(kv), dropout_rate=rate,
        dropout_seed=torch.tensor([seed], dtype=torch.int32))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ATTN_TOL, rtol=0)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    _close_grads(got, want, ("dq", "dk", "dv"))


def _conformer_state_dict(params, state):
    """The port's ``ConformerBlock`` weights of one JAX block, through the
    tagger's converter (the other heads' entries are placeholders, dropped
    again)."""
    lin = {"w": np.zeros((1, 1), np.float32)}
    stub = {"lang": {"proj": lin, "emb": lin}, "classifier": lin,
            "offset_head": {"conv1": lin, "conv2": lin},
            "conformer": [params]}
    pre = "conformer_layers.0."
    return {k[len(pre):]: torch.from_numpy(np.array(v, copy=True))
            for k, v in export_tagger(stub, {"conformer": [state]},
                                      "none").items()
            if k.startswith(pre)}


def test_conformer_block_large_v3_heads():
    """A Conformer block at large-v3's head shape (dim 1280, 2 heads, so
    attention at head_dim 640; the default expansion 2 and kernel 31), B =
    2, T = 24 with frame lengths (24, 15), in eval: the port's block
    against the JAX block with its Pallas attention (interpret mode),
    within 1e-4 on the valid frames."""
    dim, heads, exp, kern, t = 1280, 2, 2, 31, 24
    params, state = JH.init_conformer_block(jax.random.PRNGKey(5), dim,
                                            heads, exp, kern)
    rng = np.random.RandomState(6)
    x = rng.randn(2, t, dim).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([t, 15])[:, None]
    ref, _ = JH.conformer_block(params, state, jnp.asarray(x), heads, kern,
                                0.0, None, deterministic=True, train=False,
                                mask=jnp.asarray(mask), use_flash=True)
    block = PH.ConformerBlock(dim, heads, exp, kern).eval()
    block.load_state_dict(_conformer_state_dict(params, state), strict=True)
    with torch.no_grad():
        out = block(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    ref = np.asarray(ref)
    for i, n in enumerate((t, 15)):
        np.testing.assert_allclose(out[i, :n], ref[i, :n], atol=MODULE_TOL,
                                   rtol=0)


def _source_ints(pattern: str) -> tuple:
    """The integers that ``pattern``'s groups match in the kernel's
    source, so that the mirror below cannot drift from it."""
    return tuple(int(g) for g in re.search(pattern, SOURCE.read_text())
                 .groups())


def wide_tiles(d: int, f32: bool) -> dict:
    """Mirror of ``WideTiles`` and the grids of ``csrc/attention_wide.cu``
    at head_dim ``d``, with the chunk, column block and tile sizes read out
    of the source: the column blocks, the D chunks of a score product, the
    output columns of the last block, and each pass's shared memory in
    bytes."""
    es = 4 if f32 else 2
    (dc,) = _source_ints(r"constexpr int kDC = (\d+);")
    (cb,) = _source_ints(r"constexpr int kCB = (\d+);")
    fbq, fbk = _source_ints(r"constexpr int kFwdBQ = (\d+), kFwdBK = (\d+);")
    kbk, kbq = _source_ints(r"constexpr int kKvBK = (\d+), kKvBQ = (\d+);")
    qbq, qbk = _source_ints(r"constexpr int kDqBQ = (\d+), kDqBK = (\d+);")

    def pitch(cols):                    # attention_mma.cuh
        return (cols + 31) // 32 * 32 + 8 if f32 else cols + 8

    def pitch_s(cols):
        return (cols + 31) // 32 * 32 if f32 else cols + 8
    pc, pv = pitch(dc), pitch(cb)
    fwd = (es * ((fbq + fbk) * pc + fbk * pv
                 + fbq * pitch_s(2 * fbk if f32 else fbk))
           + 4 * (fbq * (fbk + 4) + 2 * fbq))
    dkdv = (es * (2 * (kbk + kbq) * pc + 2 * kbq * pv + 2 * kbk * pitch_s(kbq))
            + 4 * 2 * kbq)
    dq = es * (qbq * pitch_s(qbk) + qbk * pv)
    return dict(col_blocks=-(-d // cb), chunks=-(-d // dc),
                last_cols=d - (-(-d // cb) - 1) * cb, cb=cb, dc=dc,
                fwd_smem=fwd, dkdv_smem=dkdv, dq_smem=dq)


@pytest.mark.parametrize("f32", [True, False])
def test_wide_tiles_fit_shared_memory(f32):
    """At D = 1280 (large-v3's Conformer at 2 heads is 640, the widest
    preset's whole d_model 1280): every pass's tiles leave room for two
    blocks a SM (228 KB, 1 KB reserved each), as its launch bounds ask;
    the column blocks cover D in whole 16-column steps; the last block of
    an odd width (528) keeps a multiple of 16 columns. Nothing in the
    table depends on D."""
    t = wide_tiles(1280, f32)
    for key in ("fwd_smem", "dkdv_smem", "dq_smem"):
        assert 2 * (t[key] + BLOCK_RESERVED) <= SM_SMEM, (key, t)
    assert (t["col_blocks"], t["chunks"]) == (10, 20)
    assert t["cb"] % 16 == 0 and t["dc"] % 16 == 0
    assert wide_tiles(528, f32)["last_cols"] == 16
    assert {k: v for k, v in wide_tiles(640, f32).items()
            if k.endswith("smem")} == \
        {k: v for k, v in t.items() if k.endswith("smem")}


def test_wide_launcher_refuses_what_the_route_does_not_send():
    """The launchers refuse a head_dim of 512 or less (the route never sends
    one), widths that are no multiple of 16 and a gate without a bias; the
    backward refuses a workspace row that is no multiple of 64."""
    text = SOURCE.read_text()
    assert "return D <= kMinD || D % 16 != 0 || (bias == nullptr && gate " \
        "!= nullptr);" in text
    assert _source_ints(r"constexpr int kMinD = (\d+);") == \
        (flash_attention.WIDE_MIN_D,)
    assert "if (ldk % kLdk != 0 || ldk < T_len) return " \
        "cudaErrorInvalidValue;" in text
    assert _source_ints(r"constexpr int kLdk = (\d+);") == (64,)


class _Library:
    """A stand-in kernel library that takes every launch on the CPU and
    records it."""

    def __init__(self, calls, err):
        self.calls, self.err = calls, err

    def __getattr__(self, name):
        if name == "wfl_error_string":
            return lambda code: b"invalid argument"

        def launcher(*args):
            self.calls.append((name, args))
            return self.err
        return launcher


@pytest.mark.parametrize("err", [0, 2])
@pytest.mark.parametrize("bias_mode", ["none", "bias", "bias+gate"])
def test_wide_counted_where_it_launches(monkeypatch, err, bias_mode):
    """``wide_fwd_launches`` and ``wide_bwd_launches`` rise in the wide
    branches, after the launcher of ``attention_wide.cu`` returned no
    error: once a call, not when a launch failed, and no other route's
    count moves. With a bias the backward then runs the dBias/dGate pass of
    ``attention_bwd_bias_mma.cu`` on the same workspace. (A stand-in
    library takes the launches on the CPU.)"""
    libs, calls = [], []
    monkeypatch.setattr(_build, "library", lambda name: libs.append(name)
                        or _Library(calls, err))
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    reset_launch_counts()
    x = torch.randn(2, 3, 45, 640)
    bias = torch.randn(3, 45, 45) if bias_mode != "none" else None
    gate = torch.rand(2, 3, 45) if bias_mode == "bias+gate" else None
    kv = torch.tensor([45, 20], dtype=torch.int32)
    lse = delta = torch.zeros(2, 3, 45)
    fwd = (x, x, x, bias, gate, kv, lse, None, 0, 1.0)
    bwd = (x, x, x, bias, gate, x, lse, delta, kv, None, 0, 1.0)
    if err:
        with pytest.raises(_build.KernelBuildError, match="invalid"):
            flash_attention._launch_wide_fwd(*fwd)
        with pytest.raises(_build.KernelBuildError, match="invalid"):
            flash_attention._launch_wide(*bwd)
    else:
        out = flash_attention._launch_wide_fwd(*fwd)
        assert out.shape == x.shape
        dq, dk, dv, dbias, dgate = flash_attention._launch_wide(*bwd)
        assert dq.shape == dk.shape == dv.shape == x.shape
        assert (dbias is None) == (bias is None)
        assert (dgate is None) == (gate is None)
    names = [n for n, _ in calls]
    want = ["wfl_attention_wide_fwd", "wfl_attention_wide_bwd"]
    if bias is not None and not err:
        want.append("wfl_attention_bias_dbias")
    assert names == want
    assert libs == ["attention_wide"] * 2 + (
        ["attention_bwd_bias_mma"] if len(want) == 3 else [])
    fargs, bargs = calls[0][1], calls[1][1]
    assert len(fargs) == 18 and fargs[9:13] == (2, 3, 45, 640)
    assert (fargs[3] is None) == (bias is None)
    assert len(bargs) == 24 and bargs[14:19] == (2, 3, 45, 640, 64)
    if len(want) == 3:
        dargs = calls[2][1]
        assert dargs[0] == bargs[13]                 # the same workspace
        assert dargs[6:10] == (2, 3, 45, 64)
    assert flash_attention.wide_fwd_launches == (0 if err else 1)
    assert flash_attention.wide_bwd_launches == (0 if err else 1)
    for other in ("mma_fwd_launches", "mma_bias_fwd_launches",
                  "mma64_fwd_launches", "fused_fwd_launches",
                  "mma_bwd_launches", "mma_bias_bwd_launches",
                  "mma64_bwd_launches", "fma_bwd_launches"):
        assert getattr(flash_attention, other) == 0, other
