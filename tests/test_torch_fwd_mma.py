"""The bias-free tensor-core attention forward (``csrc/attention_fwd_mma.cu``,
K1 at head_dim > 128) on the CPU: which calls take it, that its tiles fit a
Hopper block at every width it takes, the plain twin it is held against on
the card against the JAX kernel's forward and LSE at widths it takes (with
ragged key lengths and dropout), and where its launch counter rises.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain twin there."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wfl_asr_tpu.ops.pallas.dropout_mask import seed_arr
from wfl_asr_tpu.ops.pallas.flash_attention_bwd import _fwd_impl, \
    flash_attention_trainable as jax_fat
from wfl_asr_tpu_torch.ops.kernels import _build, flash_attention, \
    flash_attention_bwd, reset_launch_counts

WIDTHS = range(144, 513, 16)        # every head_dim the mma forward takes
BLOCK_SMEM = 232448                 # shared memory a Hopper block may use
SOURCE = (Path(flash_attention.__file__).parent / "csrc"
          / "attention_fwd_mma.cu")


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("has_bias", [False, True])
@pytest.mark.parametrize("d", [64, 128, 144, 384, 512])
def test_forward_route(d, has_bias):
    """Bias-free above head_dim 128 → the mma.sync forward; with a bias at
    head_dim 64 → the mma.sync forward with a bias, and bias-free at 64 and
    at 128 its bias-free instantiations (tests/test_torch_fwd_bias_mma.py,
    tests/test_torch_mma128.py); every other call with a bias → the
    forwards of flash_attention.cu. The bias-free widths of the mma forward are those of
    the mma backward pair, so a call's LSE and its gradients come from one
    design."""
    if has_bias:
        want = "mma_bias" if d == 64 else "fused"
    else:
        want = "mma" if d > 128 else "mma64" if d == 64 else "mma128"
    assert flash_attention.forward_route(d, has_bias) == want
    if want == "mma":
        assert flash_attention.backward_route(d, has_bias) == "mma"


def _source_ints(pattern: str) -> tuple:
    """The integers that ``pattern``'s groups match in the kernel's
    source, so that the mirror below cannot drift from it."""
    return tuple(int(g) for g in re.search(pattern, SOURCE.read_text())
                 .groups())


def fwd_tiles(d: int, f32: bool) -> dict:
    """Mirror of ``FwdTiles`` and the launcher's column groups in
    ``csrc/attention_fwd_mma.cu`` for head_dim ``d``, with the warps, the
    query tile, the per-dtype key tile and the groups read out of the
    source: the group ``npw`` (8-column tiles each warp owns at most), the
    key tile, its buffers, and the shared memory of a block in bytes."""
    es = 4 if f32 else 2
    (warps,) = _source_ints(r"constexpr int kWarps = (\d+);")
    (bq,) = _source_ints(r"constexpr int kBQ = (\d+);")
    bk = _source_ints(r"int bk = kF32 \? (\d+) : (\d+);")[0 if f32 else 1]
    (npw_one_buf,) = _source_ints(r"int nbuf = kF32 && NPW > (\d+) \? 1")
    groups = re.findall(r"a\.D <= (\d+)\) WFL_FWD\((\d+)\)",
                        SOURCE.read_text())
    npw = next((int(n) for lim, n in groups if d <= int(lim)), 8)
    nbuf = 1 if f32 and npw > npw_one_buf else 2

    def round32(cols):
        return (cols + 31) // 32 * 32
    # D-wide rows (attention_mma.cuh: pitch) for the group's widest D
    p = round32(64 * npw) + 8 if f32 else 64 * npw + 8
    pp = round32(2 * bk) if f32 else bk + 8          # P (f32: hi | lo)
    subs = bq // 16 * (bk // 16)
    parts = warps // subs
    sp = bk if f32 else bk + 8                        # partial sums
    smem = (es * (bq * p + 2 * nbuf * bk * p + bq * pp)
            + 4 * (parts * bq * sp + 2 * bq))
    return dict(npw=npw, bk=bk, nbuf=nbuf, parts=parts, warps=warps,
                bq=bq, smem=smem)


@pytest.mark.parametrize("f32", [True, False])
def test_fwd_tiles_fit_shared_memory(f32):
    """For every width the forward takes, its tiles stay within a Hopper
    block's 227 KB, the warps' column slices (8 × npw 8-column tiles)
    cover D, the output accumulators (2 × npw × 4 f32 a thread) take at
    most half of the 128 registers a thread of a 512-thread block may have,
    and the score sub-tiles split evenly over the warps. At D = 384 the key
    tiles are double-buffered."""
    for d in WIDTHS:
        t = fwd_tiles(d, f32)
        assert t["smem"] <= BLOCK_SMEM, (d, t)
        assert 8 * t["npw"] * 8 >= d
        assert 2 * t["npw"] * 4 <= 64
        assert t["parts"] * (t["bq"] // 16) * (t["bk"] // 16) == t["warps"]
    main = fwd_tiles(384, f32)
    assert main["nbuf"] == 2 and main["npw"] == 6
    assert main["bk"] == (16 if f32 else 32)


def test_launcher_refuses_what_the_route_does_not_send():
    """The launcher's own refusals match :func:`forward_route`: a bias or a
    gate, and a head_dim outside (128, 512] or not a multiple of 16."""
    text = SOURCE.read_text()
    assert "if (bias != nullptr || gate != nullptr) return " \
        "cudaErrorInvalidValue;" in text
    lo, hi = _source_ints(r"D % 16 != 0 \|\| D <= (\d+) \|\| D > (\d+)\)")
    assert (lo, hi) == (flash_attention.MMA_MIN_D, 512)


def _jax_forward(q, k, v, kv_len, rate, seed):
    """JAX's forward of ``flash_attention_trainable`` (its Pallas kernel in
    interpret mode on the CPU) and the row LSE its kernel writes."""
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    drop = dict(dropout_rate=rate, dropout_seed=jnp.int32(seed)) if rate \
        else {}
    out = jax_fat(jq, jk, jv, jnp.asarray(kv_len), **drop)
    _, lse = _fwd_impl(jq, jk, jv, jnp.asarray(kv_len),
                       seed_arr(jnp.int32(seed) if rate else None), 128, 128,
                       rate)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", [144, 384])
def test_forward_and_lse_match_jax(d, rate):
    """At widths the mma forward takes, T = 130 (two query and key tiles
    of the JAX kernel, a ragged tail) and ragged key lengths: the plain twin
    the card's kernel is held against, and the entry point on the CPU, give
    the JAX kernel's output and row LSE within 1e-5, with dropout at a fixed
    seed as well."""
    rng = np.random.RandomState(d + int(rate * 100))
    b, h, t = 2, 2, 130
    q, k, v = [(rng.randn(b, h, t, d) * 0.5).astype(np.float32)
               for _ in range(3)]
    kv_len = np.array([t, t - 37], np.int32)
    seed = 1234567
    want_out, want_lse = _jax_forward(q, k, v, kv_len, rate, seed)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tkv = torch.from_numpy(kv_len)
    tseed = torch.tensor([seed], dtype=torch.int32) if rate else None
    out, lse = flash_attention.attention_plain(
        tq, tk, tv, None, None, tkv, return_lse=True, dropout_rate=rate,
        dropout_seed=tseed)
    np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)
    entry = flash_attention_bwd.flash_attention_trainable(
        tq, tk, tv, tkv, dropout_rate=rate, dropout_seed=tseed)
    np.testing.assert_allclose(entry.numpy(), want_out, atol=1e-5, rtol=0)


def test_mma_forward_launcher_needs_cuda_tensors():
    """The forward is not replaced by the plain twin: ``launch_kernel``
    raises on CPU tensors at a width of the mma forward, with and without
    the LSE, and counts no launch; the CPU entry point runs the plain twin
    and counts none either."""
    reset_launch_counts()
    x = torch.randn(1, 2, 8, 144)
    for lse in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention.launch_kernel(x, x, x, return_lse=lse)
    y = x.clone().requires_grad_()
    flash_attention_bwd.flash_attention_trainable(y, y, y).sum().backward()
    assert flash_attention.mma_fwd_launches == 0
    assert flash_attention_bwd.launches == 0


@pytest.mark.parametrize("err", [0, 2])
def test_mma_forward_counted_where_it_launches(monkeypatch, err):
    """``mma_fwd_launches`` rises in the mma branch, after the library of
    ``attention_fwd_mma.cu`` ran its launcher with no error: once a call,
    not when the launch failed. The launcher gets the forward's shared
    signature with null bias and gate, and the LSE pointer only when the
    LSE is asked for. (A stand-in library takes the launch on the CPU.)"""
    libs, calls = [], []

    class Launcher:
        def __call__(self, *args):
            calls.append(args)
            return err

    class Library:
        def __getattr__(self, name):
            if name == "wfl_error_string":
                return lambda code: b"invalid argument"
            assert name == "wfl_attention_fwd_mma"
            return Launcher()
    monkeypatch.setattr(_build, "library",
                        lambda name: libs.append(name) or Library())
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    reset_launch_counts()
    x = torch.randn(1, 2, 40, 144)
    kv = torch.tensor([40], dtype=torch.int32)
    for lse in (None, torch.zeros(1, 2, 40)):
        if err:
            with pytest.raises(_build.KernelBuildError, match="invalid"):
                flash_attention._launch_mma_fwd(x, x, x, kv, lse, None, 0,
                                                1.0)
        else:
            out = flash_attention._launch_mma_fwd(x, x, x, kv, lse, None, 0,
                                                  1.0)
            assert out.shape == x.shape
    assert libs == ["attention_fwd_mma"] * 2
    assert [len(a) for a in calls] == [18, 18]
    assert [a[3:5] for a in calls] == [(None, None)] * 2
    assert calls[0][7] is None and calls[1][7] is not None
    assert flash_attention.mma_fwd_launches == (0 if err else 2)
    assert flash_attention.mma_bwd_launches == 0
