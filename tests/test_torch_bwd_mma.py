"""The bias-free tensor-core attention backward (``csrc/attention_bwd_mma.cu``,
K1b at head_dim > 128) on the CPU: which calls take it, that its tiles fit
a Hopper block, why its f32 operands are split three ways (a numpy
emulation of TF32 rounding), and the plain twin it is held against on the
card, against ``jax.vjp`` of the JAX entry point at widths it takes.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against the plain twin there."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wfl_asr_tpu.ops.pallas.flash_attention_bwd import \
    flash_attention_trainable as jax_fat
from wfl_asr_tpu_torch.ops.kernels import flash_attention, \
    flash_attention_bwd, reset_launch_counts

# chip_smoke.GRAD_TOL["f32"]: the backward kernels' f32 tolerance on the
# card, × the gradient's largest magnitude
GRAD_TOL_F32 = 1e-4
WIDTHS = range(144, 513, 16)        # every head_dim the mma pair takes
SMEM_LIMIT = 232448                 # shared memory a Hopper block may use


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("has_bias", [False, True])
@pytest.mark.parametrize("d", [64, 128, 144, 384, 512])
def test_backward_route(d, has_bias):
    """Bias-free above head_dim 128 → the mma pair; with a bias at head_dim
    64 → the mma passes with a bias (attention_bwd_bias_mma.cu), bias-free
    at 64 and at 128 their bias-free instantiations; every other call with
    a bias → the FMA pair."""
    if has_bias:
        want = "mma_bias" if d == 64 else "fma"
    else:
        want = "mma" if d > 128 else "mma64" if d == 64 else "mma128"
    assert flash_attention.backward_route(d, has_bias) == want


def mma_bwd_tiles(d: int, f32: bool) -> dict:
    """Mirror of ``Tiles`` in ``csrc/attention_bwd_mma.cu`` for head_dim
    ``d``: the column group ``npw`` (8-column tiles each of the 16 warps
    owns at most), the dK/dV pass's (keys a block, queries a streamed tile),
    the dQ pass's (queries a block, keys of K and dS a streamed tile, in two
    buffers), the buffers of the dK/dV pass's streamed tile, and the shared
    memory of each pass in bytes."""
    npw = 4 if d <= 256 else 6 if d <= 384 else 8
    w = 16 if f32 else 32               # rows of a streamed tile
    nbuf = 1 if f32 and npw > 6 else 2
    es = 4 if f32 else 2

    def round32(cols):
        return (cols + 31) // 32 * 32
    # D-wide rows pitched for the group's widest D (f32: 8 floats over a
    # multiple of 32, with room for the 4-float row shift)
    p = round32(64 * npw) + 8 if f32 else 64 * npw + 8

    def pitch_s(cols):
        return round32(cols) if f32 else cols + 8
    subs = 2 * w // 16                  # 16×16 score sub-tiles a product
    part = 4 * 2 * subs * (8 // subs) * 256         # partial sums
    dkdv = (es * (2 * 32 * p + 2 * nbuf * w * p + 2 * 32 * pitch_s(w))
            + 4 * 2 * nbuf * w + part)
    dq = es * 2 * (32 * p + 64 * pitch_s(32))
    return dict(npw=npw, dkdv=(32, w), dq=(64, 32), nbuf=nbuf,
                dkdv_smem=dkdv, dq_smem=dq)


@pytest.mark.parametrize("f32", [True, False])
def test_mma_tiles_fit_shared_memory(f32):
    """The mirror of the kernel's tile table: for every width it takes, both
    passes stay within a Hopper block's 227 KB, the warps' column slices
    (8 × npw 8-column tiles) cover D, and the dK/dV accumulators (2 × npw ×
    4 f32 a thread) take at most half of the 128 registers a thread of a
    512-thread block may have."""
    for d in WIDTHS:
        t = mma_bwd_tiles(d, f32)
        assert t["dkdv_smem"] <= SMEM_LIMIT, (d, t)
        assert t["dq_smem"] <= SMEM_LIMIT, (d, t)
        assert 8 * t["npw"] * 8 >= d
        assert 2 * t["npw"] * 4 <= 64
    main = mma_bwd_tiles(384, f32)
    rows = 16 if f32 else 32
    assert main["dkdv"] == (32, rows) and main["dq"] == (64, 32)
    assert main["nbuf"] == 2
    assert mma_bwd_tiles(512, f32)["nbuf"] == (1 if f32 else 2)


def _tf32(x: np.ndarray, nearest: bool = True) -> np.ndarray:
    """f32 to TF32 (10-bit mantissa): to nearest, ties away from zero (the
    kernel's integer rounding of hi), or toward zero (what the tensor core
    reads of an f32 bit pattern, the kernel's lo)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if nearest:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("m,k,n", [(64, 384, 64),      # S = Q·Kᵀ at D = 384
                                   (64, 1499, 384)])   # dQ = dS·K at T = 1499
def test_three_way_tf32_split_keeps_f32_accuracy(m, k, n):
    """a·b ≈ lo·hi + hi·lo + hi·hi with hi = tf32(a) to nearest and lo =
    a − hi read as TF32 toward zero (the kernel's PolF32::split; sums in
    f64) is within 1e-6 × max of the f64 product; a single TF32 product is
    not within the f32 backward tolerance of 1e-4 × max — the reason the
    f32 kernels split their operands."""
    rng = np.random.RandomState(m + k + n)
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()

    def split(x):
        hi = _tf32(x)
        return (hi.astype(np.float64),
                _tf32(x - hi, nearest=False).astype(np.float64))
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    three = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    single = a_hi @ b_hi
    assert np.abs(three - exact).max() <= 1e-6 * scale
    assert np.abs(single - exact).max() > GRAD_TOL_F32 * scale


@pytest.mark.parametrize("t,d,with_kv", [(130, 144, True), (130, 144, False),
                                         (64, 384, True)])
def test_mma_width_backward_matches_jax_vjp(t, d, with_kv):
    """At widths the mma pair takes: dq, dk, dv of
    ``flash_attention_trainable`` through autograd on the CPU (the plain
    twin the card's kernels are held against) = jax.vjp of the JAX entry
    point (its K1b Pallas kernels in interpret mode), ≤ 1e-5."""
    rng = np.random.RandomState(t + d)
    b, h = 2, 2
    q, k, v = [(rng.randn(b, h, t, d) * 0.5).astype(np.float32)
               for _ in range(3)]
    dout = rng.randn(b, h, t, d).astype(np.float32)
    kv_len = np.array([t, t - 37], np.int32) if with_kv else None
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    _, vjp = jax.vjp(lambda *xs: jax_fat(*xs, jkv),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention_bwd.flash_attention_trainable(
        *leaves, None if kv_len is None else torch.from_numpy(kv_len))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_mma_launcher_needs_cuda_tensors():
    """Neither pair is replaced by the plain twin: the launcher raises on
    CPU tensors at a width of the mma pair and at one of the FMA pair, and
    counts no launch."""
    reset_launch_counts()
    lse = torch.zeros(1, 2, 8)
    for d in (144, 64):
        x = torch.randn(1, 2, 8, d)
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention.launch_backward(x, x, x, None, None, None, x, lse,
                                            x)
    assert flash_attention.mma_bwd_launches == 0
    assert flash_attention.fma_bwd_launches == 0


def test_cpu_backward_counts_no_pair_launch():
    """The CPU autograd path at a width the mma pair takes runs the plain
    twin: neither backward pair's count moves."""
    reset_launch_counts()
    x = torch.randn(1, 2, 8, 144, requires_grad=True)
    flash_attention_bwd.flash_attention_trainable(x, x, x).sum().backward()
    assert flash_attention.mma_bwd_launches == 0
    assert flash_attention.fma_bwd_launches == 0
    assert flash_attention_bwd.bwd_launches == 0


@pytest.mark.parametrize("err", [0, 2])
def test_mma_pair_counted_where_it_launches(monkeypatch, err):
    """``mma_bwd_launches`` rises in the mma branch, after the library of
    ``attention_bwd_mma.cu`` ran its launcher with no error: once a call,
    not when the launch failed, and the FMA count never moves there. (A
    stand-in library takes the launch on the CPU.)"""
    from wfl_asr_tpu_torch.ops.kernels import _build
    libs, calls = [], []

    class Launcher:
        def __call__(self, *args):
            calls.append(len(args))
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
    x = torch.randn(1, 2, 40, 144)
    lse = delta = torch.zeros(1, 2, 40)
    kv = torch.tensor([40], dtype=torch.int32)
    if err:
        with pytest.raises(_build.KernelBuildError, match="invalid"):
            flash_attention._launch_mma(x, x, x, x, lse, delta, kv, None, 0,
                                        1.0)
    else:
        dq, dk, dv = flash_attention._launch_mma(x, x, x, x, lse, delta, kv,
                                                 None, 0, 1.0)
        assert dq.shape == dk.shape == dv.shape == x.shape
    assert libs == ["attention_bwd_mma"] and calls == [22]
    assert flash_attention.mma_bwd_launches == (0 if err else 1)
    assert flash_attention.fma_bwd_launches == 0


def test_train_step_ab_batch_and_refusal():
    """``train_step_ab.py``'s batch has the fields and shapes of a
    collated training batch at 8 × 29 s, and the script refuses to run,
    printing no result, where there is no CUDA device."""
    import os
    import subprocess
    import sys
    from wfl_asr_tpu_torch.train.loop import BATCH_KEYS
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import train_step_ab
    finally:
        sys.path.remove(repo)
    batch = train_step_ab.make_batch()
    assert set(BATCH_KEYS) <= set(batch)
    assert batch["audio"].shape == (8, 464000)
    assert batch["labels"].shape == (8, batch["max_label_len"]) == (8, 1450)
    valid = (batch["labels"] >= 0).sum(1)
    assert valid[0] == 1449 and valid.min() >= 999
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "train_step_ab.py", "--one", "."],
                         cwd=repo, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
