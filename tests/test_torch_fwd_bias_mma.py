"""The gated-bias tensor-core attention forward
(``csrc/attention_fwd_bias_mma.cu``, K2 at head_dim 64) on the CPU: which
calls take it, that its tiles fit a Hopper SM twice over, the address
arithmetic of its bias staging (a numpy emulation of ``stage_spans`` at
unaligned rows and bases), the plain twin it is held against on the card
against the JAX kernel's forward and LSE (bias with and without gate,
ragged key lengths, dropout), and where its launch counter rises.

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
from wfl_asr_tpu.ops.pallas.flash_attention import _fwd_impl
from wfl_asr_tpu_torch.ops.kernels import _build, flash_attention, \
    reset_launch_counts

SM_SMEM = 233472                    # shared memory of a Hopper SM
BLOCK_SMEM = 232448                 # of it, what one block may use
BLOCK_RESERVED = 1024               # reserved by the system per block
SOURCE = (Path(flash_attention.__file__).parent / "csrc"
          / "attention_fwd_bias_mma.cu")


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("has_bias", [False, True])
def test_forward_route(has_bias):
    """Head widths from 16 to 1280 in steps of 16: above 512, with or
    without a bias → the wide forward of attention_wide.cu; with a bias, 64
    → the mma.sync forward with a bias, the others → the forwards of
    flash_attention.cu; bias-free, ≤ 64 → the bias-free instantiation of
    the D = 64 forward ("mma64"), 80-128 → its bias-free instantiation at
    D = 128 ("mma128"), above 128 → the mma.sync forward of
    attention_fwd_mma.cu. Each forward route has the backward of the same
    design ("fused" ↔ the FMA pair), so a call's LSE and its gradients
    come from one design."""
    pair = {"fused": "fma"}
    for d in range(16, 1281, 16):
        if d > 512:
            want = "wide"
        elif has_bias:
            want = "mma_bias" if d == 64 else "fused"
        else:
            want = ("mma64" if d <= 64 else "mma128" if d <= 128
                    else "mma")
        assert flash_attention.forward_route(d, has_bias) == want, d
        assert flash_attention.backward_route(d, has_bias) == \
            pair.get(want, want), d
    assert flash_attention.MMA_BIAS_D == 64
    assert flash_attention.MMA128_D == flash_attention.MMA_MIN_D == 128
    assert flash_attention.WIDE_MIN_D == 512


def _source_ints(pattern: str) -> tuple:
    """The integers that ``pattern``'s groups match in the kernel's
    source, so that the mirror below cannot drift from it."""
    return tuple(int(g) for g in re.search(pattern, SOURCE.read_text())
                 .groups())


def fwd_bias_tiles(f32: bool, bias: bool = True, wide: bool = False
                   ) -> dict:
    """Mirror of ``FwdBiasTiles`` in ``csrc/attention_fwd_bias_mma.cu``
    (with a bias, or its bias-free instantiation; ``wide``: the bias-free
    one at head width ``kD128``), with the head widths, the per-dtype warps
    and key tile, and the blocks a SM by width and dtype read out of the
    source: the query tile, the bias span's chunks and pitch, whether Q's
    fragments stay in registers, and the shared memory of a block in
    bytes."""
    es = 4 if f32 else 2
    (d,) = _source_ints(r"constexpr int kD128 = (\d+);" if wide
                        else r"constexpr int kD = (\d+);")
    f32_at64, other = _source_ints(
        r"int warps = kF32 && D == kD \? (\d+) : (\d+);")
    warps = f32_at64 if f32 and not wide else other
    bk = _source_ints(r"int bk = kF32 \? (\d+) : (\d+);")[0 if f32 else 1]
    at64, at128 = _source_ints(r"int blocks = D == kD \? (\d+) : (\d+);")
    blocks = at128 if wide else at64
    assert "bool q_regs = D == kD;" in SOURCE.read_text()
    q_regs = not wide
    bq = 16 * warps
    p = (d + 31) // 32 * 32 + 8 if f32 else d + 8   # attention_mma.cuh
    chunks = bk * es // 16 + 1          # 16-byte chunks of a bias span
    pb = chunks * 16 // es
    # Q; two buffers of K and V; with a bias two of the bias spans
    smem = es * (bq * p + 2 * 2 * bk * p + (2 * bq * pb if bias else 0))
    return dict(d=d, warps=warps, bk=bk, bq=bq, blocks=blocks,
                chunks=chunks, pb=pb, smem=smem, q_regs=q_regs)


@pytest.mark.parametrize("f32", [True, False])
def test_bias_fwd_tiles_fit_shared_memory(f32):
    """The mirror of the kernel's tile table: a block's tiles fit the 227 KB
    a block may use, and the blocks a SM the kernel is bounded for (at
    least 2) fit a SM's 228 KB with 1 KB reserved each. A bias span is 9
    chunks: 64 bf16 or 32 f32 keys and the chunk an unaligned row start
    adds."""
    t = fwd_bias_tiles(f32)
    assert t["smem"] <= BLOCK_SMEM, t
    assert t["blocks"] >= 2
    assert t["blocks"] * (t["smem"] + BLOCK_RESERVED) <= SM_SMEM, t
    assert t["chunks"] == 9
    assert (t["bk"], t["bq"]) == ((32, 64) if f32 else (64, 128))


@pytest.mark.parametrize("f32", [True, False])
def test_bias_free_fwd_tiles_fit_shared_memory(f32):
    """The bias-free instantiation's tiles: the bias spans' share of shared
    memory goes (a third in bf16, a quarter in f32), so the blocks a SM its
    launch bounds name fit with room to spare, and the registers, not
    shared memory, bound them (at least 3 blocks would fit)."""
    t, with_bias = fwd_bias_tiles(f32, bias=False), fwd_bias_tiles(f32)
    assert t["smem"] < with_bias["smem"]
    assert with_bias["smem"] - t["smem"] == \
        (4 if f32 else 2) * 2 * t["bq"] * t["pb"]
    assert 3 * (t["smem"] + BLOCK_RESERVED) <= SM_SMEM, t
    assert t["blocks"] >= 2


def test_launcher_refuses_what_the_route_does_not_send():
    """The launcher's own refusals match :func:`forward_route`: any head
    width but the two the routes send (64 with or without a bias, 128
    bias-free; the bias-free routes pad narrower widths to them), a bias at
    128, and a gate without a bias; a null bias alone is the bias-free
    forward."""
    text = SOURCE.read_text()
    assert "if ((D != kD && (D != kD128 || bias != nullptr)) ||\n" \
        "      (bias == nullptr && gate != nullptr))\n" \
        "    return cudaErrorInvalidValue;" in text
    assert _source_ints(r"constexpr int kD = (\d+);") == \
        (flash_attention.MMA_BIAS_D,)
    assert _source_ints(r"constexpr int kD128 = (\d+);") == \
        (flash_attention.MMA128_D,)
    assert flash_attention.forward_route(64, True) == "mma_bias"
    assert flash_attention.forward_route(128, True) == "fused"
    assert flash_attention.forward_route(128, False) == "mma128"


def stage_spans_emulated(mem, lo, hi, es, row_start, ld, row0, c0, n,
                         t_len, w):
    """``stage_spans`` of ``attention_mma.cuh`` on a byte image ``mem`` of
    device memory in which the matrix lies at bytes [lo, hi): the rows
    [row0, row0 + n) of the matrix that starts at byte ``row_start`` (row
    pitch ``ld`` elements), columns [c0, c0 + w), each as the 16-byte
    aligned span that covers them. Returns the staged tile [n, chunks · 16]
    bytes and each row's element offset (``span_offset`` of the row's
    start)."""
    chunks = w * es // 16 + 1
    rows = row0 + np.arange(n)
    first = row_start + (rows * ld + c0) * es
    at = (first & ~15)[:, None] + 16 * np.arange(chunks)[None, :]
    byte = at[..., None] + np.arange(16)                  # [n, chunks, 16]
    # cp.async with src-size: the bytes below hi of a chunk at or above lo;
    # plain loads: the in-bounds elements of a chunk that starts below lo
    elem_lo = byte - byte % es
    inside = (elem_lo >= lo) & (elem_lo < hi)
    whole = (at >= lo)[..., None] & (byte < hi)
    take = np.where((at >= lo)[..., None], whole, inside)
    take &= (rows < t_len)[:, None, None]
    tile = np.where(take, mem[np.clip(byte, 0, mem.size - 1)], 0)
    off = ((row_start + rows * ld * es) & 15) // es
    return tile.reshape(n, -1).astype(np.uint8), off


@pytest.mark.parametrize("f32", [True, False])
def test_bias_spans_cover_unaligned_rows(f32):
    """The bias staging's address arithmetic, emulated in numpy on an
    [H, T, T] bias at T = 203 (odd: no row but the first starts on 16
    bytes) placed at every base misalignment the dtype allows: for every
    (head, query tile, key tile), reading a staged row at its element
    offset gives bias[h, q, k] for every key below T, and rows past T are
    zero. The last rows' spans reach past the tensor's end, the first row's
    past its start when the base is unaligned; bytes outside the tensor are
    never read (they hold NaN here)."""
    es = 4 if f32 else 2
    dt = np.float32 if f32 else np.uint16
    t = fwd_bias_tiles(f32)
    bk, bq = t["bk"], t["bq"]
    n_h, t_len = 2, 203
    rng = np.random.RandomState(3)
    for mis in range(0, 16, es):
        bias = rng.randint(1, 2 ** 15, size=(n_h, t_len, t_len)).astype(dt)
        lo = 64 + mis
        raw = bias.tobytes()
        mem = np.full(lo + len(raw) + 64, 0xFF, np.uint8)   # NaN around it
        mem[lo:lo + len(raw)] = np.frombuffer(raw, np.uint8)
        hi = lo + len(raw)
        for h in range(n_h):
            row_start = lo + h * t_len * t_len * es
            for q0 in range(0, t_len, bq):
                for k0 in range(0, t_len, bk):
                    tile, off = stage_spans_emulated(
                        mem, lo, hi, es, row_start, t_len, q0, k0, bq, t_len,
                        bk)
                    el = tile.view(dt)                       # [bq, pb]
                    keys = min(bk, t_len - k0)
                    for r in range(bq):
                        got = el[r, off[r]:off[r] + keys]
                        if q0 + r < t_len:
                            want = bias[h, q0 + r, k0:k0 + keys]
                            np.testing.assert_array_equal(got, want)
                        else:
                            assert not el[r].any()


def _jax_forward(q, k, v, bias, gate, kv_len, rate, seed):
    """JAX's K2 forward (``_fwd_impl``, its Pallas kernel in interpret mode
    on the CPU) with the row LSE it writes, at 128-row tiles (two query
    and two key tiles at T = 203)."""
    return _fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(bias),
                     None if gate is None else jnp.asarray(gate),
                     jnp.asarray(kv_len),
                     seed_arr(jnp.int32(seed) if rate else None), 128, 128,
                     True, rate)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("with_gate", [True, False])
def test_forward_and_lse_match_jax(with_gate, rate):
    """At head_dim 64, [2, 2, 203, 64] (T odd: the bias rows the kernel
    stages are unaligned), bias with and without gate, key lengths (203,
    77), dropout at 0 and 0.1 with one seed: the plain twin the card's
    kernel is held against, and the entry point on the CPU, give the JAX
    kernel's output and row LSE within 1e-5 in f32."""
    rng = np.random.RandomState(64 + 2 * with_gate + int(rate * 10))
    b, h, t, d = 2, 2, 203, 64
    q, k, v = [(rng.randn(b, h, t, d) * 0.5).astype(np.float32)
               for _ in range(3)]
    bias = (rng.randn(h, t, t) * 0.5).astype(np.float32)
    gate = (rng.rand(b, h, t) + 0.5).astype(np.float32) if with_gate \
        else None
    kv_len = np.array([t, 77], np.int32)
    seed = 1234567
    want_out, want_lse = map(np.asarray, _jax_forward(
        q, k, v, bias, gate, kv_len, rate, seed))
    tq, tk, tv, tb = map(torch.from_numpy, (q, k, v, bias))
    tg = None if gate is None else torch.from_numpy(gate)
    tkv = torch.from_numpy(kv_len)
    tseed = torch.tensor([seed], dtype=torch.int32) if rate else None
    out, lse = flash_attention.attention_plain(
        tq, tk, tv, tb, tg, tkv, return_lse=True, dropout_rate=rate,
        dropout_seed=tseed)
    np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)
    entry = flash_attention.flash_attention(
        tq, tk, tv, tb, tg, tkv, dropout_rate=rate, dropout_seed=tseed)
    np.testing.assert_allclose(entry.numpy(), want_out, atol=1e-5, rtol=0)


def test_bias_forward_launcher_needs_cuda_tensors():
    """The forward is not replaced by the plain twin: ``launch_kernel``
    raises on CPU tensors with a bias at head_dim 64, with and without the
    LSE, and counts no launch; the CPU entry point runs the plain twin and
    counts none either."""
    reset_launch_counts()
    x = torch.randn(1, 2, 8, 64)
    bias, gate = torch.randn(2, 8, 8), torch.rand(1, 2, 8)
    for lse in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention.launch_kernel(x, x, x, bias, gate,
                                          return_lse=lse)
    y = x.clone().requires_grad_()
    flash_attention.flash_attention(y, y, y, bias, gate).sum().backward()
    assert flash_attention.mma_bias_fwd_launches == 0
    assert flash_attention.mma_fwd_launches == 0
    assert flash_attention.launches == 0


@pytest.mark.parametrize("err", [0, 2])
@pytest.mark.parametrize("with_gate", [True, False])
def test_mma_bias_forward_counted_where_it_launches(monkeypatch, err,
                                                    with_gate):
    """``mma_bias_fwd_launches`` rises in the branch of the mma forward
    with a bias, after the library of ``attention_fwd_bias_mma.cu`` ran its
    launcher with no error: once a call, not when the launch failed, and
    the bias-free forward's count never moves there. The launcher gets the
    forward's shared signature: the bias, the gate or null, and the LSE
    pointer only when the LSE is asked for. (A stand-in library takes the
    launch on the CPU.)"""
    libs, calls = [], []

    class Launcher:
        def __call__(self, *args):
            calls.append(args)
            return err

    class Library:
        def __getattr__(self, name):
            if name == "wfl_error_string":
                return lambda code: b"invalid argument"
            assert name == "wfl_attention_fwd_bias_mma"
            return Launcher()
    monkeypatch.setattr(_build, "library",
                        lambda name: libs.append(name) or Library())
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    reset_launch_counts()
    x = torch.randn(2, 3, 45, 64)
    bias = torch.randn(3, 45, 45)
    gate = torch.rand(2, 3, 45) if with_gate else None
    kv = torch.tensor([45, 20], dtype=torch.int32)
    for lse in (None, torch.zeros(2, 3, 45)):
        args = (x, x, x, bias, gate, kv, lse, None, 0, 1.0)
        if err:
            with pytest.raises(_build.KernelBuildError, match="invalid"):
                flash_attention._launch_mma_bias_fwd(*args)
        else:
            out = flash_attention._launch_mma_bias_fwd(*args)
            assert out.shape == x.shape and out.dtype == x.dtype
    assert libs == ["attention_fwd_bias_mma"] * 2
    assert [len(a) for a in calls] == [18, 18]
    assert all(a[3] == bias.data_ptr() for a in calls)
    assert all((a[4] is None) == (not with_gate) for a in calls)
    assert calls[0][7] is None and calls[1][7] is not None
    assert [a[9:13] for a in calls] == [(2, 3, 45, 64)] * 2
    assert flash_attention.mma_bias_fwd_launches == (0 if err else 2)
    assert flash_attention.mma_fwd_launches == 0


@pytest.mark.parametrize("err", [0, 2])
@pytest.mark.parametrize("d", [64, 48, 16])
def test_mma64_forward_counted_where_it_launches(monkeypatch, err, d):
    """``mma64_fwd_launches`` rises in the bias-free D = 64 branch, after
    the launcher of ``attention_fwd_bias_mma.cu`` returned no error: once a
    call, not when the launch failed, and no other forward count moves. The
    launcher gets null bias and gate pointers and head_dim 64, narrower
    inputs zero-padded to it, the true 1/√d as the scale, and the output
    comes back at the caller's width. (A stand-in library takes the launch
    on the CPU.)"""
    libs, calls = [], []

    class Library:
        def __getattr__(self, name):
            if name == "wfl_error_string":
                return lambda code: b"invalid argument"
            assert name == "wfl_attention_fwd_bias_mma"
            return lambda *args: calls.append(args) or err
    monkeypatch.setattr(_build, "library",
                        lambda name: libs.append(name) or Library())
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    reset_launch_counts()
    x = torch.randn(2, 3, 45, d)
    kv = torch.tensor([45, 20], dtype=torch.int32)
    lse = torch.zeros(2, 3, 45)
    args = (x, x, x, kv, lse, None, 0, 1.0)
    if err:
        with pytest.raises(_build.KernelBuildError, match="invalid"):
            flash_attention._launch_mma64_fwd(*args)
    else:
        out = flash_attention._launch_mma64_fwd(*args)
        assert out.shape == x.shape and out.dtype == x.dtype
    assert libs == ["attention_fwd_bias_mma"] and len(calls) == 1
    a = calls[0]
    assert len(a) == 18 and a[3] is None and a[4] is None
    assert a[9:13] == (2, 3, 45, 64)
    assert a[13] == pytest.approx(1 / np.sqrt(d))
    assert flash_attention.mma64_fwd_launches == (0 if err else 1)
    assert flash_attention.mma_bias_fwd_launches == 0
    assert flash_attention.fused_fwd_launches == 0
    assert flash_attention.mma_fwd_launches == 0


@pytest.mark.parametrize("kernel", ["k2", "k1w", "k128", "k128b", "k5",
                                    "wide", "wg"])
def test_kernel_variants_apply_to_the_source(kernel):
    """Every textual variant of ``kernel_variants_ab.py`` (tile constants,
    the copies' placement, bulk copies, the per-phase clocks) finds each
    text it replaces once in the kernel's source as it stands, so the A/B
    tool cannot drift from the kernel it times."""
    import kernel_variants_ab as kv
    source, variants = kv.KERNELS[kernel]
    text = (Path(_build.CSRC) / source).read_text()
    for name, (_, subs) in variants.items():
        varied = text
        for old, new in subs:
            assert varied.count(old) == 1, (name, old[:60])
            varied = varied.replace(old, new)
        assert (varied == text) == (not subs), name
