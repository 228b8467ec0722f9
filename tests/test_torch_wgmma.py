"""The bias-free bf16 attention routes ``"wgmma64"`` and ``"wgmma128"``
(``csrc/attention_wgmma.cu``: a forward and a dK/dV pass on Hopper's
wgmma fed by TMA tensor maps, a delta pre-pass, and the dQ pass of
``csrc/attention_bwd_bias_mma.cu``) on the CPU: the route table by dtype
and head width, where the routes' launch counters rise, what the
launchers receive (the tensors at their own width, nothing padded but K
for the dQ pass), the backward's three launches in order, the plain twins
the card's kernels are held against versus the JAX kernels (interpret
mode) at 40, 96 and 128 with and without strict dropout, and the new
source's tiles against a Hopper SM.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against the plain twins there.

    python -m pytest tests/test_torch_wgmma.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wfl_asr_tpu.ops.pallas.flash_attention_bwd import \
    flash_attention_trainable as jax_fat
from wfl_asr_tpu_torch.ops.kernels import _build, flash_attention, \
    flash_attention_bwd, reset_launch_counts

ATTN_TOL = 1e-5                     # forward and gradients, absolute
SM_SMEM = 233472                    # shared memory of a Hopper SM
BLOCK_SMEM = 232448                 # of it, what one block may use
BLOCK_RESERVED = 1024               # reserved by the system per block
SWIZZLE_BYTES = 128                 # CU_TENSOR_MAP_SWIZZLE_128B
SOURCE = Path(_build.CSRC) / "attention_wgmma.cu"
HOPPER = Path(_build.CSRC) / "hopper.cuh"
ROUTE_COUNTERS = ("mma_fwd_launches", "mma_bias_fwd_launches",
                  "mma64_fwd_launches", "mma128_fwd_launches",
                  "wgmma64_fwd_launches", "wgmma128_fwd_launches",
                  "wide_fwd_launches", "fused_fwd_launches",
                  "mma_bwd_launches", "mma_bias_bwd_launches",
                  "mma64_bwd_launches", "mma128_bwd_launches",
                  "wgmma64_bwd_launches", "wgmma128_bwd_launches",
                  "wide_bwd_launches", "fma_bwd_launches")


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("has_bias", [False, True])
def test_route_table_by_dtype(has_bias):
    """Every multiple of 16 from 16 to 2048: bias-free bf16 takes
    "wgmma64" at ≤ 64 and "wgmma128" at 80-128; f32 (the default dtype)
    keeps "mma64" and "mma128" there; every other route ("mma" above 128,
    "wide" above 512, "mma_bias"/"fused" with a bias) is the same in both
    dtypes. The backward follows the forward ("fused" ↔ "fma")."""
    for d in range(16, 2049, 16):
        if d > 512:
            f32 = bf16 = "wide"
        elif has_bias:
            f32 = bf16 = "mma_bias" if d == 64 else "fused"
        elif d > 128:
            f32 = bf16 = "mma"
        else:
            f32 = "mma64" if d <= 64 else "mma128"
            bf16 = "wg" + f32
        for dtype, want in ((torch.float32, f32), (torch.bfloat16, bf16)):
            assert flash_attention.forward_route(d, has_bias, dtype) == \
                want, (d, dtype)
            assert flash_attention.backward_route(d, has_bias, dtype) == \
                ("fma" if want == "fused" else want), (d, dtype)
        assert flash_attention.forward_route(d, has_bias) == f32, d
        assert flash_attention.backward_route(d, has_bias) == \
            ("fma" if f32 == "fused" else f32), d


def _stand_in(monkeypatch, err, fails=None):
    """A stand-in for every kernel library: each launcher call is recorded
    as (library, launcher, args) and returns 0, or ``err`` for the
    launcher named ``fails``. Returns the calls."""
    calls = []

    class Library:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            if name == "wfl_error_string":
                return lambda code: b"invalid argument"

            def launch(*args):
                calls.append((self.lib, name, args))
                return err if name == fails else 0
            return launch
    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return calls


def _counts_zero_but(*own):
    for name in ROUTE_COUNTERS:
        if name not in own:
            assert getattr(flash_attention, name) == 0, name


def _no_padding(monkeypatch):
    """Make ``_pad_to`` fail the test if a launcher calls it."""
    def refuse(*args, **kwargs):
        raise AssertionError("_pad_to called on a wgmma route")
    monkeypatch.setattr(flash_attention, "_pad_to", refuse)


@pytest.mark.parametrize("err", [0, 2])
@pytest.mark.parametrize("d", [16, 48, 64, 80, 96, 112, 128])
def test_wgmma_forward_counted_where_it_launches(monkeypatch, err, d):
    """The wgmma forward's counter (``wgmma64_fwd_launches`` at ≤ 64,
    ``wgmma128_fwd_launches`` at 80-128) rises once a call after
    ``wfl_attention_wgmma_fwd`` returned 0, not when it failed (which
    raises), and no other count moves. The launcher gets the tensors at
    their own width d (no ``_pad_to``), the route's width 64 or 128, the
    LSE and the true 1/√d; the output comes back at width d."""
    calls = _stand_in(monkeypatch, err, "wfl_attention_wgmma_fwd")
    _no_padding(monkeypatch)
    reset_launch_counts()
    x = torch.randn(2, 3, 45, d).to(torch.bfloat16)
    kv = torch.tensor([45, 20], dtype=torch.int32)
    lse = torch.zeros(2, 3, 45)
    route = flash_attention.forward_route(d, False, torch.bfloat16)
    width = 64 if d <= 64 else 128
    args = (route, x, x, x, kv, lse, None, 0, 1.0)
    if err:
        with pytest.raises(_build.KernelBuildError, match="invalid"):
            flash_attention._launch_wgmma_fwd(*args)
    else:
        out = flash_attention._launch_wgmma_fwd(*args)
        assert out.shape == x.shape and out.dtype == x.dtype
    assert [(c[0], c[1]) for c in calls] == [
        ("attention_wgmma", "wfl_attention_wgmma_fwd")]
    a = calls[0][2]
    assert len(a) == 16
    assert a[0] == x.data_ptr() and a[5] == lse.data_ptr() and a[6] is None
    assert a[7:12] == (2, 3, 45, d, width)       # B, H, T, d, width
    assert a[12] == pytest.approx(1 / np.sqrt(d))
    counter = f"{route}_fwd_launches"
    assert getattr(flash_attention, counter) == (0 if err else 1)
    _counts_zero_but(counter)


@pytest.mark.parametrize("fails", [None, "wfl_attention_wgmma_delta",
                                   "wfl_attention_wgmma_dkdv",
                                   "wfl_attention_bwd_dq_mma"])
@pytest.mark.parametrize("d", [48, 64, 96, 128])
def test_wgmma_backward_launches_in_order(monkeypatch, fails, d):
    """The wgmma backward runs three launchers in turn: the pre-pass
    (``wfl_attention_wgmma_delta``, which forms delta = rowsum(dO·O) in
    place of the torch ops of the other routes), the dK/dV pass and the dQ
    pass of ``attention_bwd_bias_mma.cu``; its counter rises once after all
    three returned 0. A failing launcher raises and stops the chain; no
    count moves then. The pre-pass and the dK/dV pass get the tensors at
    their own width d (no ``_pad_to``); the dQ pass gets K at the route's
    width 64 or 128 and a workspace row of T rounded up to 64; dQ comes
    back at width d."""
    calls = _stand_in(monkeypatch, 2, fails)
    _no_padding(monkeypatch)
    reset_launch_counts()
    b, h, t = 2, 3, 70
    x = torch.randn(b, h, t, d).to(torch.bfloat16)
    lse = torch.zeros(b, h, t)
    kv = torch.tensor([70, 33], dtype=torch.int32)
    route = flash_attention.backward_route(d, False, torch.bfloat16)
    width = 64 if d <= 64 else 128
    args = (route, x, x, x, x, x, lse, kv, None, 0, 1.0)
    order = ["wfl_attention_wgmma_delta", "wfl_attention_wgmma_dkdv",
             "wfl_attention_bwd_dq_mma"]
    if fails:
        with pytest.raises(_build.KernelBuildError, match="invalid"):
            flash_attention._launch_wgmma(*args)
        order = order[:order.index(fails) + 1]
    else:
        grads = flash_attention._launch_wgmma(*args)
        assert [g.shape for g in grads] == [x.shape] * 3
    assert [c[1] for c in calls] == order
    libs = ["attention_wgmma", "attention_wgmma", "attention_bwd_bias_mma"]
    assert [c[0] for c in calls] == libs[:len(order)]
    delta = calls[0][2]
    assert delta[3] is not None and delta[4:8] == (b, h, t, d)
    if len(calls) > 1:
        dkdv = calls[1][2]
        assert len(dkdv) == 20 and dkdv[4] == delta[3]     # the workspace
        assert dkdv[10:16] == (b, h, t, d, width, 128)   # … width, ldk
        assert dkdv[16] == pytest.approx(1 / np.sqrt(d))
    if len(calls) > 2:
        dq = calls[2][2]
        assert dq[4:9] == (b, h, t, width, 128) and dq[10] == 1
        assert dq[9] == pytest.approx(1 / np.sqrt(d))
        assert dq[2] == dkdv[9]                           # dS workspace
    counter = f"{route}_bwd_launches"
    assert getattr(flash_attention, counter) == (0 if fails else 1)
    _counts_zero_but(counter)


def test_launch_backward_takes_the_wgmma_route(monkeypatch):
    """``launch_backward`` on bf16 bias-free inputs (a stand-in library
    takes the launches on the CPU) routes to the wgmma passes by dtype and
    computes no delta of its own: ``out`` reaches the pre-pass as given.
    The same call in f32 takes ``mma64``."""
    calls = _stand_in(monkeypatch, 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda x: True))
    reset_launch_counts()
    x = torch.randn(1, 2, 40, 64)
    lse = torch.zeros(1, 2, 40)
    xb = x.to(torch.bfloat16)
    flash_attention.launch_backward(xb, xb, xb, None, None, None, xb, lse,
                                    xb)
    assert [c[1] for c in calls] == ["wfl_attention_wgmma_delta",
                                     "wfl_attention_wgmma_dkdv",
                                     "wfl_attention_bwd_dq_mma"]
    assert calls[0][2][0] == xb.data_ptr()
    assert flash_attention.wgmma64_bwd_launches == 1
    calls.clear()
    flash_attention.launch_backward(x, x, x, None, None, None, x, lse, x)
    assert [c[1] for c in calls] == ["wfl_attention_bwd_bias_mma"]
    assert flash_attention.mma64_bwd_launches == 1
    _counts_zero_but("wgmma64_bwd_launches", "mma64_bwd_launches")


def test_cpu_path_counts_no_wgmma_launch():
    """On CPU tensors the entry point runs the plain twins in bf16 too: the
    launchers refuse CPU tensors, and no count moves."""
    reset_launch_counts()
    for d in (40, 96, 128):
        x = torch.randn(1, 2, 8, d).to(torch.bfloat16).requires_grad_()
        flash_attention_bwd.flash_attention_trainable(x, x, x).float() \
            .sum().backward()
        xp = flash_attention.pad_head_dim(x, x, x)[0].detach()
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention.launch_kernel(xp, xp, xp)
    _counts_zero_but()
    assert flash_attention_bwd.launches == flash_attention_bwd.bwd_launches \
        == 0


def _inputs(seed, b, h, t, d):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, h, t, d) * 0.5).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", [40, 96, 128])
def test_plain_twins_match_jax(d, rate):
    """``flash_attention_trainable`` at [2, 2, 203, d], key lengths (203,
    77), on the CPU (the plain twins the card's wgmma kernels are held
    against, at 40 after the entry point's padding to 48): forward and
    dq, dk, dv through autograd against jax.vjp of the JAX entry point (its
    Pallas kernels in interpret mode), without dropout and with strict
    dropout at rate 0.1 (the hash mask of one int32 seed), within 1e-5."""
    b, h, t = 2, 2, 203
    q, k, v, dout = _inputs(d + int(rate * 10), b, h, t, d)
    kv = np.array([t, 77], np.int32)
    seed = 424242
    drop = dict(dropout_rate=rate, dropout_seed=seed) if rate else {}
    jdrop = (dict(dropout_rate=rate, dropout_seed=jnp.int32(seed)) if rate
             else {})
    want_out, vjp = jax.vjp(
        lambda *xs: jax_fat(*xs, jnp.asarray(kv), **jdrop),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention_bwd.flash_attention_trainable(
        *leaves, torch.from_numpy(kv), **drop)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ATTN_TOL, rtol=0)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_TOL,
                                   rtol=0, err_msg=name)


def _ints(pattern: str, path: Path = SOURCE) -> tuple:
    """The integers ``pattern``'s groups match in a source, so that the
    mirror below cannot drift from it."""
    return tuple(int(g) for g in re.search(pattern, path.read_text())
                 .groups())


def _roles(nwg: int, min_blocks: int) -> dict:
    """Mirror of ``Roles``: threads, and the registers after
    reallocation."""
    (producer,) = _ints(r"int regs_producer = (\d+);")
    threads = 128 * (nwg + 1)
    base = 65536 // (threads * min_blocks) // 8 * 8
    consumer = (base * threads - 128 * producer) // (128 * nwg) // 8 * 8
    return dict(threads=threads, base=base, producer=producer,
                consumer=consumer,
                rebalance=threads * min_blocks > 256)


def fwd_tiles(d: int, nwg: int) -> dict:
    """Mirror of ``FwdTiles`` in ``csrc/attention_wgmma.cu``."""
    (box,) = _ints(r"constexpr int kBoxBytes = (\d+);")
    (bk,) = _ints(r"struct FwdTiles[^}]*?int bk = (\d+);")
    (stages,) = _ints(r"struct FwdTiles[^}]*?int stages = (\d+);")
    nb, bq = d // 64, 64 * nwg
    q_bytes, kv_bytes = nb * bq * box, nb * bk * box
    bar_off = q_bytes + 2 * stages * kv_bytes
    smem = bar_off + 8 * (2 * stages + 1) + 1024
    return dict(_roles(nwg, 2 if nwg == 1 else 1), d=d, nb=nb, bq=bq, bk=bk,
                stages=stages, box=box, smem=smem, q_bytes=q_bytes,
                kv_bytes=kv_bytes, min_blocks=2 if nwg == 1 else 1)


def bwd_tiles(d: int) -> dict:
    """Mirror of ``BwdTiles`` at the consumer groups the source names for
    head width ``d``."""
    (box,) = _ints(r"constexpr int kBoxBytes = (\d+);")
    (nwg,) = _ints(rf"constexpr int kBwdGroups{d} = (\d+);")
    (pitch,) = _ints(r"constexpr int kStPitch = (\d+);")
    (stages,) = _ints(r"struct BwdTiles[^}]*?int stages = (\d+);")
    (stat,) = _ints(r"int stat_bytes = (\d+);")
    nb, bk, bq = d // 64, 64 * nwg, 64
    kv_bytes, q_bytes = nb * bk * box, nb * bq * box
    stage = 2 * q_bytes + stat
    st_off = 2 * kv_bytes + stages * stage
    bar_off = st_off + nwg * bq * pitch * 2
    smem = bar_off + 8 * (2 * stages + 1) + 1024
    return dict(_roles(nwg, 1), d=d, nwg=nwg, bk=bk, bq=bq, stages=stages,
                box=box, smem=smem, stage=stage, q_bytes=q_bytes,
                stat=stat, pitch=pitch)


@pytest.mark.parametrize("d,nwg", [(64, 1), (64, 2), (128, 2)])
def test_forward_tiles_fit_a_sm(d, nwg):
    """The forward's CTA fits the 227 KB a block may use, and the CTAs a
    SM its launch bounds name (2 with one consumer group, 1 with two) fit
    a SM's 228 KB with 1 KB reserved each. A TMA box's inner extent is 64 bf16, the 128 bytes the
    128-byte swizzle allows; a box holds at most 256 rows; the ring has at
    least 2 stages, each tile 1024-byte aligned. The registers the
    producer gives up are the ones the consumers take: the reallocation
    never asks for more than the launch holds, at most 256 a thread."""
    t = fwd_tiles(d, nwg)
    assert t["smem"] <= BLOCK_SMEM, t
    assert t["min_blocks"] * (t["smem"] + BLOCK_RESERVED) <= SM_SMEM, t
    assert t["box"] == 64 * 2 <= SWIZZLE_BYTES
    assert t["bk"] <= 256 and t["bk"] % 16 == 0
    assert t["stages"] >= 2
    assert t["q_bytes"] % 1024 == 0 and t["kv_bytes"] % 1024 == 0
    assert t["rebalance"]
    total = t["base"] * t["threads"]
    assert 128 * t["producer"] + 128 * nwg * t["consumer"] <= total
    assert t["consumer"] <= 256 and t["consumer"] % 8 == 0
    assert (t["base"], t["consumer"]) == ((168, 232) if nwg == 2
                                          else (128, 216))


@pytest.mark.parametrize("d", [64, 128])
def test_dkdv_tiles_fit_a_sm(d):
    """The dK/dV pass's CTA (K and V of its keys resident, a ring of Q, dO
    and their LSE₂/delta rows, a dS staging tile a consumer group) fits
    the 227 KB of a block and a SM; its stages stay 1024-byte aligned for
    the swizzled tiles; the staging rows are 16-byte aligned for the
    16-byte stores; the LSE₂/delta rows of a stage (2 × 64 floats, bulk
    copies of 256 bytes) fit their slot."""
    t = bwd_tiles(d)
    assert t["smem"] <= BLOCK_SMEM, t
    assert t["smem"] + BLOCK_RESERVED <= SM_SMEM
    assert t["stage"] % 1024 == 0 and t["q_bytes"] % 1024 == 0
    assert t["stat"] >= 2 * t["bq"] * 4
    assert t["pitch"] * 2 % 16 == 0 and t["pitch"] >= t["bq"]
    assert t["stages"] >= 2 and t["box"] <= SWIZZLE_BYTES
    if t["rebalance"]:
        total = t["base"] * t["threads"]
        assert 128 * t["producer"] + 128 * t["nwg"] * t["consumer"] <= total


def test_forward_groups_by_width():
    """The source runs the forward at D = 64 with one consumer group (64
    queries) a CTA and 2 CTAs a SM, and at D = 128 with two (128 queries)
    and 1 CTA a SM: the widths' tiles fit that."""
    assert _ints(r"constexpr int kFwdGroups64 = (\d+);") == (1,)
    assert _ints(r"constexpr int kFwdGroups128 = (\d+);") == (2,)
    assert "return width == 128 ? run_fwd<128, kFwdGroups128>(a, BH, s)\n" \
        "                      : run_fwd<64, kFwdGroups64>(a, BH, s);" in \
        SOURCE.read_text()
    assert fwd_tiles(64, 1)["min_blocks"] == 2
    assert 2 * (fwd_tiles(128, 1)["smem"] + BLOCK_RESERVED) > SM_SMEM


def test_descriptors_follow_the_swizzle():
    """hopper.cuh's wgmma descriptor carries the 128-byte swizzle (layout
    type 1 in bits 62-63) and byte offsets in 16-byte units; its tensor
    maps are 3-D (D, T, B·H), 64-column boxes, 128-byte swizzled, their
    out-of-bounds elements zero-filled; the encode function comes from the
    runtime's driver entry point (no libcuda link)."""
    text = HOPPER.read_text()
    assert "| (uint64_t)1 << 62;" in text
    assert "(uint64_t)((sbo >> 4) & 0x3FFF) << 32" in text
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in text
    assert "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE" in text
    assert "const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};" in text
    assert 'cudaGetDriverEntryPoint("cuTensorMapEncodeTiled"' in text
    assert "-lcuda" not in " ".join(_build.NVCC_FLAGS)


def test_bias_free_bf16_refused_by_the_mma_sources():
    """The mma.sync sources no longer instantiate the bias-free bf16
    forward and dK/dV pass: their dispatch refuses them, so nothing can
    route there; the dQ pass has an entry of its own for the wgmma
    routes."""
    for name in ("attention_fwd_bias_mma.cu", "attention_bwd_bias_mma.cu"):
        text = (Path(_build.CSRC) / name).read_text()
        assert "if constexpr (std::is_same_v<Pol, PolBF16>) {\n" \
            "    return cudaErrorInvalidValue;" in text, name
    text = (Path(_build.CSRC) / "attention_bwd_bias_mma.cu").read_text()
    assert 'extern "C" int wfl_attention_bwd_dq_mma(' in text
    assert set(_build.SIGNATURES["attention_wgmma"]) == {
        "wfl_attention_wgmma_fwd", "wfl_attention_wgmma_delta",
        "wfl_attention_wgmma_dkdv"}


@pytest.mark.parametrize("d", [64, 128])
def test_dkdv_ds_stores_stay_inside_the_workspace(d):
    """The dK/dV CTA covers 64 keys a consumer group, the dS workspace only
    ⌈T/64⌉·64 columns: where that count of tiles is odd the last CTA's
    second group starts at ldk, on the next query row's keys. The source
    stores a group's dS only while its first key lies below kv_len, and,
    mirrored here over every T up to 520 and every kv_len in [1, T], each
    store so allowed then lies wholly inside its row, and every key tile
    the dQ pass reads (those below kv_len) has its store."""
    text = SOURCE.read_text()
    assert "const bool group_live = k0 + 64 * w < kvl;" in text
    assert "if (group_live && q0 + ql < T_len)" in text
    nwg, bk = bwd_tiles(d)["nwg"], bwd_tiles(d)["bk"]
    assert nwg == 2
    for t in range(1, 521):
        ldk = -(-t // 64) * 64
        for kvl in range(1, t + 1):
            stored = set()
            for k0 in range(0, t, bk):
                if k0 >= kvl:            # the CTA's early return
                    continue
                for w in range(nwg):
                    first = k0 + 64 * w
                    if first < kvl:
                        assert first + 64 <= ldk, (t, kvl, k0, w)
                        stored.add(first // 64)
            assert stored == set(range(-(-kvl // 64))), (t, kvl)
