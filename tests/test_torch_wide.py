"""Attention above head_dim 512 (the ``"wide"`` route: the cluster forward
and backward of ``csrc/attention_wide.cu``, the contraction over D split
across a thread-block cluster) on the CPU: the entry points against the JAX
kernels (interpret mode) at widths 528, 640 and 1280 with ragged key
lengths, bias-free and with bias and gate, with strict dropout at 640; a
Conformer block at large-v3's head shape (dim 1280, 2 heads) against the
JAX block; the kernel's tile table and cluster plan at 528-2048; what its
launcher refuses and where the route stops; where its launch counters
rise.

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


def _pitch(cols: int, f32: bool) -> int:
    """``Pol::pitch`` of attention_mma.cuh."""
    return (cols + 31) // 32 * 32 + 8 if f32 else cols + 8


def _pitch_s(cols: int, f32: bool) -> int:
    """``Pol::pitch_s`` of attention_mma.cuh."""
    return (cols + 31) // 32 * 32 if f32 else cols + 8


def wide_tiles(f32: bool) -> dict:
    """Mirror of ``WideTiles`` of ``csrc/attention_wide.cu``, with the slice
    width, warps, tile sizes and ring stages read out of the source: each
    pass's dynamic shared memory in bytes, and the blocks a SM its launch
    bounds ask for."""
    es, i = (4, 1) if f32 else (2, 0)
    (slice_w,) = _source_ints(r"constexpr int kSliceW = (\d+);")
    (fwd_warps,) = _source_ints(r"constexpr int kFwdWarps = (\d+);")
    (fwd_blocks,) = _source_ints(r"constexpr int kFwdBlocks = (\d+);")
    fwd_bk = _source_ints(r"constexpr int kFwdKeys\[2\] = \{(\d+), (\d+)\};")[i]
    (fwd_stages,) = _source_ints(r"constexpr int kFwdStages = (\d+);")
    (kv_bk,) = _source_ints(r"constexpr int kKvKeys = (\d+);")
    kv_bq = _source_ints(
        r"constexpr int kKvQueries\[2\] = \{(\d+), (\d+)\};")[i]
    (kv_stages,) = _source_ints(r"constexpr int kKvStages = (\d+);")
    dq_bq, dq_bk = _source_ints(r"constexpr int kDqBQ = (\d+), kDqBK = (\d+);")
    p = _pitch(slice_w, f32)
    fwd_bq = 16 * fwd_warps
    fwd = es * (fwd_bq + fwd_stages * 2 * fwd_bk) * p + 4 * 2 * fwd_bq * fwd_bk
    dkdv = (es * (2 * kv_bk * p + kv_stages * 2 * kv_bq * p
                  + 2 * kv_bk * _pitch_s(kv_bq, f32))
            + 4 * (kv_stages * 2 * kv_bq + 2 * 2 * kv_bk * kv_bq))
    dq = es * 2 * (dq_bq * _pitch_s(dq_bk, f32) + dq_bk * p)
    blocks = {name: _source_ints(r"__launch_bounds__\(kThreads, (\d+)\)\n"
                                 rf"attn_wide_{name}\(")[0]
              for name in ("bwd_dkdv", "bwd_dq")}
    assert "__launch_bounds__(32 * kFwdWarps, kFwdBlocks)\nattn_wide_fwd(" \
        in SOURCE.read_text()
    blocks["fwd"] = fwd_blocks
    return dict(fwd_smem=fwd, dkdv_smem=dkdv, dq_smem=dq, blocks=blocks,
                fwd_bk=fwd_bk, kv_bq=kv_bq)


def cluster_plan(d: int) -> list:
    """Mirror of ``plan_of`` of ``csrc/attention_wide.cu``: the columns
    [start, end) of D that each rank of the cluster owns, in rank order
    (⌈D / 128⌉ ranks, the 16-column steps shared as evenly as whole
    slices of ⌈steps / ranks⌉ steps allow)."""
    (slice_w,) = _source_ints(r"constexpr int kSliceW = (\d+);")
    steps, most = d // 16, slice_w // 16
    c = -(-steps // most)
    per = -(-steps // c)
    ranks, width = -(-steps // per), 16 * per
    return [(r * width, min((r + 1) * width, d)) for r in range(ranks)]


@pytest.mark.parametrize("f32", [True, False])
def test_wide_tiles_fit_shared_memory(f32):
    """Every pass's tiles (the forward's Q slice, K and V rings and
    partial score buffers; the dK/dV pass's K and V slices, Q/dO ring, Pᵀ·M
    and dSᵀ tiles and partial buffers; the dQ pass's two stages) fit the
    blocks a SM its launch bounds ask for (228 KB, 1 KB reserved each):
    one for the cluster passes, two for dQ. Nothing in the table depends on
    D: a slice row is pitched for 128 columns whatever the slice's width."""
    t = wide_tiles(f32)
    assert t["blocks"] == {"fwd": 1, "bwd_dkdv": 1, "bwd_dq": 2}
    for key, name in (("fwd_smem", "fwd"), ("dkdv_smem", "bwd_dkdv"),
                      ("dq_smem", "bwd_dq")):
        assert t["blocks"][name] * (t[key] + BLOCK_RESERVED) <= SM_SMEM, \
            (key, t)
    # a key tile of the forward and a query tile of the dK/dV pass are whole
    # 16-row mma steps, split over the 2 query halves of the dK/dV warps
    assert t["fwd_bk"] % 16 == 0 and t["kv_bq"] % 32 == 0


@pytest.mark.parametrize("d", [528, 640, 1024, 1280, 1536, 2048])
def test_wide_cluster_plan(d):
    """The launcher's cluster plan at head width ``d``: the ranks' slices
    cover D in whole 16-column steps, in order, none empty and none wider
    than 128 columns; a cluster of more than 8 CTAs (the portable limit)
    only where the launcher asks for a non-portable size, and never more
    than 16; every pass fits one block a SM at that width (the table does
    not depend on D). 640 (large-v3's Conformer at 2 heads) is 5 slices of
    128; 528 is 4 of 112 and one of 80."""
    plan = cluster_plan(d)
    assert plan[0][0] == 0 and plan[-1][1] == d
    for (s0, e0), (s1, _) in zip(plan, plan[1:]):
        assert e0 == s1
    assert all(0 < e - s <= 128 and (e - s) % 16 == 0 for s, e in plan)
    (portable,) = _source_ints(r"constexpr int kPortable = (\d+);")
    (most,) = _source_ints(r"constexpr int kMaxRanks = (\d+);")
    assert (portable, most) == (8, 16)
    assert len(plan) <= most
    if len(plan) > portable:
        assert "if (err != cudaSuccess || ranks <= kPortable) return err;\n" \
            "  return cudaFuncSetAttribute(\n      kernel, " \
            "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);" in \
            SOURCE.read_text()
    widths = [e - s for s, e in plan]
    want = {528: [112] * 4 + [80], 640: [128] * 5, 1024: [128] * 8,
            1280: [128] * 10, 1536: [128] * 12, 2048: [128] * 16}
    assert widths == want[d]
    for f32 in (True, False):
        t = wide_tiles(f32)
        assert t["fwd_smem"] + BLOCK_RESERVED <= SM_SMEM


def test_wide_launcher_refuses_what_the_route_does_not_send():
    """The launchers refuse a head_dim of 512 or less (the route never sends
    one), one above 2048 (a cluster holds at most 16 slices of 128
    columns; the route raises first), widths that are no multiple of 16
    and a gate without a bias; the backward refuses a workspace row that is
    no multiple of 64."""
    text = SOURCE.read_text()
    assert "return D <= kMinD || D > kMaxD || D % 16 != 0\n" \
        "         || (bias == nullptr && gate != nullptr);" in text
    assert _source_ints(r"constexpr int kMinD = (\d+);") == \
        (flash_attention.WIDE_MIN_D,)
    assert "constexpr int kMaxD = kSliceW * kMaxRanks;" in text
    assert _source_ints(r"constexpr int kSliceW = (\d+);")[0] \
        * _source_ints(r"constexpr int kMaxRanks = (\d+);")[0] \
        == flash_attention.WIDE_MAX_D
    assert "if (ldk % kLdk != 0 || ldk < T_len) return " \
        "cudaErrorInvalidValue;" in text
    assert _source_ints(r"constexpr int kLdk = (\d+);") == (64,)


@pytest.mark.parametrize("has_bias", [False, True])
def test_wide_route_names_its_limit(has_bias):
    """Above ``WIDE_MAX_D`` (2048) no CUDA route takes the call: both
    route functions raise and name the limit, rather than fall through to
    a kernel that would refuse it; 2048 itself is wide."""
    assert flash_attention.forward_route(2048, has_bias) == "wide"
    for route in (flash_attention.forward_route,
                  flash_attention.backward_route):
        with pytest.raises(ValueError, match="2048"):
            route(2064, has_bias)


def test_kernel_variants_wide_arguments(monkeypatch, capsys):
    """``kernel_variants_ab.py --kernel wide`` asks for the baseline source
    it times this tree's kernels against, parses with it (and stops here
    for want of a card), and its variant table holds, for each dtype, this
    tree's source plain and with the forward's clocks and the baseline."""
    import sys
    import kernel_variants_ab as kv
    monkeypatch.setattr(sys, "argv", ["kernel_variants_ab.py", "--kernel",
                                      "wide"])
    with pytest.raises(SystemExit) as exit_:
        kv.main()
    assert exit_.value.code == 2
    assert "--baseline" in capsys.readouterr().err
    monkeypatch.setattr(sys, "argv", ["kernel_variants_ab.py", "--kernel",
                                      "wide", "--baseline", "old.cu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kv.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert kv.KERNELS["wide"][0] == SOURCE.name
    for dtype in ("bf16", "f32"):
        names = [n for n, (dt, _) in kv.WIDE_VARIANTS.items() if dt == dtype]
        assert names[:2] == [f"{dtype} cluster", f"{dtype} cluster, clocks"]
        assert names[-1] == f"{dtype} baseline"
        assert f"{dtype} baseline" in kv.WIDE_BASELINE
        assert kv.WIDE_VARIANTS[f"{dtype} cluster, clocks"][1] == \
            kv.WIDE_CLOCKS
    # one clock counter a phase, each marked once in the forward's key loop
    n = len(kv.WIDE_PHASES)
    assert f"wfl_clk[{n}]" in kv.WIDE_CLK_GLOBAL
    marks = "".join(new for _, new in kv.WIDE_CLOCKS)
    assert [marks.count(f"WFL_MARK({i},") for i in range(n + 1)] == \
        [1] * n + [0]


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


@pytest.mark.parametrize("d", [640, 2048])
@pytest.mark.parametrize("err", [0, 2])
@pytest.mark.parametrize("bias_mode", ["none", "bias", "bias+gate"])
def test_wide_counted_where_it_launches(monkeypatch, err, bias_mode, d):
    """``wide_fwd_launches`` and ``wide_bwd_launches`` rise in the wide
    branches, after the launcher of ``attention_wide.cu`` returned no
    error: once a call, not when a launch failed, and no other route's
    count moves, at a 5-CTA cluster's width (640) and at the widest, a
    16-CTA non-portable cluster's (2048). With a bias the backward then
    runs the dBias/dGate pass of ``attention_bwd_bias_mma.cu`` on the same
    workspace. (A stand-in library takes the launches on the CPU.)"""
    libs, calls = [], []
    monkeypatch.setattr(_build, "library", lambda name: libs.append(name)
                        or _Library(calls, err))
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    reset_launch_counts()
    x = torch.randn(2, 3, 45, d)
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
    assert len(fargs) == 18 and fargs[9:13] == (2, 3, 45, d)
    assert (fargs[3] is None) == (bias is None)
    assert len(bargs) == 24 and bargs[14:19] == (2, 3, 45, d, 64)
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
