"""Gated-bias flash attention, the port of
``wfl_asr_tpu/ops/pallas/flash_attention.py:flash_attention``, forward and
backward.

    out[b,h,q,:] = softmax_k( q·kᵀ/√d + gate[b,h,q]·bias[h,q,k],
                              keys ≥ kv_len[b] → −1e30 ) · v

- ``bias`` [H, T, T] is WavLM's relative position bias, shared over the
  batch (read per tile by the kernel, never expanded to [B,H,T,T]);
  ``gate`` [B, H, T] is the per-query gate; ``kv_len`` [B] masks padded
  keys (clamped to ≥ 1, as in JAX).
- On a CUDA tensor hand-written kernels run (f32 or bf16 in, f32 softmax
  and accumulation): the forward, which also writes the row logsumexp
  (LSE) when autograd will need it, and the backward passes, which
  recompute P = exp(S − LSE) tile by tile. The forward takes one of eight
  routes (:func:`forward_route`): above head_dim 512 (up to 2048), with or
  without a bias, the cluster forward of ``csrc/attention_wide.cu`` (the
  contraction over D split across a thread-block cluster); with a bias
  at head_dim 64 the tensor-core forward of
  ``csrc/attention_fwd_bias_mma.cu``; bias-free in bf16 the wgmma and TMA
  forward of ``csrc/attention_wgmma.cu`` at head width 64 for head_dim
  ≤ 64 and at 128 for 80-128 (at the tensors' own width); bias-free in f32
  the bias-free instantiations of ``csrc/attention_fwd_bias_mma.cu`` at
  those widths (narrower widths zero-padded to 64 or 128); bias-free at
  head_dim > 128 the forward of ``csrc/attention_fwd_mma.cu``; otherwise
  (a bias at widths other than 64, up to 512) the forwards of
  ``csrc/flash_attention.cu``. The backward takes the matching one of
  eight (:func:`backward_route`): the dK/dV and dQ passes of
  ``csrc/attention_wide.cu`` above 512 (with a bias then also the
  dBias/dGate pass of ``csrc/attention_bwd_bias_mma.cu``); the tensor-core
  passes of ``csrc/attention_bwd_bias_mma.cu`` with a bias at head_dim 64
  (dK/dV, dQ, dBias/dGate), and bias-free in f32 at ≤ 64 and at 80-128
  (dK/dV, dQ, at head width 64 or 128); bias-free in bf16 there the
  delta pre-pass and the wgmma dK/dV pass of ``csrc/attention_wgmma.cu``,
  then the dQ pass of ``csrc/attention_bwd_bias_mma.cu``; bias-free at
  head_dim > 128 the tensor-core pair of ``csrc/attention_bwd_mma.cu``;
  otherwise the FMA pair of ``csrc/flash_attention.cu`` (dK/dV; dQ with
  dGate and dBias). On a
  CPU tensor the plain twins :func:`attention_plain` and
  :func:`attention_backward_plain` run. Nothing falls back: a kernel that
  fails to build or launch raises.
- ``dropout_rate`` > 0 with a ``dropout_seed`` runs strict attention
  dropout (K6) inside those kernels, with the JAX package's hash mask
  (``dropout_mask``): the forward masks P after the row sum, the backward
  recomputes the same mask; the seed stays on the device.
- The kernels take any head width that is a multiple of 16; both entry
  points zero-pad any other width up to the next multiple of 16 on every
  device (:func:`pad_head_dim`), scale by the true ``1/√d``, and slice the
  output back (autograd slices the gradients).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .dropout_mask import C_B, C_H, check_rate, keep_scale, \
    keep_threshold, mask_grid

NEG_INF = -1e30

# Launches of the CUDA kernels through this module's entry point (forward,
# and the backward pair), and of those the ones with dropout; a run resets
# them to 0 and reads them to show the path went through the kernels.
launches = 0
bwd_launches = 0
dropout_launches = 0
dropout_bwd_launches = 0
# Launches of each backward route, counted in the branch of
# launch_backward that runs it: the FMA pair of flash_attention.cu, the
# mma.sync pair of attention_bwd_mma.cu, the mma.sync passes with a bias of
# attention_bwd_bias_mma.cu.
fma_bwd_launches = 0
mma_bwd_launches = 0
mma_bias_bwd_launches = 0
# Launches of the mma.sync forwards, each counted in the branch of
# launch_kernel that runs it: bias-free (attention_fwd_mma.cu) and with a
# bias (attention_fwd_bias_mma.cu).
mma_fwd_launches = 0
mma_bias_fwd_launches = 0
# Launches of the forwards of flash_attention.cu (the "fused" route),
# counted in the branch of launch_kernel that runs them.
fused_fwd_launches = 0
# Launches of the bias-free instantiations of the mma.sync forward and
# passes of attention_{fwd,bwd}_bias_mma.cu at head width 64 ("mma64") and
# 128 ("mma128"), and of attention_wide.cu's forward and backward ("wide"),
# each counted in the branch that runs it.
mma64_fwd_launches = 0
mma64_bwd_launches = 0
mma128_fwd_launches = 0
mma128_bwd_launches = 0
wide_fwd_launches = 0
wide_bwd_launches = 0
# Launches of the bf16 bias-free routes of attention_wgmma.cu at head width
# 64 ("wgmma64") and 128 ("wgmma128"): the forward, and the backward's
# three launches (delta pre-pass, dK/dV pass, dQ pass) as one, each
# counted after its launchers returned no error.
wgmma64_fwd_launches = 0
wgmma64_bwd_launches = 0
wgmma128_fwd_launches = 0
wgmma128_bwd_launches = 0

# Head widths above this, without a bias, take the mma.sync forward and the
# mma.sync backward pair.
MMA_MIN_D = 128
# The head width the mma.sync forward and backward with a bias are compiled
# for; bias-free calls at widths up to it run their bias-free instantiation,
# zero-padded to it.
MMA_BIAS_D = 64
# The head width of their second bias-free instantiation: bias-free calls
# above MMA_BIAS_D and up to it run it, zero-padded to it.
MMA128_D = 128
# Head widths above this, with or without a bias, take attention_wide.cu,
# up to WIDE_MAX_D: its clusters hold at most 16 CTAs of 128 columns of D.
WIDE_MIN_D = 512
WIDE_MAX_D = 2048


def forward_route(d: int, has_bias: bool,
                  dtype: torch.dtype = torch.float32) -> str:
    """Which forward a CUDA call at head_dim ``d`` (a multiple of 16) in
    ``dtype`` runs: ``"wide"`` (``csrc/attention_wide.cu``) above 512, up
    to ``WIDE_MAX_D`` (wider widths raise: no CUDA route takes them); with
    a bias, ``"mma_bias"`` (the tensor-core forward of
    ``csrc/attention_fwd_bias_mma.cu``) at 64, else ``"fused"`` (the
    forwards of ``csrc/flash_attention.cu``); bias-free at ≤ 64 and at
    80-128, in bf16 ``"wgmma64"`` and ``"wgmma128"`` (the wgmma forward of
    ``csrc/attention_wgmma.cu`` at head width 64 and 128), in f32
    ``"mma64"`` and ``"mma128"`` (the bias-free instantiations of
    ``csrc/attention_fwd_bias_mma.cu``); bias-free above 128 ``"mma"``
    (``csrc/attention_fwd_mma.cu``)."""
    if d > WIDE_MAX_D:
        raise ValueError(f"head_dim {d} exceeds {WIDE_MAX_D}, the widest the "
                         f"CUDA attention kernels take (attention_wide.cu: "
                         f"16 CTAs of 128 columns)")
    if d > WIDE_MIN_D:
        return "wide"
    if has_bias:
        return "mma_bias" if d == MMA_BIAS_D else "fused"
    if d > MMA_MIN_D:
        return "mma"
    width = "64" if d <= MMA_BIAS_D else "128"
    return ("wgmma" if dtype == torch.bfloat16 else "mma") + width


def backward_route(d: int, has_bias: bool,
                   dtype: torch.dtype = torch.float32) -> str:
    """Which backward a CUDA call runs, by the forward's table: ``"wide"``
    (the passes of ``csrc/attention_wide.cu``) above 512; ``"mma_bias"``
    (the tensor-core passes of ``csrc/attention_bwd_bias_mma.cu``) with a
    bias at 64; bias-free at ≤ 64 and at 80-128, in bf16 ``"wgmma64"`` and
    ``"wgmma128"`` (the delta pre-pass and wgmma dK/dV pass of
    ``csrc/attention_wgmma.cu``, then the dQ pass of
    ``csrc/attention_bwd_bias_mma.cu``), in f32 ``"mma64"`` and
    ``"mma128"`` (the bias-free instantiations of that file's dK/dV and dQ
    passes); ``"mma"`` (the tensor-core pair of
    ``csrc/attention_bwd_mma.cu``) bias-free above 128; else ``"fma"`` (the
    FMA pair of ``csrc/flash_attention.cu``), with a bias at widths other
    than 64 up to 512."""
    route = forward_route(d, has_bias, dtype)
    return "fma" if route == "fused" else route


def _prep_kv_len(kv_len, b: int, t: int, device) -> torch.Tensor:
    """[B] int32 valid key counts, clamped to [1, T] (a kv_len of 0 would
    leave a row fully masked; attending to key 0 alone keeps it finite —
    flash_attention.py:179-185)."""
    if kv_len is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    kv = torch.as_tensor(kv_len, device=device).to(torch.int32)
    return kv.expand(b).clamp(1, t).contiguous()


def _scale(q, scale: Optional[float]) -> float:
    """The score scale: ``scale``, or 1/√d of q's head width."""
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def pad_head_dim(q, k, v):
    """(q, k, v zero-padded on D to the next multiple of 16, the true D,
    its 1/√D): zero columns add nothing to q·kᵀ and give zero output
    columns, which the caller slices off."""
    d = q.shape[-1]
    pad = -d % 16
    if pad:
        q, k, v = (F.pad(x, (0, pad)) for x in (q, k, v))
    return q, k, v, d, 1.0 / math.sqrt(d)


def _scores_plain(q, k, bias, gate, kv, scale=None) -> torch.Tensor:
    """f32 scores (q·scale)·kᵀ + gate·bias with keys ≥ kv set to −1e30."""
    t = q.shape[2]
    s = torch.matmul(q.float() * _scale(q, scale),
                     k.float().transpose(-1, -2))
    if bias is not None:
        bf = bias.float()[None]
        s = s + (gate.float()[..., None] * bf if gate is not None else bf)
    keep = torch.arange(t, device=q.device)[None, :] < kv[:, None]
    return torch.where(keep[:, None, None, :], s, torch.full_like(s, NEG_INF))


def _dropout_plain(q, dropout_rate: float, dropout_seed):
    """The [B, H, T, T] f32 keep·scale mask of the kernels (K6), or None
    at rate 0."""
    if dropout_rate <= 0.0:
        return None
    b, h, t, _ = q.shape
    return mask_grid(dropout_seed, b, h, t, t, dropout_rate, q.device)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    gate: Optional[torch.Tensor] = None,
                    kv_len=None, return_lse: bool = False,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    scale: Optional[float] = None):
    """Plain PyTorch twin: materialized f32 scores, the kernel's exact
    math (``layers.attention_core`` with the gated bias and key mask, and
    with ``dropout_rate`` > 0 the kernels' dropout mask on the normalized
    probabilities). With ``return_lse`` also the row logsumexp [B, H, T]
    f32 (of the undropped scores). ``scale``: of the scores, 1/√d of q's
    width when None."""
    b, h, t, d = q.shape
    s = _scores_plain(q, k, bias, gate, _prep_kv_len(kv_len, b, t, q.device),
                      scale)
    p = torch.softmax(s, dim=-1)
    mask = _dropout_plain(q, dropout_rate, dropout_seed)
    if mask is not None:
        p = p * mask
    out = torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def attention_backward_plain(q, k, v, bias, gate, kv_len, out, lse, dout,
                             dropout_rate: float = 0.0, dropout_seed=None,
                             scale: Optional[float] = None):
    """Plain twin of the backward kernels, step by step from the saved LSE
    as they work: P = exp(S − LSE), dP = dO·Vᵀ, delta = rowsum(dO·O),
    dS = P·(dP − delta); dQ = dS·K·scale, dK = dSᵀ·(Q·scale), dV = Pᵀ·dO,
    dBias = Σ_b gate·dS, dGate = Σ_k bias·dS. With dropout (mask M) dV =
    (P·M)ᵀ·dO and dS = P·(M·dP − delta), delta unchanged. Returns (dq, dk,
    dv, dbias, dgate): dq/dk/dv in q's dtype, dbias [H,T,T] and dgate
    [B,H,T] in f32 (None where there is no bias or gate)."""
    b, h, t, d = q.shape
    scale = _scale(q, scale)
    kv = _prep_kv_len(kv_len, b, t, q.device)
    s = _scores_plain(q, k, bias, gate, kv, scale)
    p = torch.exp(s - lse.float()[..., None])
    do = dout.float()
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    delta = (do * out.float()).sum(-1, keepdim=True)
    mask = _dropout_plain(q, dropout_rate, dropout_seed)
    if mask is not None:
        dp = dp * mask
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float() * scale)
    dv = torch.matmul((p if mask is None else p * mask).transpose(-1, -2),
                      do)
    dbias = dgate = None
    if bias is not None:
        dbias = ((gate.float()[..., None] * ds) if gate is not None
                 else ds).sum(0)
    if gate is not None:
        dgate = (bias.float()[None] * ds).sum(-1)
    return (dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), dbias, dgate)


def _check(q, k, v, bias, gate):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share a [B,H,T,D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    d = q.shape[-1]
    if d % 16:
        raise ValueError(f"head_dim {d} unsupported: a multiple of 16 is "
                         f"required")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {q.dtype} unsupported (float32, bfloat16)")
    if gate is not None and bias is None:
        raise ValueError("gate requires bias")
    b, h, t, _ = q.shape
    if bias is not None and tuple(bias.shape) != (h, t, t):
        raise ValueError(f"bias must be [H,T,T]={h, t, t}, got "
                         f"{tuple(bias.shape)}")
    if gate is not None and tuple(gate.shape) != (b, h, t):
        raise ValueError(f"gate must be [B,H,T]={b, h, t}, got "
                         f"{tuple(gate.shape)}")


def _seed_tensor(seed, device) -> Optional[torch.Tensor]:
    """The seed as one int32 on ``device`` (a tensor stays where it is
    when it already lies there, so no host sync)."""
    if seed is None:
        return None
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1:
            raise ValueError(f"dropout_seed must hold one value, got shape "
                             f"{tuple(seed.shape)}")
        return seed.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(seed)], dtype=torch.int32, device=device)


def _dropout_args(dropout_rate: float, dropout_seed):
    """(seed tensor or None, threshold, scale) for the launchers; the seed
    is the one-element int32 tensor on the card that :func:`check_entry`
    made, passed on as it is."""
    if dropout_rate <= 0.0:
        return None, 0, 1.0
    return dropout_seed, keep_threshold(dropout_rate), keep_scale(dropout_rate)


def launch_kernel(q, k, v, bias=None, gate=None, kv_len=None,
                  return_lse: bool = False, dropout_rate: float = 0.0,
                  dropout_seed=None, scale: Optional[float] = None):
    """Run the forward on CUDA tensors: the route :func:`forward_route`
    names, with no fallback from one to another (each route counted where
    it launches: ``mma_fwd_launches``, ``mma_bias_fwd_launches``,
    ``mma64_fwd_launches``, ``mma128_fwd_launches``,
    ``wgmma64_fwd_launches``, ``wgmma128_fwd_launches``,
    ``wide_fwd_launches``, ``fused_fwd_launches``); with ``return_lse``
    also the row LSE [B, H, T]
    f32; with ``dropout_rate`` > 0 the in-kernel dropout (K6) of
    ``dropout_seed``, a one-element int32 tensor on q's device; ``scale``
    of the scores, 1/√d when None."""
    _check(q, k, v, bias, gate)
    if not q.is_cuda:
        raise ValueError("launch_kernel needs CUDA tensors")
    b, h, t, d = q.shape
    scale = _scale(q, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kv = _prep_kv_len(kv_len, b, t, q.device)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    seed, thr, drop_scale = _dropout_args(dropout_rate, dropout_seed)
    route = forward_route(d, bias is not None, q.dtype)
    if bias is not None:
        bias = bias.to(q.dtype).contiguous()
    if gate is not None:
        gate = gate.float().contiguous()
    if route == "mma":
        out = _launch_mma_fwd(q, k, v, kv, lse, seed, thr, drop_scale,
                              scale)
    elif route == "mma_bias":
        out = _launch_mma_bias_fwd(q, k, v, bias, gate, kv, lse, seed, thr,
                                   drop_scale, scale)
    elif route == "mma64":
        out = _launch_mma64_fwd(q, k, v, kv, lse, seed, thr, drop_scale,
                                scale)
    elif route == "mma128":
        out = _launch_mma128_fwd(q, k, v, kv, lse, seed, thr, drop_scale,
                                 scale)
    elif route in ("wgmma64", "wgmma128"):
        out = _launch_wgmma_fwd(route, q, k, v, kv, lse, seed, thr,
                                drop_scale, scale)
    elif route == "wide":
        out = _launch_wide_fwd(q, k, v, bias, gate, kv, lse, seed, thr,
                               drop_scale, scale)
    else:
        out = _launch_fused_fwd(q, k, v, bias, gate, kv, lse, seed, thr,
                                drop_scale, scale)
    return (out, lse) if return_lse else out


def _launch_fused_fwd(q, k, v, bias, gate, kv, lse, seed, thr, drop_scale,
                      scale=None):
    """The forwards of ``csrc/flash_attention.cu`` (route ``"fused"``) on
    the tensors :func:`launch_kernel` has checked and laid out (bias in q's
    dtype or None, gate f32 or None; any head width up to 512); writes
    ``lse`` when it is not None. Returns out in q's dtype."""
    global fused_fwd_launches
    b, h, t, d = q.shape
    lib = _build.library("flash_attention")
    out = torch.empty_like(q)
    err = lib.wfl_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(gate),
        kv.data_ptr(), out.data_ptr(), _ptr(lse), _ptr(seed), b, h, t, d,
        _scale(q, scale), thr, drop_scale, _dtype_code(q),
        _build.stream_ptr(q.device))
    _build.check(lib, err, "flash_attention")
    fused_fwd_launches += 1
    return out


def _launch_mma_fwd(q, k, v, kv, lse, seed, thr, drop_scale, scale=None):
    """The bias-free tensor-core forward of ``csrc/attention_fwd_mma.cu``
    on the tensors :func:`launch_kernel` has checked and laid out (the
    launcher itself refuses a bias and a head_dim outside (128, 512]);
    writes ``lse`` when it is not None. Returns out in q's dtype."""
    global mma_fwd_launches
    b, h, t, d = q.shape
    lib = _build.library("attention_fwd_mma")
    out = torch.empty_like(q)
    err = lib.wfl_attention_fwd_mma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, kv.data_ptr(),
        out.data_ptr(), _ptr(lse), _ptr(seed), b, h, t, d, _scale(q, scale),
        thr, drop_scale, _dtype_code(q), _build.stream_ptr(q.device))
    _build.check(lib, err, "attention_fwd_mma")
    mma_fwd_launches += 1
    return out


def _fwd_bias_mma(q, k, v, bias, gate, kv, lse, seed, thr, drop_scale,
                  scale):
    """The tensor-core forward of ``csrc/attention_fwd_bias_mma.cu`` at
    head_dim 64 (bias in q's dtype or None, gate f32 or None) or bias-free
    at 128 (the launcher itself refuses other widths, a bias at 128 and a
    gate without a bias); writes ``lse`` when it is not None. Returns out in
    q's dtype; counts nothing."""
    b, h, t, d = q.shape
    lib = _build.library("attention_fwd_bias_mma")
    out = torch.empty_like(q)
    err = lib.wfl_attention_fwd_bias_mma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(gate),
        kv.data_ptr(), out.data_ptr(), _ptr(lse), _ptr(seed), b, h, t, d,
        _scale(q, scale), thr, drop_scale, _dtype_code(q),
        _build.stream_ptr(q.device))
    _build.check(lib, err, "attention_fwd_bias_mma")
    return out


def _launch_mma_bias_fwd(q, k, v, bias, gate, kv, lse, seed, thr,
                         drop_scale, scale=None):
    """The tensor-core forward with a bias of
    ``csrc/attention_fwd_bias_mma.cu`` on the tensors :func:`launch_kernel`
    has checked and laid out (bias in q's dtype, gate f32 or None, head_dim
    64); writes ``lse`` when it is not None. Returns out in q's dtype."""
    global mma_bias_fwd_launches
    out = _fwd_bias_mma(q, k, v, bias, gate, kv, lse, seed, thr, drop_scale,
                        scale)
    mma_bias_fwd_launches += 1
    return out


def _pad_to(width: int, *xs):
    """Zero-pad [B, H, T, d] tensors on D to ``width`` (zero columns add
    nothing to q·kᵀ and give zero output and gradient columns),
    contiguous."""
    return [F.pad(x, (0, width - x.shape[-1])).contiguous() for x in xs]


def _bias_free_fwd(width, q, k, v, kv, lse, seed, thr, drop_scale, scale):
    """The bias-free instantiation of the tensor-core forward of
    ``csrc/attention_fwd_bias_mma.cu`` at head width ``width`` (64 or 128)
    on q, k, v no wider, zero-padded to it here and scaled by q's own 1/√d
    when ``scale`` is None; writes ``lse`` when it is not None. Returns out
    in q's dtype and width; counts nothing."""
    scale, d = _scale(q, scale), q.shape[-1]
    if d < width:
        q, k, v = _pad_to(width, q, k, v)
    out = _fwd_bias_mma(q, k, v, None, None, kv, lse, seed, thr, drop_scale,
                        scale)
    return out[..., :d] if d < width else out


def _launch_mma64_fwd(q, k, v, kv, lse, seed, thr, drop_scale, scale=None):
    """Route ``"mma64"``: the bias-free D = 64 forward on the tensors
    :func:`launch_kernel` has checked and laid out, at head_dim ≤ 64
    (:func:`_bias_free_fwd`)."""
    global mma64_fwd_launches
    out = _bias_free_fwd(MMA_BIAS_D, q, k, v, kv, lse, seed, thr, drop_scale,
                         scale)
    mma64_fwd_launches += 1
    return out


def _launch_mma128_fwd(q, k, v, kv, lse, seed, thr, drop_scale, scale=None):
    """Route ``"mma128"``: the bias-free D = 128 forward on the tensors
    :func:`launch_kernel` has checked and laid out, at head_dim 80-128
    (:func:`_bias_free_fwd`)."""
    global mma128_fwd_launches
    out = _bias_free_fwd(MMA128_D, q, k, v, kv, lse, seed, thr, drop_scale,
                         scale)
    mma128_fwd_launches += 1
    return out


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it where its data does not start on 16 bytes (a TMA
    tensor map and the 16-byte loads need that)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


WGMMA_WIDTH = {"wgmma64": MMA_BIAS_D, "wgmma128": MMA128_D}


def _launch_wgmma_fwd(route, q, k, v, kv, lse, seed, thr, drop_scale,
                      scale=None):
    """Routes ``"wgmma64"`` and ``"wgmma128"``: the bf16 wgmma forward of
    ``csrc/attention_wgmma.cu`` at head width 64 or 128 on the tensors
    :func:`launch_kernel` has checked and laid out, at their own width (a
    multiple of 16 up to it: the tensor maps zero-fill the rest, nothing
    is padded here), scaled by q's 1/√d when ``scale`` is None; writes
    ``lse`` when it is not None. Returns out in q's dtype and width."""
    global wgmma64_fwd_launches, wgmma128_fwd_launches
    b, h, t, d = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    lib = _build.library("attention_wgmma")
    out = torch.empty_like(q)
    err = lib.wfl_attention_wgmma_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(),
        out.data_ptr(), _ptr(lse), _ptr(seed), b, h, t, d,
        WGMMA_WIDTH[route], _scale(q, scale), thr, drop_scale,
        _build.stream_ptr(q.device))
    _build.check(lib, err, f"attention_wgmma forward ({route})")
    if route == "wgmma64":
        wgmma64_fwd_launches += 1
    else:
        wgmma128_fwd_launches += 1
    return out


def _launch_wide_fwd(q, k, v, bias, gate, kv, lse, seed, thr, drop_scale,
                     scale=None):
    """The cluster forward of ``csrc/attention_wide.cu`` on the
    tensors :func:`launch_kernel` has checked and laid out (bias in q's
    dtype or None, gate f32 or None; the launcher itself refuses a head_dim
    of 512 or less); writes ``lse`` when it is not None. Returns out in q's
    dtype."""
    global wide_fwd_launches
    b, h, t, d = q.shape
    lib = _build.library("attention_wide")
    out = torch.empty_like(q)
    err = lib.wfl_attention_wide_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(gate),
        kv.data_ptr(), out.data_ptr(), _ptr(lse), _ptr(seed), b, h, t, d,
        _scale(q, scale), thr, drop_scale, _dtype_code(q),
        _build.stream_ptr(q.device))
    _build.check(lib, err, "attention_wide")
    wide_fwd_launches += 1
    return out


def _ptr(x: Optional[torch.Tensor]):
    return x.data_ptr() if x is not None else None


def _dtype_code(q: torch.Tensor) -> int:
    return 0 if q.dtype == torch.float32 else 1


def launch_backward(q, k, v, bias, gate, kv_len, out, lse, dout,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    scale: Optional[float] = None):
    """Run the backward passes on CUDA tensors: the route
    :func:`backward_route` names, with no fallback from one to another,
    each counted where it launches (``mma_bias_bwd_launches``,
    ``mma_bwd_launches``, ``mma64_bwd_launches``, ``mma128_bwd_launches``,
    ``wgmma64_bwd_launches``, ``wgmma128_bwd_launches``,
    ``wide_bwd_launches``, ``fma_bwd_launches``). Same contract as
    :func:`attention_backward_plain`; ``delta = rowsum(dO·O)`` is the
    wgmma routes' pre-pass kernel, and a plain f32 torch op on the others,
    as the JAX package leaves it to XLA."""
    _check(q, k, v, bias, gate)
    if not q.is_cuda:
        raise ValueError("launch_backward needs CUDA tensors")
    b, h, t, d = q.shape
    scale = _scale(q, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dout = dout.to(q.dtype).contiguous()
    kv = _prep_kv_len(kv_len, b, t, q.device)
    lse = lse.contiguous()
    seed, thr, drop_scale = _dropout_args(dropout_rate, dropout_seed)
    route = backward_route(d, bias is not None, q.dtype)
    if route in ("wgmma64", "wgmma128"):
        dq, dk, dv = _launch_wgmma(route, q, k, v, out, dout, lse, kv, seed,
                                   thr, drop_scale, scale)
        return dq, dk, dv, None, None
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    if route in ("mma", "mma64", "mma128"):
        launch = {"mma": _launch_mma, "mma64": _launch_mma64,
                  "mma128": _launch_mma128}[route]
        dq, dk, dv = launch(q, k, v, dout, lse, delta, kv, seed, thr,
                            drop_scale, scale)
        return dq, dk, dv, None, None
    if bias is not None:
        bias = bias.to(q.dtype).contiguous()
    if gate is not None:
        gate = gate.float().contiguous()
    if route == "mma_bias":
        return _launch_mma_bias(q, k, v, bias, gate, dout, lse, delta, kv,
                                seed, thr, drop_scale, scale)
    if route == "wide":
        return _launch_wide(q, k, v, bias, gate, dout, lse, delta, kv, seed,
                            thr, drop_scale, scale)
    return _launch_fma(q, k, v, bias, gate, dout, lse, delta, kv, seed, thr,
                       drop_scale, scale)


def _launch_fma(q, k, v, bias, gate, dout, lse, delta, kv, seed, thr,
                drop_scale, scale=None):
    """The FMA pair of ``csrc/flash_attention.cu`` (route ``"fma"``: dK/dV;
    dQ with dGate and dBias) on the tensors :func:`launch_backward` has
    checked and laid out (bias in q's dtype or None, gate f32 or None; any
    head width up to 512). Returns (dq, dk, dv, dbias, dgate) as
    :func:`_launch_mma_bias` does, dbias and dgate None where there is no
    bias or gate."""
    global fma_bwd_launches
    b, h, t, d = q.shape
    lib = _build.library("flash_attention")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = (torch.zeros((h, t, t), dtype=torch.float32, device=q.device)
             if bias is not None else None)
    dgate = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
             if gate is not None else None)
    err = lib.wfl_flash_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
             _ptr(gate), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             kv.data_ptr(), _ptr(seed), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), _ptr(dgate), _ptr(dbias), b, h, t, d,
             _scale(q, scale), thr, drop_scale, _dtype_code(q),
             _build.stream_ptr(q.device))
    _build.check(lib, err, "flash_attention backward")
    fma_bwd_launches += 1
    return dq, dk, dv, dbias, dgate


def _launch_mma(q, k, v, dout, lse, delta, kv, seed, thr, drop_scale,
                scale=None):
    """The bias-free tensor-core backward pair of
    ``csrc/attention_bwd_mma.cu`` on the tensors :func:`launch_backward`
    has checked and laid out (the launcher itself refuses a head_dim
    outside (128, 512]). The dK/dV pass leaves dS in a [B, H, T,
    ⌈T/32⌉·32] workspace of q's dtype for the dQ pass. Returns (dq, dk,
    dv) in q's dtype."""
    global mma_bwd_launches
    b, h, t, d = q.shape
    lib = _build.library("attention_bwd_mma")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ldk = -(-t // 32) * 32
    ds = torch.empty((b, h, t, ldk), dtype=q.dtype, device=q.device)
    err = lib.wfl_attention_bwd_mma(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), kv.data_ptr(), _ptr(seed),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ds.data_ptr(), b,
             h, t, d, ldk, _scale(q, scale), thr, drop_scale,
             _dtype_code(q), _build.stream_ptr(q.device))
    _build.check(lib, err, "attention_bwd_mma")
    mma_bwd_launches += 1
    return dq, dk, dv


def _bwd_bias_mma(q, k, v, bias, gate, dout, lse, delta, kv, seed, thr,
                  drop_scale, scale):
    """The tensor-core passes of ``csrc/attention_bwd_bias_mma.cu`` at
    head_dim 64 (bias in q's dtype or None, gate f32 or None) or bias-free
    at 128 (the launcher itself refuses other widths and a bias at 128).
    The dK/dV pass leaves dS in a [B, H, T, ⌈T/64⌉·64] workspace of q's
    dtype, which the dQ pass and, with a bias, the dBias/dGate pass read. Returns (dq, dk, dv, dbias, dgate):
    dq/dk/dv in q's dtype, dbias [H, T, T] (None without bias) and dgate
    [B, H, T] (None without gate) in f32; counts nothing."""
    b, h, t, d = q.shape
    lib = _build.library("attention_bwd_bias_mma")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ldk = -(-t // 64) * 64
    ds = torch.empty((b, h, t, ldk), dtype=q.dtype, device=q.device)
    dbias = (torch.empty((h, t, t), dtype=torch.float32, device=q.device)
             if bias is not None else None)
    dgate = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
             if gate is not None else None)
    err = lib.wfl_attention_bwd_bias_mma(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
             _ptr(gate), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             kv.data_ptr(), _ptr(seed), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), ds.data_ptr(), _ptr(dbias), _ptr(dgate), b, h, t,
             d, ldk, _scale(q, scale), thr, drop_scale, _dtype_code(q),
             _build.stream_ptr(q.device))
    _build.check(lib, err, "attention_bwd_bias_mma")
    return dq, dk, dv, dbias, dgate


def _launch_mma_bias(q, k, v, bias, gate, dout, lse, delta, kv, seed, thr,
                     drop_scale, scale=None):
    """The tensor-core backward with a bias of
    ``csrc/attention_bwd_bias_mma.cu`` on the tensors
    :func:`launch_backward` has checked and laid out (bias in q's dtype,
    gate f32 or None, head_dim 64): dK/dV, dQ and dBias/dGate. Returns (dq,
    dk, dv, dbias, dgate): dq/dk/dv in q's dtype, dbias [H, T, T] and dgate
    [B, H, T] (None without gate) in f32."""
    global mma_bias_bwd_launches
    grads = _bwd_bias_mma(q, k, v, bias, gate, dout, lse, delta, kv, seed,
                          thr, drop_scale, scale)
    mma_bias_bwd_launches += 1
    return grads


def _bias_free_bwd(width, q, k, v, dout, lse, delta, kv, seed, thr,
                   drop_scale, scale):
    """The bias-free instantiation of the tensor-core passes (dK/dV, dQ) of
    ``csrc/attention_bwd_bias_mma.cu`` at head width ``width`` (64 or 128)
    on inputs no wider, zero-padded to it here and scaled by q's own 1/√d
    when ``scale`` is None. Returns (dq, dk, dv) in q's dtype and width;
    counts nothing."""
    scale, d = _scale(q, scale), q.shape[-1]
    if d < width:
        q, k, v, dout = _pad_to(width, q, k, v, dout)
    dq, dk, dv, _, _ = _bwd_bias_mma(q, k, v, None, None, dout, lse, delta,
                                     kv, seed, thr, drop_scale, scale)
    if d < width:
        return dq[..., :d], dk[..., :d], dv[..., :d]
    return dq, dk, dv


def _launch_mma64(q, k, v, dout, lse, delta, kv, seed, thr, drop_scale,
                  scale=None):
    """Route ``"mma64"``: the bias-free D = 64 passes on the tensors
    :func:`launch_backward` has checked and laid out, at head_dim ≤ 64
    (:func:`_bias_free_bwd`)."""
    global mma64_bwd_launches
    grads = _bias_free_bwd(MMA_BIAS_D, q, k, v, dout, lse, delta, kv, seed,
                           thr, drop_scale, scale)
    mma64_bwd_launches += 1
    return grads


def _launch_mma128(q, k, v, dout, lse, delta, kv, seed, thr, drop_scale,
                   scale=None):
    """Route ``"mma128"``: the bias-free D = 128 passes on the tensors
    :func:`launch_backward` has checked and laid out, at head_dim 80-128
    (:func:`_bias_free_bwd`)."""
    global mma128_bwd_launches
    grads = _bias_free_bwd(MMA128_D, q, k, v, dout, lse, delta, kv, seed,
                           thr, drop_scale, scale)
    mma128_bwd_launches += 1
    return grads


def _launch_wgmma(route, q, k, v, out, dout, lse, kv, seed, thr,
                  drop_scale, scale=None):
    """Routes ``"wgmma64"`` and ``"wgmma128"``: the bf16 backward on the
    tensors :func:`launch_backward` has checked and laid out (out the
    forward's, all at their own width, a multiple of 16 up to 64 or 128),
    three launches in turn: the pre-pass of ``csrc/attention_wgmma.cu``
    (delta = rowsum(dO·O) and LSE·log2(e) into a [2, B·H, ⌈T/64⌉·64] f32
    workspace), its wgmma dK/dV pass (dS into a [B, H, T, ⌈T/64⌉·64]
    workspace), and the dQ pass of ``csrc/attention_bwd_bias_mma.cu``
    (``wfl_attention_bwd_dq_mma``), which reads K at head width 64 or 128:
    K alone is zero-padded for it where the heads are narrower, and dQ
    sliced back. Returns (dq, dk, dv) in q's dtype and width."""
    global wgmma64_bwd_launches, wgmma128_bwd_launches
    b, h, t, d = q.shape
    width, scale = WGMMA_WIDTH[route], _scale(q, scale)
    q, k, v, out, dout = (_aligned(x) for x in (q, k, v, out.contiguous(),
                                                dout))
    stream = _build.stream_ptr(q.device)
    lib = _build.library("attention_wgmma")
    ws = torch.empty((2, b * h, -(-t // 64) * 64), dtype=torch.float32,
                     device=q.device)
    err = lib.wfl_attention_wgmma_delta(out.data_ptr(), dout.data_ptr(),
                                        lse.data_ptr(), ws.data_ptr(), b, h,
                                        t, d, stream)
    _build.check(lib, err, f"attention_wgmma delta ({route})")
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    ldk = -(-t // 64) * 64
    ds = torch.empty((b, h, t, ldk), dtype=q.dtype, device=q.device)
    err = lib.wfl_attention_wgmma_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        ws.data_ptr(), kv.data_ptr(), _ptr(seed), dk.data_ptr(),
        dv.data_ptr(), ds.data_ptr(), b, h, t, d, width, ldk, scale, thr,
        drop_scale, stream)
    _build.check(lib, err, f"attention_wgmma dK/dV ({route})")
    kw = k if d == width else F.pad(k, (0, width - d))
    dq = torch.empty_like(kw)
    qlib = _build.library("attention_bwd_bias_mma")
    err = qlib.wfl_attention_bwd_dq_mma(kw.data_ptr(), kv.data_ptr(),
                                        ds.data_ptr(), dq.data_ptr(), b, h,
                                        t, width, ldk, scale,
                                        _dtype_code(q), stream)
    _build.check(qlib, err, f"attention_bwd_bias_mma dQ ({route})")
    if route == "wgmma64":
        wgmma64_bwd_launches += 1
    else:
        wgmma128_bwd_launches += 1
    return (dq if d == width else dq[..., :d]), dk, dv


def _launch_wide(q, k, v, bias, gate, dout, lse, delta, kv, seed, thr,
                 drop_scale, scale=None):
    """The backward of ``csrc/attention_wide.cu`` on the tensors
    :func:`launch_backward` has checked and laid out (bias in q's dtype or
    None, gate f32 or None; the launcher itself refuses a head_dim of 512
    or less): its dK/dV pass leaves dS in a [B, H, T, ⌈T/64⌉·64] workspace
    of q's dtype, which its dQ pass reads and, with a bias, the dBias/dGate
    pass of ``csrc/attention_bwd_bias_mma.cu``. Returns (dq, dk, dv, dbias,
    dgate) as :func:`_launch_mma_bias` does (dbias None without bias)."""
    global wide_bwd_launches
    b, h, t, d = q.shape
    lib = _build.library("attention_wide")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ldk = -(-t // 64) * 64
    ds = torch.empty((b, h, t, ldk), dtype=q.dtype, device=q.device)
    stream = _build.stream_ptr(q.device)
    err = lib.wfl_attention_wide_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
             _ptr(gate), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             kv.data_ptr(), _ptr(seed), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), ds.data_ptr(), b, h, t, d, ldk, _scale(q, scale),
             thr, drop_scale, _dtype_code(q), stream)
    _build.check(lib, err, "attention_wide backward")
    dbias = dgate = None
    if bias is not None:
        dbias = torch.empty((h, t, t), dtype=torch.float32, device=q.device)
        dgate = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
                 if gate is not None else None)
        blib = _build.library("attention_bwd_bias_mma")
        err = blib.wfl_attention_bias_dbias(ds.data_ptr(), bias.data_ptr(), _ptr(gate), kv.data_ptr(),
                 dbias.data_ptr(), _ptr(dgate), b, h, t, ldk,
                 _dtype_code(q), stream)
        _build.check(blib, err, "attention_bias_dbias")
    wide_bwd_launches += 1
    return dq, dk, dv, dbias, dgate


def attention_forward(ctx, q, k, v, bias, gate, kv_len, dropout_rate=0.0,
                      seed=None, scale=None) -> torch.Tensor:
    """The forward of both autograd Functions: the kernel on CUDA, the
    plain twin on the CPU. The LSE is made, and everything the backward
    reads is saved (the seed tensor too, as JAX keeps it as a residual),
    only when autograd will need it."""
    want_lse = any(ctx.needs_input_grad[:5])
    fn = launch_kernel if q.is_cuda else attention_plain
    res = fn(q, k, v, bias, gate, kv_len, return_lse=want_lse,
             dropout_rate=dropout_rate, dropout_seed=seed, scale=scale)
    out, lse = res if want_lse else (res, None)
    if want_lse:
        b, _, t, _ = q.shape
        ctx.dropout_rate, ctx.scale = dropout_rate, scale
        ctx.save_for_backward(q, k, v, bias, gate,
                              _prep_kv_len(kv_len, b, t, q.device), out, lse,
                              seed)
    return out


def attention_backward(ctx, dout):
    """(dq, dk, dv, dbias, dgate) for the saved inputs: the backward
    kernels on CUDA (the pair :func:`backward_route` names), the plain twin
    on the CPU. dBias comes back in the bias's dtype, dGate in f32."""
    q, k, v, bias, gate, kv, out, lse, seed = ctx.saved_tensors
    fn = launch_backward if q.is_cuda else attention_backward_plain
    dq, dk, dv, dbias, dgate = fn(q, k, v, bias, gate, kv, out, lse, dout,
                                  dropout_rate=ctx.dropout_rate,
                                  dropout_seed=seed, scale=ctx.scale)
    if dbias is not None:
        dbias = dbias.to(bias.dtype)
    return dq, dk, dv, dbias, dgate


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, gate, kv_len, dropout_rate, seed,
                scale):
        global launches, dropout_launches
        out = attention_forward(ctx, q, k, v, bias, gate, kv_len,
                                dropout_rate, seed, scale)
        launches += q.is_cuda
        dropout_launches += q.is_cuda and dropout_rate > 0.0
        return out

    @staticmethod
    def backward(ctx, dout):
        global bwd_launches, dropout_bwd_launches
        grads = attention_backward(ctx, dout)
        bwd_launches += dout.is_cuda
        dropout_bwd_launches += dout.is_cuda and ctx.dropout_rate > 0.0
        return (*grads, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    gate: Optional[torch.Tensor] = None,
                    kv_len=None, dropout_rate: float = 0.0,
                    dropout_seed=None, origin=(0, 0)) -> torch.Tensor:
    """q, k, v: [B, H, T, D] → [B, H, T, D]. bias: [H, T, T] or None;
    gate: [B, H, T] or None (requires bias); kv_len: [B] or None (= T).

    ``dropout_rate`` in [0, 1) and ``dropout_seed`` (a Python int, or an
    int32 tensor of one element on q's device): strict attention dropout
    with torch semantics (K6), its mask a hash of (seed, b, h, q, k).
    ``origin`` (b0, h0): the global index of this call's first row and
    first head when it runs on a shard of a larger batch or of the heads
    (:func:`shard_seed`), so that its mask is the shard of the unsharded
    call's.

    A CUDA tensor runs the kernels, a CPU tensor the plain twins; both are
    differentiable in every tensor argument but ``kv_len``. Any head width
    (:func:`pad_head_dim`)."""
    q, k, v, d, scale = pad_head_dim(q, k, v)
    rate, seed = check_entry(q, k, v, bias, gate, dropout_rate, dropout_seed,
                             origin)
    return _FlashAttention.apply(q, k, v, bias, gate, kv_len, rate, seed,
                                 scale)[..., :d]


def shard_seed(seed: torch.Tensor, origin) -> torch.Tensor:
    """The seed of a shard whose first row and head are ``origin`` =
    (b0, h0) in the unsharded call: seed + b0·C_B + h0·C_H in uint32
    wraparound (the JAX ``core``'s offset, flash_attention.py:707-721). The
    hash's pre-mix is linear in b and h (``dropout_mask.uniform24``), so a
    shard's local indices then hash as the global ones do, on the kernels
    and on the plain twins alike."""
    b0, h0 = (int(o) for o in origin)
    if not b0 and not h0:
        return seed
    off = (b0 * C_B + h0 * C_H) & 0xFFFFFFFF
    u = (seed.to(torch.int64) + off) & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def check_entry(q, k, v, bias, gate, dropout_rate: float, dropout_seed,
                origin=(0, 0)):
    """The checks of both entry points: shapes, dtype, device, the dropout
    rate in [0, 1) with a seed when it is above 0. Returns (rate, the seed
    as an int32 tensor of one element on q's device, offset by the shard
    ``origin`` (:func:`shard_seed`), or None at rate 0)."""
    rate = check_rate(dropout_rate)
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    _check(q, k, v, bias, gate)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if rate == 0.0:
        return rate, None
    return rate, shard_seed(_seed_tensor(dropout_seed, q.device), origin)
