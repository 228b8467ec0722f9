"""Hand-written CUDA kernels (sm_90a) for the TPU kernels of the inference
and training paths, each beside its plain PyTorch twin.

| port module                 | kernel source               | TPU kernels replaced (``ops/pallas/``)                                   |
| --------------------------- | --------------------------- | ------------------------------------------------------------------------ |
| ``flash_attention``         | ``csrc/attention_fwd_bias_mma.cu`` | ``flash_attention.py``: ``_flash_kernel`` (head_dim 64)               |
| ``flash_attention``         | ``csrc/flash_attention.cu`` | ``flash_attention.py``: ``_flash_kernel``, ``_bwd_dkdv_kernel``, ``_bwd_dq_kernel`` (head widths up to 512 other than 64) |
| ``flash_attention``         | ``csrc/attention_bwd_bias_mma.cu`` | ``flash_attention.py``: ``_bwd_dkdv_kernel``, ``_bwd_dq_kernel`` (head_dim 64; its dBias/dGate pass also above 512) |
| ``flash_attention``         | ``csrc/attention_wide.cu``  | ``flash_attention.py``: ``_flash_kernel``, ``_bwd_dkdv_kernel``, ``_bwd_dq_kernel`` (head_dim > 512) |
| ``flash_attention_bwd``     | ``csrc/attention_fwd_bias_mma.cu`` | ``flash_attention_bwd.py``: ``_fwd_kernel`` (f32, head_dim ≤ 128, its bias-free instantiations at 64 and 128) |
| ``flash_attention_bwd``     | ``csrc/attention_bwd_bias_mma.cu`` | ``flash_attention_bwd.py``: ``_bwd_dkdv_kernel`` (f32), ``_bwd_dq_kernel`` (head_dim ≤ 128, bias-free, at 64 and 128) |
| ``flash_attention_bwd``     | ``csrc/attention_wgmma.cu`` | ``flash_attention_bwd.py``: ``_fwd_kernel``, ``_bwd_dkdv_kernel`` (bf16, head_dim ≤ 128: wgmma and TMA, ``csrc/hopper.cuh``) |
| ``flash_attention_bwd``     | ``csrc/attention_fwd_mma.cu`` | ``flash_attention_bwd.py``: ``_fwd_kernel`` (128 < head_dim ≤ 512)     |
| ``flash_attention_bwd``     | ``csrc/attention_bwd_mma.cu`` | ``flash_attention_bwd.py``: ``_bwd_dkdv_kernel``, ``_bwd_dq_kernel`` (128 < head_dim ≤ 512) |
| ``flash_attention_bwd``     | ``csrc/attention_wide.cu``  | ``flash_attention_bwd.py``: ``_fwd_kernel``, ``_bwd_dkdv_kernel``, ``_bwd_dq_kernel`` (head_dim > 512) |
| ``conv_fused``              | ``csrc/conv_fused.cu``      | ``conv_fused.py``: ``_kernel``, ``_kernel_packed`` (one launch a layer)  |
| ``dropout_mask``            | ``csrc/common.cuh``         | ``dropout_mask.py``: ``uniform24``, ``keep_mask_f32`` (inside the attention kernels) |

Sources build with ``nvcc`` at first use (``_build.py``); importing these
modules needs no CUDA.
"""

KERNEL_SOURCES = ("flash_attention", "attention_fwd_mma",
                  "attention_fwd_bias_mma", "attention_bwd_mma",
                  "attention_bwd_bias_mma", "attention_wide",
                  "attention_wgmma", "conv_fused")


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from . import conv_fused, flash_attention, flash_attention_bwd
    for mod in (flash_attention, flash_attention_bwd):
        mod.launches = mod.bwd_launches = 0
        mod.dropout_launches = mod.dropout_bwd_launches = 0
    flash_attention.fma_bwd_launches = flash_attention.mma_bwd_launches = 0
    flash_attention.mma_bias_bwd_launches = 0
    flash_attention.mma_fwd_launches = 0
    flash_attention.mma_bias_fwd_launches = 0
    flash_attention.fused_fwd_launches = 0
    flash_attention.mma64_fwd_launches = flash_attention.mma64_bwd_launches = 0
    flash_attention.mma128_fwd_launches = 0
    flash_attention.mma128_bwd_launches = 0
    flash_attention.wide_fwd_launches = flash_attention.wide_bwd_launches = 0
    flash_attention.wgmma64_fwd_launches = 0
    flash_attention.wgmma64_bwd_launches = 0
    flash_attention.wgmma128_fwd_launches = 0
    flash_attention.wgmma128_bwd_launches = 0
    conv_fused.launches.clear()
    conv_fused.layer_launches = 0
