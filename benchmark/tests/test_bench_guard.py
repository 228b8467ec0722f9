from benchmark.core.guard import forbidden_modules


def test_the_port_passes():
    assert forbidden_modules(["wfl_asr_tpu_torch", "wfl_asr_tpu_torch.models",
                              "wfl_asr_tpu_torch.ops.kernels", "torch",
                              "jaxtyping", "flaxen"]) == []


def test_the_jax_package_and_jax_fail():
    assert forbidden_modules(["wfl_asr_tpu.models"]) == ["wfl_asr_tpu"]
    assert forbidden_modules(["wfl_asr_tpu"]) == ["wfl_asr_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                              "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_this_process_reads_sys_modules():
    import sys
    found = forbidden_modules()
    tops = {m.split(".")[0] for m in sys.modules}
    assert set(found) == tops & {"jax", "jaxlib", "flax", "wfl_asr_tpu"}
