"""End-to-end parity of the PyTorch port with the JAX package on the CPU:
the same ``.pt`` (written by ``wfl_asr_tpu.checkpoint``) and the same wavs
through both pipelines must give byte-identical ``.lab`` files — short,
chunked (> 30 s) and batched-folder with the device decode. Also the
port's rules: no JAX import, and CUDA unless the caller asks for the CPU.

The model is the tiny test width with WavLM-base's full conv recipe
(kernels 10,3,3,3,3,2,2, strides 5,2,2,2,2,2,2 → 20 ms frames), set through
``model.encoder_arch_overrides``, so 30 s chunks are 1499 frames and the
feature encoder runs both fused conv chains."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax

from wfl_asr_tpu.config import Config as JaxConfig
from wfl_asr_tpu.data.audio import write_wav
from wfl_asr_tpu.models.tagger import TaggerArch as JaxTaggerArch
from wfl_asr_tpu.models.tagger import init_tagger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARCH_OVERRIDES = dict(
    hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    conv_dim=[32] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
    conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, num_buckets=40, max_distance=100)
LABELS = sorted([f"B-p{i}" for i in range(4)] + [f"I-p{i}" for i in range(4)]
                + ["O", "B-SP", "I-SP"])


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def make_run(tmp_path, name, device_decode=False, median=3):
    """save_dir with phonemes.txt/langs.txt, config.yaml and a JAX-written
    random-init checkpoint. Returns (config_path, ckpt_path)."""
    save_dir = tmp_path / f"save_{name}"
    save_dir.mkdir()
    (save_dir / "phonemes.txt").write_text("\n".join(LABELS) + "\n")
    (save_dir / "langs.txt").write_text("en,0\nja,1\n")
    config = {
        "data": {"sample_rate": 16000, "frame_duration": 0.02},
        "model": {
            "encoder_type": "wavlm",
            "wavlm_model": "microsoft/wavlm-base-plus",
            "encoder_arch_overrides": ARCH_OVERRIDES,
            "num_languages": 2, "lang_emb_dim": 16,
            "enable_bilstm": True, "bilstm_num_layer": 2,
            "num_conformer_layers": 2, "conformer_heads": 2,
            "conformer_ff_expansion": 2, "conformer_kernel_size": 31,
            "conformer_dropout": 0.15, "enable_dilated_conv": True,
            "dilated_conv_depth": 2, "dilated_conv_kernel": 3},
        "output": {"save_dir": str(save_dir)},
        "postprocess": {"median_filter": median, "merge_segments": "right",
                        "device_decode": device_decode},
    }
    config_path = save_dir / "config.yaml"
    config_path.write_text(yaml.dump(config, sort_keys=False))
    arch = JaxTaggerArch.from_config(JaxConfig(config), len(LABELS))
    params, state = init_tagger(jax.random.PRNGKey(7), arch)
    from wfl_asr_tpu.checkpoint import save_model_checkpoint
    ckpt = str(save_dir / "best_model.pt")
    save_model_checkpoint(ckpt, params, state, arch)
    return str(config_path), ckpt


def _twin_dirs(tmp_path, name, audios, txt=None):
    dirs = []
    for side in ("jax", "port"):
        d = tmp_path / f"{side}_{name}"
        d.mkdir()
        for fname, audio in audios.items():
            write_wav(str(d / fname), audio, 16000)
            if txt is not None:
                (d / fname.replace(".wav", ".txt")).write_text(txt)
        dirs.append(d)
    return dirs


def _nonempty_same(a, b):
    text_a, text_b = open(a).read(), open(b).read()
    assert text_a.strip(), "empty .lab: the comparison would be vacuous"
    assert text_a == text_b


@pytest.mark.parametrize("lang_id", [1, None])
def test_lab_parity_short(tmp_path, lang_id):
    from wfl_asr_tpu.infer import infer_audio as jax_infer
    from wfl_asr_tpu_torch.infer import infer_audio
    config, ckpt = make_run(tmp_path, f"short{lang_id}")
    audio = np.random.RandomState(5).randn(int(16000 * 1.7)) * 0.4
    jd, pd = _twin_dirs(tmp_path, f"short{lang_id}", {"u.wav": audio})
    jax_infer(str(jd / "u.wav"), config, ckpt, output_lab_path=str(jd / "u.lab"),
              lang_id=lang_id, confidence_threshold=0.1)
    infer_audio(str(pd / "u.wav"), config, ckpt,
                output_lab_path=str(pd / "u.lab"), device="cpu",
                lang_id=lang_id, confidence_threshold=0.1)
    _nonempty_same(jd / "u.lab", pd / "u.lab")


def test_lab_parity_chunked_forced_and_cache(tmp_path):
    """> 30 s: the chunked path (a 30 s chunk is 1499 frames), forced
    alignment from the sibling .txt; a second run reads the cache."""
    from wfl_asr_tpu.infer import infer_audio as jax_infer
    from wfl_asr_tpu_torch.infer import infer_audio
    config, ckpt = make_run(tmp_path, "chunked")
    audio = np.random.RandomState(6).randn(int(16000 * 31.3)) * 0.4
    jd, pd = _twin_dirs(tmp_path, "chunked", {"u.wav": audio},
                        txt="p0 p1 p2 p0 p3\n")
    jax_infer(str(jd / "u.wav"), config, ckpt,
              output_lab_path=str(jd / "u.lab"), lang_id=0,
              confidence_threshold=0.1)
    infer_audio(str(pd / "u.wav"), config, ckpt,
                output_lab_path=str(pd / "u.lab"), device="cpu", lang_id=0,
                confidence_threshold=0.1)
    _nonempty_same(jd / "u.lab", pd / "u.lab")
    assert sorted(os.listdir(jd / ".wfl_cache")) == \
        sorted(os.listdir(pd / ".wfl_cache"))

    first = open(pd / "u.lab").read()
    infer_audio(str(pd / "u.wav"), config, ckpt,
                output_lab_path=str(pd / "u.lab"), device="cpu", lang_id=0,
                confidence_threshold=0.1)
    assert open(pd / "u.lab").read() == first


def test_batched_folder_device_decode(tmp_path):
    """Files of unequal length share one masked forward, language-averaged
    (lang_id None), gated, median-filtered and BIO-decoded on the device."""
    from wfl_asr_tpu.infer.pipeline import infer_folder_batched as jax_fold
    from wfl_asr_tpu_torch.infer import infer_folder_batched
    config, ckpt = make_run(tmp_path, "folder", device_decode=True)
    rng = np.random.RandomState(13)
    audios = {f"w{i}.wav": rng.randn(int(16000 * d)) * 0.4
              for i, d in enumerate([0.6, 2.3, 1.4])}
    jd, pd = _twin_dirs(tmp_path, "folder", audios)
    jax_fold(str(jd), config, ckpt, str(tmp_path / "out_jax"), lang_id=None,
             confidence_threshold=0.1, batch_files=3, data_parallel=False)
    infer_folder_batched(str(pd), config, ckpt, str(tmp_path / "out_port"),
                         lang_id=None, confidence_threshold=0.1,
                         batch_files=3, device="cpu")
    for name in audios:
        lab = name.replace(".wav", ".lab")
        _nonempty_same(tmp_path / "out_jax" / lab, tmp_path / "out_port" / lab)


def test_cli_folder_parity(tmp_path):
    """The port's CLI (``--device cpu``, batched folder mode) writes the
    JAX CLI's ``.lab`` files."""
    from click.testing import CliRunner
    from wfl_asr_tpu.infer.cli import main as jax_main
    from wfl_asr_tpu_torch.infer.cli import main as port_main
    config, ckpt = make_run(tmp_path, "cli")
    rng = np.random.RandomState(17)
    audios = {f"c{i}.wav": rng.randn(int(16000 * d)) * 0.4
              for i, d in enumerate([1.2, 0.7])}
    jd, pd = _twin_dirs(tmp_path, "cli", audios)
    for main, d in ((jax_main, jd), (port_main, pd)):
        res = CliRunner().invoke(main, [str(d), "-ckpt", ckpt, "-c", config,
                                        "-o", str(d / "out"), "-l", "0",
                                        "-ct", "0.1", "-b", "2", "-d", "cpu"])
        assert res.exit_code == 0, res.output
    for name in audios:
        lab = name.replace(".wav", ".lab")
        _nonempty_same(jd / "out" / lab, pd / "out" / lab)


# ---------------------------------------------------------------------------
# The port's rules
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    """The port's package, pipeline, tagger, kernel, training, parallel and
    utility modules import neither jax, optax nor wfl_asr_tpu."""
    code = ("import sys\n"
            "import wfl_asr_tpu_torch, wfl_asr_tpu_torch.infer.pipeline\n"
            "import wfl_asr_tpu_torch.infer.cli\n"
            "import wfl_asr_tpu_torch.models.tagger\n"
            "import wfl_asr_tpu_torch.checkpoint\n"
            "import wfl_asr_tpu_torch.ops.kernels.flash_attention\n"
            "import wfl_asr_tpu_torch.ops.kernels.flash_attention_bwd\n"
            "import wfl_asr_tpu_torch.ops.kernels.conv_fused\n"
            "import wfl_asr_tpu_torch.train.loop, wfl_asr_tpu_torch.metrics\n"
            "import wfl_asr_tpu_torch.train.prodigy\n"
            "import wfl_asr_tpu_torch.train.optimizers\n"
            "import wfl_asr_tpu_torch.utils.viz\n"
            "import wfl_asr_tpu_torch.utils.profiling\n"
            "import wfl_asr_tpu_torch.train.losses\n"
            "import wfl_asr_tpu_torch.train.schedules\n"
            "import wfl_asr_tpu_torch.data.dataset\n"
            "import wfl_asr_tpu_torch.preprocess\n"
            "import wfl_asr_tpu_torch.parallel\n"
            "import wfl_asr_tpu_torch.parallel.mesh\n"
            "import wfl_asr_tpu_torch.parallel.fsdp\n"
            "import wfl_asr_tpu_torch.parallel.tp\n"
            "import wfl_asr_tpu_torch.parallel.sp\n"
            "import wfl_asr_tpu_torch.parallel.pp\n"
            "bad = [m for m in sys.modules if m in ('jax', 'optax') or "
            "m.startswith(('jax.', 'optax.', 'wfl_asr_tpu.')) or "
            "m == 'wfl_asr_tpu']\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_port_sources_never_import_jax():
    files = []
    for root, _, names in os.walk(os.path.join(REPO, "wfl_asr_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    files += [os.path.join(REPO, n) for n in ("chip_smoke.py",
                                              "train_step_ab.py")]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "wfl_asr_tpu"), \
                    f"{path}: imports {m}"


@pytest.mark.parametrize("device", [None, "cuda"])
def test_default_device_needs_cuda(tmp_path, device, monkeypatch):
    from wfl_asr_tpu_torch.infer import InferenceSession, infer_audio
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config, ckpt = make_run(tmp_path, f"dev{device}")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceSession(config, ckpt, device=device)
    wav = str(tmp_path / "d.wav")
    write_wav(wav, np.zeros(1600), 16000)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer_audio(wav, config, ckpt, device=device)


def test_session_from_config_dict_and_cpu(tmp_path):
    """A Config built from a dict (no YAML read) serves on the CPU, and the
    session cache is keyed by device."""
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.infer import pipeline as P
    config_path, ckpt = make_run(tmp_path, "dict")
    cfg = Config(yaml.safe_load(open(config_path)))
    s = P._get_session(cfg, ckpt, device="cpu")
    assert s.device.type == "cpu"
    assert P._get_session(cfg, ckpt, device="cpu") is s
    logits, offsets = s.forward(np.zeros(3000, np.float32), [0, 1])
    assert logits.shape == (2, s.num_frames_for(3000), len(LABELS))
    assert np.isfinite(logits).all() and np.isfinite(offsets).all()
