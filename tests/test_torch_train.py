"""The PyTorch port's training slice against the JAX package on the CPU, in
f32, the JAX side under ``jax.default_matmul_precision("highest")`` with
its Pallas kernels in interpret mode: losses, Prodigy, the schedulers, the
data pipeline, preprocess, one full train step of the tiny flagship
(forward, the attention backward, Prodigy), the training-mode modules, and
the train loop end to end (rotation, best/last, resume, metrics.jsonl).

    python -m pytest tests/test_torch_train.py -q
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from wfl_asr_tpu.config import Config as JaxConfig
from wfl_asr_tpu.train import losses as JL
from wfl_asr_tpu_torch.config import Config
from wfl_asr_tpu_torch.data.audio import write_wav
from wfl_asr_tpu_torch.models import tagger as PT
from wfl_asr_tpu_torch.models.convert import export_tagger, \
    state_dict_from_jax
from wfl_asr_tpu_torch.train import losses as TL
from wfl_asr_tpu_torch.train import loop as TLOOP

LOSS_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _common(cls, obj, skip=()):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
            if f.name not in skip}


def port_arch(arch) -> PT.TaggerArch:
    return PT.TaggerArch(**_common(PT.TaggerArch, arch, skip=("wavlm",)),
                         wavlm=PT.WavLMArch(**_common(PT.WavLMArch,
                                                      arch.wavlm)))


# ---------------------------------------------------------------------------
# Fixture dataset: <root>/data/<lang>/u{i}.wav + .lab, 2 languages
# ---------------------------------------------------------------------------

ARCH_OVERRIDES = dict(
    hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    conv_dim=[32] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
    conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, num_buckets=40, max_distance=100)


def make_data(root, n_per_lang=5):
    rng = np.random.RandomState(0)
    phones = ["a", "b", "SP", "c"]
    for lang in ("en", "ja"):
        d = os.path.join(root, "data", lang)
        os.makedirs(d, exist_ok=True)
        for i in range(n_per_lang):
            dur = 1.0 + 0.37 * i
            write_wav(os.path.join(d, f"u{i}.wav"),
                      rng.randn(int(dur * 16000)) * 0.3, 16000)
            t, k, lines = 0.0, 0, []
            while t < dur - 0.05:
                e = min(t + 0.1 + 0.05 * (k % 3), dur)
                lines.append(f"{int(t * 1e7)} {int(e * 1e7)} "
                             f"{phones[(k + i) % 4]}")
                t, k = e, k + 1
            with open(os.path.join(d, f"u{i}.lab"), "w") as f:
                f.write("\n".join(lines) + "\n")


def make_config(root, save="run", **training):
    t = {"batch_size": 3, "optimizer": "Prodigy",
         "optimizer_params": {"betas": [0.9, 0.999], "eps": 1e-8},
         "learning_rate": 1, "scheduler": "ConstantLR",
         "weight_decay": 1e-5, "label_smoothing": 0.1, "max_steps": 6,
         "val_check_interval": 2, "max_checkpoints": 2,
         "log_dir": os.path.join(root, save, "logs"), "seed": 0}
    t.update(training)
    return {
        "data": {"data_dir": os.path.join(root, "data"), "sample_rate": 16000,
                 "num_val_files": 3, "frame_duration": 0.02},
        "model": {"encoder_type": "wavlm",
                  "wavlm_model": "microsoft/wavlm-base-plus",
                  "encoder_arch_overrides": dict(ARCH_OVERRIDES),
                  "num_languages": 0, "lang_emb_dim": 16,
                  "bilstm_num_layer": 2, "num_conformer_layers": 2,
                  "conformer_heads": 2, "conformer_ff_expansion": 2,
                  "conformer_dropout": 0.15, "subframe_loss_weight": 3.0,
                  "merged_phoneme_groups": []},
        "training": t,
        "augmentation": {"enable": True, "noise_std": 0.005, "prob": 0.5,
                         "volume_range": [0.9, 1.1]},
        "output": {"save_dir": os.path.join(root, save)},
        "postprocess": {"median_filter": 3}}


@pytest.fixture(scope="module")
def prepped(tmp_path_factory):
    """A fixture dataset preprocessed by the port into <root>/run."""
    from wfl_asr_tpu_torch.preprocess import preprocess
    root = str(tmp_path_factory.mktemp("train"))
    make_data(root)
    cfg = make_config(root)
    preprocess(cfg["data"]["data_dir"], cfg)
    return root, cfg


# ---------------------------------------------------------------------------
# losses, Prodigy, schedulers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_losses_match_jax(smoothing):
    rng = np.random.RandomState(int(smoothing * 10))
    b, t, c = 3, 40, 9
    logits = (rng.randn(b, t, c) * 2).astype(np.float32)
    labels = rng.randint(0, c, size=(b, t)).astype(np.int64)
    labels[1, 30:] = -100
    labels[2, 11:] = -100
    np.testing.assert_allclose(
        float(TL.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), smoothing)),
        float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               smoothing)), atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(
        float(TL.soft_iou_segmental_loss(torch.from_numpy(logits),
                                         torch.from_numpy(labels))),
        float(JL.soft_iou_segmental_loss(jnp.asarray(logits),
                                         jnp.asarray(labels))),
        atol=LOSS_TOL, rtol=0)

    segs = [(0.0, 0.13, "a"), (0.13, 0.41, "b"), "junk", (0.41, 0.9, "SP"),
            (0.9, 2.0, "a")]
    targets = [TL.offset_targets_from_segments(segs, 0.02, n, 16)
               for n in (40, 25, 3)]
    for got, want in zip(targets[0], JL.offset_targets_from_segments(
            segs, 0.02, 40, 16)):
        np.testing.assert_array_equal(got, want)
    arrs = [np.stack([tg[i] for tg in targets]) for i in range(4)]
    offsets = rng.rand(b, t, 2).astype(np.float32)
    np.testing.assert_allclose(
        float(TL.offset_loss(torch.from_numpy(offsets),
                             *map(torch.from_numpy, arrs))),
        float(JL.offset_loss(jnp.asarray(offsets), *map(jnp.asarray, arrs))),
        atol=LOSS_TOL, rtol=0)
    pred = [(0.0, 0.1, "a"), (0.1, 0.5, "b"), (0.5, 0.95, "a")]
    assert TL.segmental_loss_value(pred, segs, (1.0, 1.0, 2.0)) == \
        JL.segmental_loss_value(pred, segs, (1.0, 1.0, 2.0))


@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_prodigy_matches_optax(wd):
    """5 steps on the same gradients (the first all zero, so the d update
    and the parameter update are skipped; then a persistent direction, so
    d grows): params, d and d_max ≤ 1e-6."""
    import optax
    from wfl_asr_tpu.train.prodigy import prodigy
    from wfl_asr_tpu_torch.train.prodigy import Prodigy
    rng = np.random.RandomState(1)
    shapes = [(5, 3), (7,), (2, 4, 3)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    drift = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[np.zeros(s, np.float32) for s in shapes]] + [
        [(g + 0.3 * rng.randn(*g.shape)).astype(np.float32) for g in drift]
        for _ in range(4)]
    tx = prodigy(learning_rate=1.0, weight_decay=wd, d_coef=50.0)
    jp = [jnp.asarray(x) for x in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    opt = Prodigy(tp, lr=1.0, weight_decay=wd, d_coef=50.0)
    for gs in grads:
        upd, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        opt.step()
        glob = opt.global_state()
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       atol=1e-6, rtol=0)
        np.testing.assert_allclose(glob["d"].item(), float(state.d),
                                   rtol=1e-6)
        np.testing.assert_allclose(glob["d_max"].item(), float(state.d_max),
                                   rtol=1e-6)
    assert float(state.d) > 1e-6, "d never grew: the check would be vacuous"
    again = Prodigy(tp, lr=1.0)
    again.load_state_dict(opt.state_dict())
    assert torch.equal(again.global_state()["d"], opt.global_state()["d"])


def test_schedulers_match_jax():
    from wfl_asr_tpu.train import schedules as JS
    from wfl_asr_tpu_torch.train import schedules as TS
    cases = [("ConstantLR", {}), ("WarmupLR", {"warmup_steps": 4}),
             ("StepLR", {"step_size": 3, "gamma": 0.5}),
             ("ExponentialLR", {"gamma": 0.9}),
             ("CosineAnnealingLR", {"T_max": 7, "eta_min": 0.1}),
             ("CosineAnnealingWarmRestarts", {"T_0": 3, "T_mult": 2}),
             ("MultiStepLR", {"milestones": [2, 5]}),
             ("OneCycleLR", {"total_steps": 10}), ("LinearLR", {}),
             ("ReduceLROnPlateau", {"patience": 1, "cooldown": 1})]
    for name, params in cases:
        js = JS.get_scheduler(name, params, base_lr=2.0)
        ts = TS.get_scheduler(name, params, base_lr=2.0)
        for i, metric in enumerate([None, 3, 1.0, None, 7, 0.5, 0.5, 0.5]):
            arg = metric if name == "ReduceLROnPlateau" or metric is None \
                else i * 2
            js.step(arg)
            ts.step(arg)
            assert ts.factor == js.factor, (name, i)
        restored = TS.get_scheduler(name, params, base_lr=2.0)
        restored.load_state_dict(ts.state_dict())
        assert restored.state_dict() == ts.state_dict()


# ---------------------------------------------------------------------------
# data pipeline and preprocess
# ---------------------------------------------------------------------------

def test_preprocess_artifacts_byte_identical(tmp_path):
    from wfl_asr_tpu.preprocess import preprocess as jax_preprocess
    from wfl_asr_tpu_torch.preprocess import preprocess
    root = str(tmp_path)
    make_data(root, n_per_lang=3)
    # a merge group and a pre-existing phoneme list (the incremental path)
    names = ("dataset.json", "lang_phonemes.json", "phoneme_merge_map.json",
             "phonemes.txt", "langs.txt", "config.yaml")
    outs = []
    for fn in (jax_preprocess, preprocess):
        cfg = make_config(root)
        cfg["training"]["merged_phoneme_groups"] = [["en/c", "ja/c"]]
        save = cfg["output"]["save_dir"]
        os.makedirs(save, exist_ok=True)
        with open(os.path.join(save, "phonemes.txt"), "w") as f:
            f.write("B-zz\nI-zz\nO\n")
        fn(cfg["data"]["data_dir"], cfg)
        outs.append({n: open(os.path.join(save, n), "rb").read()
                     for n in names})
        for n in os.listdir(save):
            os.remove(os.path.join(save, n))
    assert outs[0] == outs[1]
    assert b"B-zz" in outs[1]["phonemes.txt"]


def test_batch_loader_matches_jax(prepped):
    from wfl_asr_tpu.data import dataset as JD
    from wfl_asr_tpu_torch.data import dataset as TD
    root, cfg = prepped
    save = cfg["output"]["save_dir"]
    labels = open(os.path.join(save, "phonemes.txt")).read().split()
    aug = cfg["augmentation"]
    loaders = []
    for mod in (JD, TD):
        ds = mod.PhonemeDataset(os.path.join(save, "dataset.json"), labels,
                                None, aug, 16000)
        tr, va = mod.split_dataset(len(ds), 3, 0)
        loaders.append(mod.BatchLoader(ds, tr, 3, seed=0, shuffle=True))
    assert tr and va
    for epoch in (0, 1):
        jb = list(loaders[0].epoch_batches(epoch))
        tb = list(loaders[1].epoch_batches(epoch))
        assert len(jb) == len(tb) == 3
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["max_label_len"] == b["max_label_len"]
            assert a["segments_gt"] == b["segments_gt"]


# ---------------------------------------------------------------------------
# one train step of the tiny flagship against make_train_step
# ---------------------------------------------------------------------------

def _tiny_batch(arch, seed=3):
    """Two rows of unequal audio, −100-padded labels and offset targets."""
    rng = np.random.RandomState(seed)
    s, lens, max_label = 2400, (22, 17), 50
    audio = (rng.randn(2, s) * 0.3).astype(np.float32)
    audio[1, 1900:] = 0.0
    labels = np.full((2, max_label), -100, np.int64)
    targets = []
    for i, n in enumerate(lens):
        labels[i, :n] = rng.randint(0, arch.num_labels, size=n)
        segs = [(0.0, 0.07 + 0.01 * i, "a"), (0.07 + 0.01 * i, 0.3, "b"),
                (0.3, 0.41, "a")]
        targets.append(TL.offset_targets_from_segments(segs, 0.02, n, 64))
    f, c, x, v = (np.stack([t[j] for t in targets]) for j in range(4))
    return {"audio": audio, "labels": labels,
            "lang_ids": np.array([0, 1], np.int32), "off_frames": f,
            "off_channels": c, "off_fracs": x, "off_valid": v,
            "label_lengths": np.array(lens, np.int32),
            "max_label_len": max_label}


def _opt_raw():
    return {"training": {"optimizer": "Prodigy", "learning_rate": 1,
                         "optimizer_params": {"betas": [0.9, 0.999],
                                              "eps": 1e-8},
                         "weight_decay": 1e-5}}


def test_train_step_matches_jax(monkeypatch):
    """Dropout 0, JAX's FLASH_MIN_T at 0 so its step runs the Pallas
    backward: loss/ce/offset_loss ≤ 1e-5, every gradient ≤ 1e-4 × max|g|,
    BatchNorm running stats ≤ 1e-6, params after 3 Prodigy steps ≤ 1e-5."""
    from wfl_asr_tpu.models import wavlm as jwavlm
    from wfl_asr_tpu.models.tagger import init_tagger
    from wfl_asr_tpu.train import loop as JLOOP
    monkeypatch.setattr(jwavlm, "FLASH_MIN_T", 0)
    base = graft._flagship_arch(tiny=True)
    arch = dataclasses.replace(
        base, use_flash_attention=True, conformer_dropout=0.0,
        wavlm=dataclasses.replace(base.wavlm, use_flash_attention=True,
                                  hidden_dropout=0.0))
    params, state = init_tagger(jax.random.PRNGKey(0), arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    batch = _tiny_batch(arch)
    jargs = [jnp.asarray(batch[k]) for k in TLOOP.BATCH_KEYS]

    grad_step = JLOOP.make_grad_step(arch, 0.1, 3.0)
    jgrads, jstate, jm, _, _ = grad_step(
        params, state, jax.random.PRNGKey(1), *jargs,
        max_label_len=batch["max_label_len"])

    parch = port_arch(arch)
    model = PT.BIOPhonemeTagger(parch)
    model.load_state_dict(state_dict_from_jax(params, state, parch),
                          strict=True)
    opt = TLOOP.make_optimizer(Config(_opt_raw()), model.parameters())
    m, _, _ = TLOOP.micro_step(model, batch, "cpu", 1, 0.1, 3.0)
    for k in ("loss", "ce", "offset_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-5,
                                   rtol=0, err_msg=k)

    want = export_tagger(jgrads, jstate, "wavlm")
    sd_names = {"encoder.encoder.pos_conv_embed.conv.weight":
                "encoder.encoder.pos_conv_embed.conv.parametrizations"
                ".weight.original1"}
    wants = {name: np.asarray(want[sd_names.get(name, name)]).reshape(
        p.shape) for name, p in model.named_parameters()}
    gmax = max(np.abs(w).max() for w in wants.values())
    for name, p in model.named_parameters():
        w, g = wants[name], p.grad.numpy()
        if np.abs(w).max() <= 1e-6 * gmax:
            # 0 in exact arithmetic (the key bias: softmax ignores a
            # per-row shift; the conv bias before BatchNorm): rounding
            # noise on both sides
            assert np.abs(g).max() <= 1e-6 * gmax, name
            continue
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(),
                                   rtol=0, err_msg=name)
    sd = model.state_dict()
    for i, s in enumerate(jstate["conformer"]):
        for key, jk in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                sd[f"conformer_layers.{i}.conv.3.{key}"].numpy(),
                np.asarray(s["bn"][jk]), atol=1e-6, rtol=0)

    # 3 Prodigy steps: make_train_step against the port's train_step
    tx = JLOOP.make_optimizer(JaxConfig(_opt_raw()))
    train_step = JLOOP.make_train_step(arch, 0.1, 3.0, tx)
    jp, js = jax.tree_util.tree_map(jnp.asarray, (params, state))
    ostate = tx.init(jp)
    for i in range(3):
        jp, js, ostate, _, _, _ = train_step(
            jp, js, ostate, jax.random.PRNGKey(i), *jargs,
            max_label_len=batch["max_label_len"])
        if i == 0:      # the gradients of the micro_step above
            TLOOP.apply_update(opt)
        else:
            TLOOP.train_step(model, opt, batch, "cpu", 0.1, 3.0)
    want = export_tagger(jax.tree_util.tree_map(np.asarray, jp),
                         jax.tree_util.tree_map(np.asarray, js), "wavlm")
    got = model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=k)
    assert float(ostate.hyperparams["learning_rate"]) == 1.0


# ---------------------------------------------------------------------------
# training-mode modules
# ---------------------------------------------------------------------------

def _port_tiny(**wavlm_fields):
    base = port_arch(graft._flagship_arch(tiny=True))
    return dataclasses.replace(
        base, wavlm=dataclasses.replace(base.wavlm, **wavlm_fields))


def test_dropout_and_layerdrop_train_vs_eval():
    audio = torch.from_numpy(
        (np.random.RandomState(5).randn(2, 2400) * 0.3).astype(np.float32))
    lang = torch.tensor([0, 1])
    arch = _port_tiny(feat_proj_dropout=0.1, hidden_dropout=0.1,
                      activation_dropout=0.1)
    model = PT.init_tagger(arch, torch.Generator().manual_seed(0))
    plain = PT.BIOPhonemeTagger(dataclasses.replace(
        arch, conformer_dropout=0.0,
        wavlm=dataclasses.replace(arch.wavlm, feat_proj_dropout=0.0,
                                  hidden_dropout=0.0,
                                  activation_dropout=0.0))).eval()
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        ref, _ = plain(audio, lang, max_label_len=50)
        ev, _ = model(audio, lang, max_label_len=50)
        assert torch.equal(ev, ref)
        enc = model.encoder.train()
        a = enc(audio, generator=torch.Generator().manual_seed(1))
        b = enc(audio, generator=torch.Generator().manual_seed(1))
        c = enc(audio, generator=torch.Generator().manual_seed(2))
        assert torch.equal(a, b) and not torch.allclose(a, c)

        # LayerDrop 1: every layer skipped in training, none in eval
        drop = PT.WavLMEncoder(dataclasses.replace(
            arch.wavlm, layerdrop=1.0, feat_proj_dropout=0.0,
            hidden_dropout=0.0, activation_dropout=0.0))
        drop.load_state_dict(enc.state_dict())
        skipped = PT.WavLMEncoder(dataclasses.replace(
            drop.arch, num_layers=0, layerdrop=0.0))
        skipped.load_state_dict({k: v for k, v in enc.state_dict().items()
                                 if ".layers." not in k})
        no_layers = skipped.eval()(audio, pos_bias=torch.zeros(()))
        torch.testing.assert_close(drop.train()(audio), no_layers, atol=0,
                                   rtol=0)
        assert not torch.allclose(drop.eval()(audio), no_layers)


def test_freeze_encoder_leaves_encoder_untouched():
    arch = dataclasses.replace(_port_tiny(), freeze_encoder=True)
    model = PT.init_tagger(arch, torch.Generator().manual_seed(0))
    model.encoder.requires_grad_(False)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = TLOOP.make_optimizer(Config(_opt_raw()),
                               [p for p in model.parameters()
                                if p.requires_grad])
    batch = _tiny_batch(arch)
    for _ in range(2):
        TLOOP.train_step(model, opt, batch, "cpu", 0.1, 3.0)
    after = model.state_dict()
    enc = [k for k in before if k.startswith("encoder.")]
    assert enc and all(torch.equal(before[k], after[k]) for k in enc)
    assert not torch.equal(before["classifier.weight"],
                           after["classifier.weight"])
    assert all(p.grad is None for p in model.encoder.parameters())


def test_grad_accumulation_is_the_mean():
    arch = dataclasses.replace(_port_tiny(hidden_dropout=0.0),
                               conformer_dropout=0.0)
    b1, b2 = _tiny_batch(arch, 3), _tiny_batch(arch, 4)
    models = [PT.init_tagger(arch, torch.Generator().manual_seed(0))
              for _ in range(3)]
    TLOOP.micro_step(models[0], b1, "cpu", 2, 0.1, 3.0)
    TLOOP.micro_step(models[0], b2, "cpu", 2, 0.1, 3.0)
    TLOOP.micro_step(models[1], b1, "cpu", 1, 0.1, 3.0)
    TLOOP.micro_step(models[2], b2, "cpu", 1, 0.1, 3.0)
    for (n, p), q, r in zip(models[0].named_parameters(),
                            models[1].parameters(), models[2].parameters()):
        want = (q.grad + r.grad) / 2
        torch.testing.assert_close(p.grad, want, rtol=0,
                                   atol=1e-6 * want.abs().max().item()
                                   + 1e-12, msg=n)


# ---------------------------------------------------------------------------
# the train loop end to end
# ---------------------------------------------------------------------------

def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_loop_end_to_end(prepped):
    """6 steps with validation every 2: rotation keeps 2 checkpoints with
    sidecars, best and last exist and best loads in the JAX package;
    a second run resumes at step 7; a torn newest checkpoint falls back."""
    from wfl_asr_tpu.checkpoint import load_model_checkpoint as jax_load
    from wfl_asr_tpu.models.tagger import TaggerArch as JaxTaggerArch
    root, cfg = prepped
    save = cfg["output"]["save_dir"]
    cfg_path = os.path.join(save, "config.yaml")
    raw = Config.load(cfg_path).raw
    model = TLOOP.train(raw, device="cpu")
    files = set(os.listdir(save))
    assert {"model_step4.pt", "model_step6.pt", "model_step4.train.pt",
            "model_step6.train.pt", "best_model.pt",
            "last_model.pt"} <= files
    assert "model_step2.pt" not in files and \
        "model_step2.train.pt" not in files
    log = os.path.join(raw["training"]["log_dir"], "metrics.jsonl")
    ev = _events(log)
    assert [e["step"] for e in ev if e["event"] == "train"] == list(
        range(1, 7))
    assert [e["step"] for e in ev if e["event"] == "val"] == [2, 4, 6]
    assert all(np.isfinite(e["loss"]) for e in ev)
    last = torch.load(os.path.join(save, "last_model.pt"), weights_only=True)
    for k, v in model.state_dict().items():
        assert torch.equal(last[k], v), k

    labels = open(os.path.join(save, "phonemes.txt")).read().split()
    jarch = JaxTaggerArch.from_config(JaxConfig(raw), len(labels))
    jparams, _ = jax_load(os.path.join(save, "best_model.pt"), jarch)
    assert np.isfinite(np.asarray(jparams["classifier"]["w"])).all()

    raw["training"]["max_steps"] = 8
    TLOOP.train(raw, device="cpu")
    new = _events(log)[len(ev):]
    assert [e["step"] for e in new if e["event"] == "train"] == [7, 8]

    with open(os.path.join(save, "model_step8.pt"), "wb") as f:
        f.write(b"torn")
    raw["training"]["max_steps"] = 7
    TLOOP.train(raw, device="cpu")
    newer = _events(log)[len(ev) + len(new):]
    assert [e["step"] for e in newer if e["event"] == "train"] == [7]


def test_unported_options_raise(prepped):
    """The orbax format raises ``NotImplementedError`` naming ROADMAP.md;
    pipeline parallelism in one process is the JAX loop's ``ValueError``
    (it needs several ranks)."""
    root, cfg = prepped
    for section, key, val, err, match in (
            ("training", "pipeline_parallel", 2, ValueError,
             "needs multiple visible devices"),
            ("output", "checkpoint_format", "orbax", NotImplementedError,
             "ROADMAP")):
        raw = json.loads(json.dumps(cfg))
        raw[section][key] = val
        raw["model"]["num_languages"] = 2
        with pytest.raises(err, match=match):
            TLOOP.train(raw, device="cpu")


@pytest.mark.parametrize("key,val,warning", [
    ("fsdp", True, "training.fsdp ignored: single visible device"),
    ("sequence_parallel", True, "training.sequence_parallel ignored"),
    ("model_parallel", 2, "training.model_parallel=2 ignored"),
])
def test_parallel_options_warn_in_one_process(prepped, capsys, key, val,
                                              warning):
    """Without a process group (one device) the parallel options warn, as
    the JAX loop does, and the run stays on one device."""
    _, cfg = prepped
    raw = json.loads(json.dumps(cfg))
    raw["training"][key] = val
    par = TLOOP.plan_parallel(Config(raw), "cpu")
    assert par.mesh is None and not par.fsdp
    assert warning in capsys.readouterr().out


def test_parallel_option_errors(prepped):
    """FSDP with model parallelism is the JAX loop's ValueError, even on one
    device."""
    _, cfg = prepped
    raw = json.loads(json.dumps(cfg))
    raw["training"].update(fsdp=True, model_parallel=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TLOOP.plan_parallel(Config(raw), "cpu")


@pytest.mark.parametrize("training,nodes,match", [
    ({"remat": "auto"}, 1, "remat: auto is single-process only"),
    ({"fsdp": True}, 2, "fsdp is not supported across nodes"),
    ({"model_parallel": 2}, 2, "model_parallel > 1 is not supported across"),
])
def test_parallel_option_errors_of_a_world(prepped, monkeypatch, training,
                                           nodes, match):
    """In a world of two ranks (on two nodes where named), the JAX loop's
    ValueErrors: remat auto with more than one rank, FSDP or model
    parallelism across nodes."""
    _, cfg = prepped
    raw = json.loads(json.dumps(cfg))
    raw["training"].update(training)
    monkeypatch.setattr(TLOOP.pmesh, "world_size", lambda: 2)
    monkeypatch.setattr(TLOOP.pmesh, "node_count", lambda env=None: nodes)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    with pytest.raises(ValueError, match=match):
        TLOOP.plan_parallel(Config(raw), "cpu")


def test_parallel_options_train_in_one_process(prepped, tmp_path, capsys):
    """A config with fsdp, sequence_parallel and sharded_validation trains
    in one process, warning for the first two."""
    _, cfg = prepped
    raw = json.loads(json.dumps(cfg))
    raw["model"]["num_languages"] = 2
    raw["training"].update(fsdp=True, sequence_parallel=True,
                           sharded_validation=True, max_steps=2,
                           log_dir=str(tmp_path / "logs"))
    raw["output"]["save_dir"] = str(tmp_path)
    for name in ("phonemes.txt", "dataset.json", "langs.txt"):
        src = os.path.join(cfg["output"]["save_dir"], name)
        with open(src, "rb") as f, open(tmp_path / name, "wb") as g:
            g.write(f.read())
    TLOOP.train(raw, device="cpu")
    out = capsys.readouterr().out
    assert out.count("ignored") == 2
    assert os.path.exists(tmp_path / "last_model.pt")


def test_train_needs_cuda_unless_asked_for_the_cpu(prepped, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, cfg = prepped
    raw = json.loads(json.dumps(cfg))
    raw["model"]["num_languages"] = 2
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            TLOOP.train(raw, device=device)


def test_grad_accumulation_and_finetune_surgery(prepped, tmp_path,
                                                monkeypatch):
    """The train loop with 2 micro-batches per update counts updates in
    metrics.jsonl; a finetune run from its best_model.pt grows the
    language embedding and carries the classifier rows over by tag."""
    root, cfg = prepped
    base = json.loads(json.dumps(cfg))
    base["model"]["num_languages"] = 2
    base["output"]["save_dir"] = str(tmp_path / "base")
    base["training"].update(grad_accumulation=2, max_steps=2,
                            val_check_interval=2,
                            log_dir=str(tmp_path / "base" / "logs"))
    os.makedirs(base["output"]["save_dir"])
    for name in ("dataset.json", "phonemes.txt", "langs.txt"):
        with open(os.path.join(cfg["output"]["save_dir"], name)) as f:
            text = f.read()
        with open(os.path.join(base["output"]["save_dir"], name), "w") as f:
            f.write(text)
    base_model = TLOOP.train(base, device="cpu")
    ev = _events(os.path.join(base["training"]["log_dir"], "metrics.jsonl"))
    assert [e["step"] for e in ev if e["event"] == "train"] == [1, 2]

    fine = json.loads(json.dumps(base))
    fine["model"]["num_languages"] = 3
    fine["output"]["save_dir"] = str(tmp_path / "fine")
    fine["training"].update(grad_accumulation=1, max_steps=1,
                            log_dir=str(tmp_path / "fine" / "logs"))
    fine["finetuning"] = {"enable": True, "model_path": os.path.join(
        base["output"]["save_dir"], "best_model.pt")}
    os.makedirs(fine["output"]["save_dir"])
    old = open(os.path.join(base["output"]["save_dir"],
                            "phonemes.txt")).read().split()
    new = sorted(old[:-3] + ["B-zz", "I-zz"]) + ["O"]
    for name, text in (("phonemes.txt", "\n".join(new) + "\n"),
                       ("langs.txt", "en,0\nja,1\nfr,2\n")):
        with open(os.path.join(fine["output"]["save_dir"], name), "w") as f:
            f.write(text)
    with open(os.path.join(base["output"]["save_dir"],
                           "dataset.json")) as f:
        text = f.read()
    with open(os.path.join(fine["output"]["save_dir"], "dataset.json"),
              "w") as f:
        f.write(text)
    best = torch.load(fine["finetuning"]["model_path"], weights_only=True)
    captured = {}
    real = TLOOP.finetune_surgery

    def spy(model, *args):
        real(model, *args)
        captured.update({k: v.clone() for k, v in
                         model.state_dict().items()})
    monkeypatch.setattr(TLOOP, "finetune_surgery", spy)
    TLOOP.train(fine, device="cpu")
    assert captured["lang_emb.weight"].shape[0] == 3
    torch.testing.assert_close(captured["lang_emb.weight"][:2],
                               best["lang_emb.weight"], atol=0, rtol=0)
    old_index = {l: i for i, l in enumerate(old)}
    for i, label in enumerate(new):
        if label in old_index:
            torch.testing.assert_close(
                captured["classifier.weight"][i],
                best["classifier.weight"][old_index[label]], atol=0, rtol=0)
    torch.testing.assert_close(captured["bilstm.weight_ih_l0"],
                               best["bilstm.weight_ih_l0"], atol=0, rtol=0)
