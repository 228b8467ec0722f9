"""The port's label-boundary corrector (``wfl_asr_tpu_torch.correct_label``)
against the JAX package's (``wfl_asr_tpu.correct_label``) on the CPU:
boundary detection equal to ≤ 1e-12 (both float64 NumPy), corrected
``.lab`` files byte-identical over several seeds, the ``_boundary.txt``
cache protocol, the CLI's folder mode (with and without tqdm), and the
``--save_plot`` PNG.

    python -m pytest tests/test_torch_correct_label.py -q
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from wfl_asr_tpu import correct_label as JCL
from wfl_asr_tpu_torch import correct_label as CL
from wfl_asr_tpu_torch.data.audio import write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


def make_utterance(seed: int, seconds: float = 3.0, sr: int = SR):
    """Tone and noise segments of random lengths (each transition a
    boundary candidate) and a .lab whose boundaries sit near them, up to
    ±40 ms off, so some snap and some do not."""
    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    y = np.zeros(n)
    t, segs = 0.0, []
    while t < seconds - 0.1:
        d = min(rng.uniform(0.08, 0.45), seconds - t)
        a, b = int(t * sr), int((t + d) * sr)
        kind = rng.randint(3)
        if kind == 0:
            y[a:b] = 0.5 * np.sin(2 * np.pi * rng.uniform(150, 900)
                                  * np.arange(b - a) / sr)
        elif kind == 1:
            y[a:b] = 0.2 * rng.randn(b - a)
        segs.append((t, t + d, ["SP", "a", "k"][kind]))
        t += d
    lab = []
    for i, (s, e, lbl) in enumerate(segs):
        jitter = rng.uniform(-0.04, 0.04)
        s2 = lab[-1][1] if lab else 0.0
        e2 = e + jitter if i < len(segs) - 1 else e
        lab.append((s2, max(e2, s2 + 0.01), lbl))
    return y.astype(np.float32), lab


def write_pair(folder, name, y, lab):
    os.makedirs(folder, exist_ok=True)
    wav = os.path.join(folder, f"{name}.wav")
    write_wav(wav, y, SR)
    with open(wav.replace(".wav", ".lab"), "w") as f:
        for s, e, lbl in lab:
            f.write(f"{int(s * 1e7)} {int(e * 1e7)} {lbl}\n")
    return wav


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("seed", range(3))
def test_detect_boundaries_matches_jax(seed):
    y, _ = make_utterance(seed)
    got = CL.detect_boundaries(y.astype(np.float64), SR)
    want = JCL.detect_boundaries(y.astype(np.float64), SR)
    assert got[0] == want[0] and len(got[0]) >= 3
    for a, b in zip(got[1:], want[1:]):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-12


@pytest.mark.parametrize("seed", range(4))
def test_process_file_lab_byte_identical(tmp_path, seed, capsys):
    y, lab = make_utterance(seed)
    ours = write_pair(str(tmp_path / "port"), "u", y, lab)
    theirs = write_pair(str(tmp_path / "jax"), "u", y, lab)
    CL.process_file(ours)
    out_port = capsys.readouterr().out
    JCL.process_file(theirs)
    out_jax = capsys.readouterr().out
    got, want = (read_bytes(p.replace(".wav", ".lab"))
                 for p in (ours, theirs))
    assert got == want
    assert out_port == out_jax
    assert sorted(os.listdir(tmp_path / "port")) == ["u.lab", "u.wav"]
    # the labels moved: at least one boundary snapped
    assert got != "".join(f"{int(s * 1e7)} {int(e * 1e7)} {lbl}\n"
                          for s, e, lbl in lab).encode()


def test_boundary_cache_protocol(tmp_path, capsys):
    """A pre-made ``_boundary.txt`` is read instead of detecting, the snap
    uses its candidates, and the cache is deleted after the run."""
    y, lab = make_utterance(7)
    outs = []
    for name, mod in (("port", CL), ("jax", JCL)):
        wav = write_pair(str(tmp_path / name), "u", y, lab)
        cands = [lab[0][1] + 0.01, lab[1][1] - 0.02, 2.5]
        mod.write_predicted_boundaries(wav, cands)
        assert mod.load_predicted_boundaries(wav) == [
            float(f"{t:.6f}") for t in cands]
        mod.process_file(wav)
        printed = capsys.readouterr().out
        assert "Found pre-made boundary file" in printed
        assert not os.path.exists(wav.replace(".wav", "_boundary.txt"))
        outs.append((read_bytes(wav.replace(".wav", ".lab")),
                     printed.replace(name, "")))
    assert outs[0] == outs[1]
    first = outs[0][0].decode().splitlines()[0].split()
    assert int(first[1]) == int(float(f"{lab[0][1] + 0.01:.6f}") * 1e7)
    # without a .lab the snap returns nothing
    assert CL.correct_lab_boundaries(str(tmp_path / "none.wav"), [0.1]) \
        == ([], [])


@pytest.mark.parametrize("tqdm", ["present", "absent"])
def test_cli_folder_mode(tmp_path, tqdm):
    """``python -m wfl_asr_tpu_torch.correct_label FOLDER`` rewrites every
    .lab as the JAX module's process_file does, prints the JAX module's
    lines; without tqdm it counts files on stderr instead of a bar."""
    folder, ref = str(tmp_path / "cli"), str(tmp_path / "ref")
    for seed in range(3):
        y, lab = make_utterance(10 + seed, seconds=2.0)
        write_pair(folder, f"u{seed}", y, lab)
        write_pair(ref, f"u{seed}", y, lab)
    if tqdm == "present":
        cmd = [sys.executable, "-m", "wfl_asr_tpu_torch.correct_label",
               folder]
    else:
        cmd = [sys.executable, "-c",
               "import sys; sys.modules['tqdm'] = None; "
               "from wfl_asr_tpu_torch.correct_label import main; "
               f"main([{folder!r}])"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines.count("[INFO] No pre-made boundary file detected, "
                       "creating a new one") == 3
    assert lines[-1] == "Label correction complete. All files processed."
    if tqdm == "absent":
        assert "3/3" in proc.stderr
    for seed in range(3):
        JCL.process_file(os.path.join(ref, f"u{seed}.wav"))
        assert read_bytes(os.path.join(folder, f"u{seed}.lab")) == \
            read_bytes(os.path.join(ref, f"u{seed}.lab"))
    assert sorted(os.listdir(folder)) == sorted(os.listdir(ref))


def test_lines_are_single_writes(tmp_path, monkeypatch):
    """Each [INFO] line reaches stdout in one write: the folder mode's
    workers share one unbuffered stdout, where print's separate writes of
    the text and its newline interleave across processes."""
    writes = []

    class Recorder:
        def write(self, text):
            writes.append(text)

        def flush(self):
            pass

    y, lab = make_utterance(5, seconds=1.5)
    wav = write_pair(str(tmp_path / "w"), "u", y, lab)
    monkeypatch.setattr(sys, "stdout", Recorder())
    CL.process_file(wav)
    CL.write_predicted_boundaries(wav, [0.1, 0.5])
    CL.process_file(wav)
    monkeypatch.undo()
    assert len(writes) == 2, writes
    assert all(w.endswith("\n") and w.count("\n") == 1 for w in writes), \
        writes


def test_cli_rejects_other_paths(tmp_path, capsys):
    with pytest.raises(SystemExit) as exit_info:
        CL.main([str(tmp_path / "x.txt")])
    assert exit_info.value.code == 1
    assert capsys.readouterr().out.strip() == \
        "Expected a .wav file or a folder of .wav files."


def test_save_plot_png_and_missing_matplotlib(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    y, lab = make_utterance(3, seconds=1.5)
    wav = write_pair(str(tmp_path / "plot"), "u", y, lab)
    CL.process_file(wav, save_plot=True)
    png = wav.replace(".wav", ".png")
    assert read_bytes(png)[:8] == b"\x89PNG\r\n\x1a\n"
    os.remove(png)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        CL.process_file(wav, save_plot=True)
    assert not os.path.exists(png)
