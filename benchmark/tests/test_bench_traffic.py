"""Seeded traffic: the same seed gives the same folders and corpus, another
seed other audio of the same lengths."""

import hashlib
import os

from benchmark.core import seeds, traffic


def _digest(root):
    h = hashlib.sha256()
    for base, _dirs, names in sorted(os.walk(root)):
        for n in sorted(names):
            with open(os.path.join(base, n), "rb") as f:
                h.update(os.path.relpath(os.path.join(base, n), root).encode())
                h.update(f.read())
    return h.hexdigest()


def _sizes(root):
    return sorted((os.path.relpath(os.path.join(b, n), root),
                   os.path.getsize(os.path.join(b, n)))
                  for b, _d, names in os.walk(root) for n in names
                  if n.endswith(".wav"))


def test_durations_are_fixed_quantiles():
    d = traffic.durations(64, 8.0, 0.6, 1.0, 30.0, 0)
    assert d == traffic.durations(64, 8.0, 0.6, 1.0, 30.0, 0)
    assert min(d) >= 1.0 and max(d) <= 30.0
    assert sorted(d)[32] > 8.0 > sorted(d)[31]


def test_folder_pool_is_a_function_of_the_seed(tmp_path):
    durs = traffic.durations(6, 1.5, 0.6, 1.0, 3.0, 0)
    for name, seed in (("a", 2 ** 33 + 5), ("b", 2 ** 33 + 5), ("c", 7)):
        traffic.folder_pool(str(tmp_path / name), 2, 3, durs, seed, "cpu")
    assert _digest(tmp_path / "a") == _digest(tmp_path / "b")
    assert _digest(tmp_path / "a") != _digest(tmp_path / "c")
    assert _sizes(tmp_path / "a") == _sizes(tmp_path / "c")


def test_corpus_is_a_function_of_the_seed(tmp_path):
    durs = traffic.durations(4, 1.5, 0.6, 1.0, 3.0, 0)
    for name, seed in (("a", 11), ("b", 11), ("c", 12)):
        traffic.corpus(str(tmp_path / name), ["en", "ja"], 2, durs, seed,
                       "cpu")
    assert _digest(tmp_path / "a") == _digest(tmp_path / "b")
    assert _digest(tmp_path / "a") != _digest(tmp_path / "c")
    labs = [n for n in os.listdir(tmp_path / "a" / "en") if n.endswith(".lab")]
    assert len(labs) == 2


def test_sub_seeds_take_large_seeds():
    a = seeds.sub_seed(2 ** 31 + 17, "weights")
    assert a == seeds.sub_seed(2 ** 31 + 17, "weights")
    assert a != seeds.sub_seed(2 ** 31 + 17, "audio")
    assert a != seeds.sub_seed(17, "weights")
    assert 0 <= a < 2 ** 63
