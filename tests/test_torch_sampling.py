"""The port's frame-label sampling (``wfl_asr_tpu_torch.infer.sampling``)
against the JAX package's on the CPU: the support of top-k and of top-p
(the top class always kept), the temperature → 0 limit (argmax), and the
frequencies of 20k draws against the probabilities the JAX functions draw
from (within 0.02). The two draw from different generators, so they agree
in distribution, not bit for bit.

    python -m pytest tests/test_torch_sampling.py -q
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wfl_asr_tpu.infer import sampling as JS
from wfl_asr_tpu_torch.infer import sampling as S

DRAWS = 20000


def _logits(seed, t=30, c=8):
    return (np.random.RandomState(seed).randn(t, c) * 2).astype(np.float32)


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_top_k_support():
    logits = _logits(0)
    topk = np.argsort(-logits, axis=-1)[:, :3]
    for seed in range(5):
        ids = S.sample_from_logits(torch.Generator().manual_seed(seed),
                                   torch.from_numpy(logits), k=3).numpy()
        assert ids.shape == (30,)
        for t in range(30):
            assert ids[t] in topk[t]


def test_top_p_support_keeps_the_top_class():
    logits = _logits(1)
    probs = _softmax(logits.astype(np.float64))
    order = np.argsort(-probs, axis=-1)
    cum = np.cumsum(np.take_along_axis(probs, order, -1), -1)
    for p in (0.8, 0.01):
        support = np.zeros(logits.shape, bool)
        for t in range(30):
            keep = cum[t] <= p
            keep[0] = True
            support[t, order[t][keep]] = True
        for seed in range(5):
            ids = S.top_p_sample(torch.Generator().manual_seed(seed),
                                 torch.from_numpy(logits), p=p).numpy()
            for t in range(30):
                assert support[t, ids[t]], (p, t, ids[t])
        if p == 0.01:   # only the top class survives
            np.testing.assert_array_equal(ids, logits.argmax(-1))


def test_temperature_extreme_is_argmax():
    logits = _logits(2, t=20, c=6)
    ids = S.sample_from_logits(torch.Generator().manual_seed(0),
                               torch.from_numpy(logits), k=6,
                               temperature=1e-4).numpy()
    np.testing.assert_array_equal(ids, logits.argmax(-1))
    ids = S.top_p_sample(torch.Generator().manual_seed(0),
                         torch.from_numpy(logits), p=0.9,
                         temperature=1e-4).numpy()
    np.testing.assert_array_equal(ids, logits.argmax(-1))


@pytest.mark.parametrize("which", ["top_k", "top_p"])
def test_frequencies_match_jax(which):
    """One frame's logits repeated DRAWS times: the port's class
    frequencies and the JAX function's, each within 0.02 of the
    probabilities the JAX function samples from."""
    row = np.array([2.0, 1.5, 1.2, 0.3, -0.5, -1.0, 0.9, 0.0], np.float32)
    probs = _softmax(row.astype(np.float64))
    if which == "top_k":
        k = 4
        want = np.zeros_like(probs)
        top = np.argsort(-probs)[:k]
        want[top] = probs[top] / probs[top].sum()
        port = S.sample_from_logits(
            torch.Generator().manual_seed(1),
            torch.from_numpy(np.tile(row, (DRAWS, 1))), k=k)
        ref = JS.sample_from_logits(jax.random.PRNGKey(1),
                                    jnp.tile(jnp.asarray(row), (DRAWS, 1)),
                                    k=k)
    else:
        p = 0.7
        order = np.argsort(-probs)
        keep = np.cumsum(probs[order]) <= p
        keep[0] = True
        want = np.zeros_like(probs)
        want[order[keep]] = probs[order[keep]]
        want /= want.sum()
        port = S.top_p_sample(
            torch.Generator().manual_seed(1),
            torch.from_numpy(np.tile(row, (DRAWS, 1))), p=p)
        ref = JS.top_p_sample(jax.random.PRNGKey(1),
                              jnp.tile(jnp.asarray(row), (DRAWS, 1)), p=p)
    f_port = np.bincount(port.numpy(), minlength=8) / DRAWS
    f_jax = np.bincount(np.asarray(ref), minlength=8) / DRAWS
    assert (want > 0).sum() >= 2
    assert np.abs(f_port - want).max() < 0.02, (f_port, want)
    assert np.abs(f_jax - want).max() < 0.02, (f_jax, want)
    assert f_port[want == 0].sum() == 0
