"""Sub-seeds of a run's ``--seed`` (any whole number, also above 2**32)."""

import numpy as np

PURPOSES = ("weights", "audio", "check")


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` (one of ``PURPOSES``)."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
             PURPOSES.index(purpose)]
    a, b = np.random.SeedSequence(words).generate_state(2)
    return (int(a) << 31 | int(b) >> 1) & 0x7FFFFFFFFFFFFFFF
