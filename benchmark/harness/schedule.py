"""The rows and flips of a run's first steps, worked out again for the
reference from the published feeding rule the engine keeps: each epoch
a permutation of the rows from ``numpy.random.default_rng(seed)``, cut
into batches in order; one flip draw of ``batch`` uniforms a batch, in
batch order, from ``default_rng([seed, 0x464C4950])``, a row mirrored
where its draw is below 0.5."""

from __future__ import annotations

import numpy as np

FLIP_STREAM = 0x464C4950


def first_batches(n_rows: int, batch: int, steps: int, seed: int, flip: bool):
    """``[(rows, mask)]`` of steps ``0 .. steps - 1`` of a run from step 0
    (all in its first epoch); ``mask`` None without flips."""
    if steps * batch > n_rows:
        raise ValueError("the first steps must lie in the first epoch")
    perm = np.random.default_rng(seed).permutation(n_rows)
    flips = np.random.default_rng([seed, FLIP_STREAM])
    out = []
    for s in range(steps):
        rows = perm[s * batch:(s + 1) * batch]
        mask = flips.random(batch) < 0.5 if flip else None
        out.append((rows, mask))
    return out
