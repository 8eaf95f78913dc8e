"""Seeds of a run's parts, each derived from ``--seed`` and a tag, so the
data, the weights and the step's draws come from streams of their own."""

import hashlib


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag`` (the same ``seed`` and ``tag`` give the
    same value on every machine)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
