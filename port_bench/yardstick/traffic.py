"""The one traffic generator: every mix is a data file of parameters
(``port_bench/traffic/<name>.json``) that these functions read.

Utterance lengths: a lognormal in seconds (``length_s``: median, sigma,
clipped to [min, max]), taken as the stratified quantiles of a block of
``block`` requests. The block is cut once, by ``partition_seed``, into
groups of ``group`` requests (the server's batch), so every block holds the
same groups of lengths; the run's seed orders the groups and the requests
inside each, and draws the unit ids. Runs with different seeds then do the
same work, batch for batch, in another order.
"""

from __future__ import annotations

import math
import statistics
from typing import Iterator, Tuple

import numpy as np


def block_lengths_s(length_s: dict, block: int) -> np.ndarray:
    """The ``block`` stratified quantiles of the clipped lognormal, in seconds."""
    normal = statistics.NormalDist()
    q = [(i + 0.5) / block for i in range(block)]
    mu, sigma = math.log(length_s["median"]), length_s["sigma"]
    raw = np.array([math.exp(mu + sigma * normal.inv_cdf(p)) for p in q])
    return np.clip(raw, length_s["min"], length_s["max"])


def block_units(traffic: dict) -> np.ndarray:
    """Unit counts of one block: seconds x the unit rate x units per frame
    (1 for frame-rate units, below 1 for deduplicated runs), at least 1."""
    seconds = block_lengths_s(traffic["length_s"], traffic["block"])
    per_s = traffic["unit_rate_hz"] * traffic.get("units_per_frame", 1.0)
    return np.maximum(1, np.rint(seconds * per_s)).astype(np.int64)


def unit_ids(rng: np.random.Generator, n: int, vocab: int, runs: bool) -> np.ndarray:
    """``n`` unit ids uniform over 1..vocab (0 is the pad id). ``runs`` False:
    deduplicated units, no id equal to the one before it (each step adds a
    uniform 1..vocab-1 modulo the vocabulary)."""
    if runs:
        return rng.integers(1, vocab + 1, n).astype(np.int64)
    steps = rng.integers(1, vocab, n)
    steps[0] = rng.integers(1, vocab + 1)
    return (np.cumsum(steps) - 1) % vocab + 1


def block_groups(traffic: dict) -> list:
    """The block's unit counts cut into its fixed groups (one batch each)."""
    units = block_units(traffic)
    order = np.random.default_rng(traffic["partition_seed"]).permutation(len(units))
    g = traffic["group"]
    return [units[order[i : i + g]] for i in range(0, len(units), g)]


def request_stream(traffic: dict, vocab: int, seed: int) -> Iterator[Tuple[int, np.ndarray]]:
    """(index, unit ids) for ever: block after block, each its fixed groups
    in an order drawn from ``seed``, each group's requests shuffled too."""
    rng = np.random.default_rng(seed)
    groups = block_groups(traffic)
    runs = traffic.get("units_per_frame", 1.0) >= 1.0
    index = 0
    while True:
        for k in rng.permutation(len(groups)):
            for n in rng.permutation(groups[k]):
                yield index, unit_ids(rng, int(n), vocab, runs)
                index += 1


def first_longest(traffic: dict, vocab: int, seed: int) -> int:
    """Index of the first request of the stream with the block's largest unit count."""
    lengths = [len(u) for _, (_, u) in zip(range(traffic["block"]), request_stream(traffic, vocab, seed))]
    return int(np.argmax(lengths))


def train_batch(torch, generator, traffic: dict, vocab: int, dim_in: int):
    """One training batch drawn on the generator's device: ``batch_size`` rows
    of ``frames_per_seg`` frames, the first ``full_share`` of them full crops,
    the rest valid for a uniform [min_frames, frames_per_seg] frames; unit ids
    uniform over 1..vocab (0 past a row's end) and mel labels N(mel_mean,
    mel_std^2) (-100 past a row's end, the trainer's pad label)."""
    dev = generator.device
    b, n = traffic["batch_size"], traffic["frames_per_seg"]
    lengths = torch.randint(traffic["min_frames"], n + 1, (b,), generator=generator, device=dev)
    lengths[: int(b * traffic["full_share"])] = n
    pad = torch.arange(n, device=dev)[None, :] >= lengths[:, None]
    ids = torch.randint(1, vocab + 1, (b, n), generator=generator, device=dev).masked_fill(pad, 0)
    mels = torch.randn(b, n, dim_in, generator=generator, device=dev) * traffic["mel_std"] + traffic["mel_mean"]
    return {"input_ids": ids, "spectrogram_labels": mels.masked_fill(pad[..., None], -100.0)}, lengths
