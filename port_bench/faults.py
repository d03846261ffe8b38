#!/usr/bin/env python3
"""Faults planted in the program underneath a whole run, to show that
``correct`` catches them: each is a function that patches the program
(given pytest's ``monkeypatch`` or a ``Patch``) for the run's duration.

    python3 port_bench/faults.py --workload <cell> --fault <name> --seeds <n> [<n> ...] [--seconds s]

runs the cell on the card with the fault planted and prints each seed's
numbers compared: the readings a training cell's limits are held against.
The CPU tests (``port_bench/tests/test_bench_faults.py``) plant the same
faults at a small size. The benchmark's own runs never plant any.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class Patch:
    """``monkeypatch.setattr``'s form, undone by ``undo``."""

    def __init__(self):
        self._saved = []

    def setattr(self, target, name, value):
        self._saved.append((target, name, getattr(target, name)))
        setattr(target, name, value)

    def undo(self):
        while self._saved:
            target, name, value = self._saved.pop()
            setattr(target, name, value)


def ode_state_unchanged(patch):
    """Every ODE step returns its state unchanged (a velocity of zero)."""
    import torch

    from speech_resynth_torch.models import cfm

    patch.setattr(cfm.ConditionalFlowMatchingModel, "_velocity", lambda self, xt, *a, **k: torch.zeros_like(xt))


def half_the_batch_left_out(patch):
    """The vocoder computes the first half of a batch's rows; the rest read silence."""
    import torch

    from speech_resynth_torch.models import hifigan

    forward = hifigan.HifiGanGenerator.forward

    def half(self, spectrogram):
        b = spectrogram.shape[0]
        out = forward(self, spectrogram[: (b + 1) // 2])
        return torch.cat([out, torch.zeros((b - out.shape[0], out.shape[1]), dtype=out.dtype, device=out.device)])

    patch.setattr(hifigan.HifiGanGenerator, "forward", half)


def answers_altered(patch):
    """Each row's mel is its neighbour's (lengths as they were): an answer altered where it is produced."""
    from speech_resynth_torch.models import cfm

    sample = cfm.ConditionalFlowMatchingModel.sample

    def swapped(self, *a, **k):
        mel, mask = sample(self, *a, **k)
        return mel.roll(1, dims=0), mask

    patch.setattr(cfm.ConditionalFlowMatchingModel, "sample", swapped)


def units_altered(patch):
    """The quantizer's units, each moved one frame later along its row: the encoder's answers altered where produced."""
    from speech_resynth_torch.models import kmeans

    call = kmeans.KMeansQuantizer.__call__

    def shifted(self, features):
        return call(self, features).roll(1, dims=-1)

    patch.setattr(kmeans.KMeansQuantizer, "__call__", shifted)


def optimizer_state_unchanged(patch):
    """The optimizer's step leaves the weights and its state as they were."""
    from speech_resynth_torch.train import common

    patch.setattr(common.Optimizer, "step", lambda self, grads: False)


def steps_skipped_after_warm_up(patch):
    """After the first three updates (the set-up's), the optimizer's step leaves the weights and its state as they were."""
    from speech_resynth_torch.train import common

    step = common.Optimizer.step
    patch.setattr(common.Optimizer, "step", lambda self, grads: step(self, grads) if self.count < 3 else False)


def half_the_rows_in_the_loss(patch):
    """The loss and its gradient are taken over the first half of the batch's rows (their mean)."""
    from speech_resynth_torch.models import cfm

    terms = cfm.ConditionalFlowMatchingModel.loss_terms

    def half(self, input_ids, labels, *a, **k):
        b = (input_ids.shape[0] + 1) // 2
        return terms(self, input_ids[:b], labels[:b], *a, **k)

    patch.setattr(cfm.ConditionalFlowMatchingModel, "loss_terms", half)


SERVING = (ode_state_unchanged, half_the_batch_left_out, answers_altered)
ENCODING = (units_altered,)
TRAINING = (optimizer_state_unchanged, steps_skipped_after_warm_up, half_the_rows_in_the_loss)
FAULTS = {f.__name__: f for f in SERVING + ENCODING + TRAINING}


def main() -> int:
    from port_bench import harness

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--fault", required=True, choices=sorted(FAULTS))
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("faults: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        patch = Patch()
        FAULTS[args.fault](patch)
        try:
            result = harness.execute(args.workload, seed, args.seconds, False, "cuda")
        finally:
            patch.undo()
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed, "correct": result["correct"],
                          "readings": {k: c["value"] for k, c in result["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
