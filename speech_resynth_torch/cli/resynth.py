"""Resynthesis stage runner.

Counterpart of speech_resynth_tpu/cli/resynth.py: the same stages, resample
/ tokenize / extract_features / train_hifigan / train_flow_matching /
evaluate / synthesize, all driven by one YAML config; ``all`` runs
preprocessing (the first three), both trainers and the evaluation.
``--device`` picks where every stage runs: the card (``cuda``, the default)
unless ``cpu`` is asked for. Without a card the run stops before any stage.

Usage:
  python -m speech_resynth_torch.cli.resynth <stage> [--config configs/resynth/mhubert-expresso-2000.yaml] [--device cpu]
  python -m speech_resynth_torch.cli.resynth            # the full chain
  speech-resynth-torch <stage> ...                      # the console script
"""

from __future__ import annotations

import argparse

from ..core.config import load_config
from ..core.device import DeviceLike, resolve_device

DEFAULT_CONFIG = "configs/resynth/mhubert-expresso-2000.yaml"
STAGES = (
    "resample",
    "tokenize",
    "extract_features",
    "train_hifigan",
    "train_flow_matching",
    "evaluate",
    "synthesize",
    "all",
)


def run_stage(stage: str, config, device: DeviceLike = None) -> None:
    if stage == "resample":
        from ..pipeline.preprocess import resample

        resample(config, device)
    elif stage == "tokenize":
        from ..pipeline.preprocess import tokenize

        tokenize(config, device=device)
    elif stage == "extract_features":
        from ..pipeline.preprocess import extract_features

        extract_features(config, device)
    elif stage == "train_hifigan":
        from ..pipeline.train_loops import train_hifigan

        train_hifigan(config, device)
    elif stage == "train_flow_matching":
        from ..pipeline.train_loops import train_flow_matching

        train_flow_matching(config, device)
    elif stage == "evaluate":
        from ..pipeline.evaluate import evaluate

        evaluate(config, device=device)
    elif stage == "synthesize":
        from ..pipeline.synthesize import synthesize

        synthesize(config, device=device)
    elif stage == "all":
        from ..pipeline.evaluate import evaluate
        from ..pipeline.preprocess import preprocess
        from ..pipeline.train_loops import train_flow_matching, train_hifigan

        preprocess(config, device)
        train_hifigan(config, device)
        train_flow_matching(config, device)
        evaluate(config, device=device)
    else:
        raise SystemExit(f"unknown stage {stage!r}; choose from {STAGES}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("stage", nargs="?", default="all", choices=STAGES)
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        raise SystemExit(f"speech-resynth-torch: {exc}") from exc
    config = load_config(args.config)
    run_stage(args.stage, config, device)


if __name__ == "__main__":
    main()
