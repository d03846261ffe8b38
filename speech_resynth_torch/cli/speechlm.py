"""Speech-LM stage runner.

Counterpart of speech_resynth_tpu/cli/speechlm.py: the same stages, encode /
tokenize / tokenize_slm21 / train / eval / generate, one YAML config.
``--device`` picks where every stage runs: the card (``cuda``, the default)
unless ``cpu`` is asked for. Without a card the run stops before any stage.

Usage:
  python -m speech_resynth_torch.cli.speechlm encode --config configs/speechlm/hubert.yaml --spk-ids 1-9
  python -m speech_resynth_torch.cli.speechlm train [--device cpu]
  speech-lm-torch <stage> ...                          # the console script
"""

from __future__ import annotations

import argparse

from ..core.config import load_config
from ..core.device import DeviceLike, resolve_device

DEFAULT_CONFIG = "configs/speechlm/hubert.yaml"
STAGES = ("encode", "tokenize", "tokenize_slm21", "train", "eval", "generate")


def run_stage(stage: str, config, spk_ids: str = "1-9", device: DeviceLike = None, **generate_kwargs) -> None:
    if stage == "encode":
        from ..pipeline.speechlm import encode

        encode(config, spk_ids, device=device)
    elif stage == "tokenize":
        from ..pipeline.speechlm import tokenize

        tokenize(config)
    elif stage == "tokenize_slm21":
        from ..pipeline.speechlm import tokenize_slm21

        tokenize_slm21(config, device=device)
    elif stage == "train":
        from ..pipeline.train_loops import train_speechlm

        train_speechlm(config, device=device)
    elif stage == "eval":
        from ..pipeline.train_loops import eval_speechlm

        eval_speechlm(config, device=device)
    elif stage == "generate":
        # textless continuation of a prompt wav
        from ..pipeline.train_loops import generate_speechlm

        generate_speechlm(config, device=device, **generate_kwargs)
    else:
        raise SystemExit(f"unknown stage {stage!r}; choose from {STAGES}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("stage", choices=STAGES)
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--spk-ids", default="1-9", help="speaker-id glob class for encode (tokenize.py:93)")
    parser.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    gen = parser.add_argument_group("generate stage")
    gen.add_argument("--prompt-wav", help="prompt utterance to continue")
    gen.add_argument("--out-wav", help="where to write the continued waveform")
    gen.add_argument("--decoder-dir", help="CFM+HiFi-GAN export dir for vocoding (omit to print units)")
    gen.add_argument("--max-new-tokens", type=int, default=128)
    gen.add_argument("--temperature", type=float, default=1.0)
    gen.add_argument("--top-k", type=int, default=0)
    gen.add_argument("--top-p", type=float, default=1.0)
    gen.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        raise SystemExit(f"speech-lm-torch: {exc}") from exc
    config = load_config(args.config)
    if args.stage == "generate":
        if not args.prompt_wav:
            parser.error("generate requires --prompt-wav")
        run_stage(
            "generate",
            config,
            device=device,
            prompt_wav=args.prompt_wav,
            out_wav=args.out_wav,
            decoder_dir=args.decoder_dir,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            top_k=args.top_k,
            top_p=args.top_p,
            seed=args.seed,
        )
    else:
        run_stage(args.stage, config, args.spk_ids, device)


if __name__ == "__main__":
    main()
