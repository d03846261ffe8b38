"""Fit a k-means unit codebook on HuBERT features.

Counterpart of scripts/fit_kmeans.py: batches of wavs (each padded to
``--max-seconds``) through the encoder tower to its k-means layer, on the
card unless ``--device cpu`` (the tower's attention runs the flash kernel
there), frames cut per file, then k-means++ and Lloyd's iterations
(``models.kmeans.kmeans_fit``) on the device. The ``.npz`` (``centers``
(k, D) f32) drops into ``SpeechEncoder.by_name``'s checkpoint directory.

Usage:
  python -m speech_resynth_torch.scripts.fit_kmeans --wav-dir data/LibriTTS_R_16k --glob 'train-*/**/*.wav' \\
      --dense-model mhubert-base-vp_mls_cv_8lang --vocab 2000 --max-utts 2000 \\
      --out models/encoders/mhubert-base-vp_mls_cv_8lang-kmeans-expresso-2000.npz [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..core.device import resolve_device


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--glob", default="**/*.wav")
    p.add_argument("--dense-model", default="mhubert-base-vp_mls_cv_8lang")
    p.add_argument("--vocab", type=int, default=2000)
    p.add_argument("--max-utts", type=int, default=2000)
    p.add_argument("--max-seconds", type=float, default=20.0)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--max-frames", type=int, default=400_000, help="feature subsample cap for the Lloyd step")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        raise SystemExit(f"fit_kmeans: {exc}") from exc

    from ..dsp import audio_io
    from ..models.kmeans import KMeansQuantizer, kmeans_fit
    from ..models.speech_encoder import DENSE_MODELS, SpeechEncoder

    enc = SpeechEncoder.by_name(args.dense_model, "kmeans", args.vocab, device=device)
    spec = DENSE_MODELS[args.dense_model]
    paths = sorted(Path(args.wav_dir).glob(args.glob))[: args.max_utts]
    if not paths:
        raise SystemExit(f"no wavs under {args.wav_dir}/{args.glob}")

    feats = []
    total = 0
    max_frames_in = int(args.max_seconds * 16000)
    for i in range(0, len(paths), args.batch_size):
        chunk = paths[i : i + args.batch_size]
        wavs, lengths, _ = audio_io.read_batch(chunk, max_frames_in)
        # the padded batch without its lengths, as the JAX script runs the tower: no padding mask
        with torch.inference_mode():
            h = enc.encoder(torch.from_numpy(wavs).to(device), output_layer=spec["output_layer"]).float().cpu()  # (B, T, D)
        for j, n in enumerate(lengths):
            if n < 0:
                continue
            nf = enc.encoder.config.num_frames(int(n))
            feats.append(h[j, :nf])
            total += nf
        if total >= args.max_frames:
            break

    data = torch.cat(feats)[: args.max_frames]
    print(f"fitting k={args.vocab} on {data.shape[0]} frames of dim {data.shape[1]}")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    centers, inertia = kmeans_fit(data.to(device), args.vocab, iters=args.iters, generator=generator)
    print(f"inertia: {float(inertia):.1f}")
    KMeansQuantizer(centers).save(args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
