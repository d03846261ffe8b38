"""Convert published torch/HF checkpoints into the local layout the port's loaders read.

Counterpart of scripts/convert_checkpoints.py, with the same kinds, flags
and default outputs; safetensors are read and written by
``core.safetensors`` (no ``safetensors`` package). It writes:
  models/encoders/<dense_model>.safetensors            (HF HubertModel weights)
  models/encoders/<dense>-<quantizer>-<vocab>.npz      (k-means centers)
  models/flow_matching_with_hifigan/                   (composite CFM+vocoder)
  models/utmos.safetensors                             (the UTMOS checkpoint's tensors)
  models/whisper-large-v3/                             (an HF Whisper directory)

Usage:
  python -m speech_resynth_torch.scripts.convert_checkpoints hubert --src /path/to/hf_hubert_dir \\
      --name mhubert-base-vp_mls_cv_8lang
  python -m speech_resynth_torch.scripts.convert_checkpoints kmeans --src /path/to/centers.npy \\
      --name mhubert-base-vp_mls_cv_8lang --quantizer kmeans-expresso --vocab 2000
  python -m speech_resynth_torch.scripts.convert_checkpoints composite --src /path/to/flow_matching_with_hifigan
  python -m speech_resynth_torch.scripts.convert_checkpoints utmos --src /path/to/utmos.ckpt
  python -m speech_resynth_torch.scripts.convert_checkpoints whisper --src /path/to/whisper-large-v3
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np
import torch

from ..core.safetensors import load_file, save_file


def _torch_bin(path: Path) -> dict:
    return torch.load(path, map_location="cpu")


def _save(sd: dict, path: Path) -> None:
    """Write ``sd`` as safetensors, a 0-d tensor as shape (1,): the JAX
    script's ``np.ascontiguousarray`` writes every array with ndim >= 1."""
    save_file({k: v.reshape(1) if v.ndim == 0 else v for k, v in sd.items()}, path)


def convert_hubert(src: str, name: str, out_dir: str) -> None:
    src = Path(src)
    st = src / "model.safetensors"
    sd = load_file(st) if st.is_file() else _torch_bin(src / "pytorch_model.bin")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    _save(sd, out / f"{name}.safetensors")
    print(f"wrote {out / f'{name}.safetensors'}")


def convert_kmeans(src: str, name: str, quantizer: str, vocab: int, out_dir: str) -> None:
    src = Path(src)
    if src.suffix == ".npy":
        centers = np.load(src)
    else:  # sklearn joblib/pickle with cluster_centers_
        import joblib

        centers = joblib.load(src).cluster_centers_
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}-{quantizer}-{vocab}.npz"
    np.savez(path, centers=np.asarray(centers, np.float32))
    print(f"wrote {path}")


def convert_composite(src: str, dst: str) -> None:
    """Re-save an HF composite checkpoint dir with weights as safetensors
    (``ConditionalFlowMatchingWithHifiGan.from_pretrained`` reads it
    directly; this normalizes the format)."""
    src, dst = Path(src), Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(src / "config.json", dst / "config.json")
    st = src / "model.safetensors"
    if st.is_file():
        shutil.copy(st, dst / "model.safetensors")
    else:
        _save(_torch_bin(src / "pytorch_model.bin"), dst / "model.safetensors")
    print(f"wrote {dst}")


def convert_utmos(src: str, dst: str) -> None:
    """Extract the UTMOS lightning checkpoint's state_dict into a plain
    safetensors file (``pipeline.scorers.NativeUTMOS`` loads either). The
    raw ``.ckpt`` pickles lightning objects; only the tensors are kept."""
    blob = torch.load(src, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    dst = Path(dst)
    dst.parent.mkdir(parents=True, exist_ok=True)
    # f64, bf16 and f16 floats become f32; int and bool buffers keep their dtype
    low = (torch.float64, torch.bfloat16, torch.float16)
    _save({k: v.float() if v.dtype in low else v for k, v in sd.items()}, dst)
    print(f"wrote {dst}")


def convert_whisper(src: str, dst: str) -> None:
    """Stage an HF Whisper checkpoint dir for ``NativeWhisperASR``: weights
    as safetensors plus the config, tokenizer and generation files it reads."""
    src, dst = Path(src), Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    wanted = [
        "config.json",
        "generation_config.json",
        "tokenizer.json",
        "tokenizer_config.json",
        "vocab.json",
        "merges.txt",
        "special_tokens_map.json",
        "added_tokens.json",
        "normalizer.json",
        "preprocessor_config.json",
    ]
    for name in wanted:
        if (src / name).is_file():
            shutil.copy(src / name, dst / name)
    copied = False
    for name in ("model.safetensors", "model.safetensors.index.json"):
        if (src / name).is_file():
            shutil.copy(src / name, dst / name)
            copied = True
    if (src / "model.safetensors.index.json").is_file():
        for shard in src.glob("model-*.safetensors"):
            shutil.copy(shard, dst / shard.name)
    if not copied:
        _save(_torch_bin(src / "pytorch_model.bin"), dst / "model.safetensors")
    print(f"wrote {dst}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("kind", choices=("hubert", "kmeans", "composite", "utmos", "whisper"))
    p.add_argument("--src", required=True)
    p.add_argument("--name", default="mhubert-base-vp_mls_cv_8lang")
    p.add_argument("--quantizer", default="kmeans-expresso")
    p.add_argument("--vocab", type=int, default=2000)
    p.add_argument("--out", default="models/encoders")
    args = p.parse_args(argv)
    if args.kind == "hubert":
        convert_hubert(args.src, args.name, args.out)
    elif args.kind == "kmeans":
        convert_kmeans(args.src, args.name, args.quantizer, args.vocab, args.out)
    elif args.kind == "utmos":
        convert_utmos(args.src, args.out if args.out != "models/encoders" else "models/utmos.safetensors")
    elif args.kind == "whisper":
        convert_whisper(args.src, args.out if args.out != "models/encoders" else "models/whisper-large-v3")
    else:
        convert_composite(args.src, args.out if args.out != "models/encoders" else "models/flow_matching_with_hifigan")


if __name__ == "__main__":
    main()
