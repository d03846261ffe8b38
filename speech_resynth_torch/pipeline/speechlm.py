"""Speech-LM pipeline stages (counterpart of speech_resynth_tpu/pipeline/speechlm.py).

- ``encode``: a Libri-Light speaker shard -> deduplicated units -> one
  printable-unicode line per file;
- ``tokenize``: train the BPE over those lines (the unit characters as its
  initial alphabet) and re-encode the corpus to space-joined ids;
- ``tokenize_slm21``: sWUGGY / sBLIMP wavs -> ``{name: BPE ids}`` JSONs;
- ``evaluate``: length-normalized pseudo-log-prob score files
  (``write_scores``, the LM's full forward: K1 causal on the card), the
  pair scoring of ``slm21_native`` (or the external ``zrc`` CLI when there
  is no gold table), and the four aggregate numbers, written to
  ``scores/score.csv`` in the JAX package's layout without pandas.

Each stage runs its encoder or LM on ``device``, the card unless ``"cpu"``.
"""

from __future__ import annotations

import glob as globmod
import json
import subprocess
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.precision import BF16_INFERENCE, Policy
from ..dsp import audio_io
from ..models.convert import llama_state_dict_from_hf, load_checkpoint
from ..models.llama import LlamaConfig, LlamaLM, sequence_pseudo_log_prob
from ..models.speech_encoder import SpeechEncoder
from ..text.units import shift_unit, units_to_unicode
from ..tokenizers.bpe import BpeTokenizer
from .data import load_named_units_from_json
from .slm21_native import read_table, run_native_slm21

SAMPLE_RATE = 16000


def _make_encoder(config, device: DeviceLike = None) -> SpeechEncoder:
    """The deduplicating encoder named by ``config.s2u``."""
    return SpeechEncoder.by_name(
        config.s2u.dense_model_name,
        config.s2u.quantizer_model_name,
        config.s2u.vocab_size,
        deduplicate=True,
        device=device,
    )


def load_lm_from_hf(
    model_dir: Union[str, Path], policy: Optional[Policy] = None, device: DeviceLike = None
) -> LlamaLM:
    """Load a local HF ``LlamaForCausalLM`` directory (``config.json`` and
    ``model.safetensors`` or ``pytorch_model.bin``; the layout the JAX
    trainer's export writes) into a ``LlamaLM`` on ``device`` (the card unless
    ``"cpu"``), in ``BF16_INFERENCE`` unless ``policy`` says otherwise."""
    device = resolve_device(device)
    model_dir = Path(model_dir)
    if not model_dir.is_dir():
        raise FileNotFoundError(f"{model_dir} is not a local checkpoint directory")
    with open(model_dir / "config.json") as f:
        hf = json.load(f)
    config = LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 10000.0),
        pad_token_id=hf.get("pad_token_id") or 0,
        bos_token_id=hf.get("bos_token_id"),
        eos_token_id=hf.get("eos_token_id"),
    )
    model = LlamaLM(config, policy or BF16_INFERENCE)
    model.load_state_dict(llama_state_dict_from_hf(load_checkpoint(model_dir)))
    return model.to(device).eval().requires_grad_(False)


def _encode_batches(encoder: SpeechEncoder, paths, batch_size: int, max_seconds: float):
    """(path, unicode line) of every readable file, through the encoder in
    padded batches of ``max_seconds``."""
    paths = list(paths)
    for i in range(0, len(paths), batch_size):
        chunk = paths[i : i + batch_size]
        wavs, lengths, _ = audio_io.read_batch(chunk, int(max_seconds * SAMPLE_RATE))
        out = encoder(wavs, lengths=np.maximum(lengths, 0))
        units, counts = out["units"].cpu().numpy(), out["num_units"].cpu().numpy()
        for j, p in enumerate(chunk):
            if lengths[j] >= 0:
                yield p, units_to_unicode(units[j, : int(counts[j])])


def _encode_paths(encoder: SpeechEncoder, paths, out_file, batch_size: int = 8, max_seconds: float = 30.0) -> None:
    """One unicode line per readable file of ``paths``, in order."""
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    with open(out_file, "w") as f:
        for _, line in _encode_batches(encoder, paths, batch_size, max_seconds):
            f.write(line + "\n")


def encode(config, spk_ids: str = "1-9", device: DeviceLike = None) -> None:
    """The speakers ``[spk_ids]*`` of ``dataset.wav_dir_train`` -> unicode
    lines in ``<dataset.unicode_train><spk_ids>``."""
    wav_dir = Path(config.dataset.wav_dir_train)
    paths = sorted(wav_dir.glob(f"*/[{spk_ids}]*/**/*{config.dataset.ext_audio}"))
    _encode_paths(_make_encoder(config, device), paths, str(config.dataset.unicode_train) + spk_ids)


def tokenize(config) -> None:
    """Train the BPE (``model.vocab_size``) over every ``<dataset.unicode_train>*``
    file, save it to ``s2u.tokenizer_path`` and write the corpus as
    space-joined ids to ``dataset.train_file``."""
    files = sorted(globmod.glob(str(config.dataset.unicode_train) + "*"))
    initial_alphabet = [chr(shift_unit(u)) for u in range(config.s2u.vocab_size)]
    tokenizer = BpeTokenizer.train_files(files, config.model.vocab_size, initial_alphabet)
    Path(config.s2u.tokenizer_path).parent.mkdir(parents=True, exist_ok=True)
    tokenizer.save(config.s2u.tokenizer_path)

    Path(config.dataset.train_file).parent.mkdir(parents=True, exist_ok=True)
    with open(config.dataset.train_file, "w") as out:
        for file in files:
            with open(file) as f:
                for line in f:
                    out.write(" ".join(str(u) for u in tokenizer.encode(line.rstrip("\n"))) + "\n")


def tokenize_slm21(config, device: DeviceLike = None) -> None:
    """sWUGGY / sBLIMP dev and test wavs -> BPE-id JSONs (the dataset's four files)."""
    encoder = _make_encoder(config, device)
    tokenizer = BpeTokenizer.from_file(config.s2u.tokenizer_path)
    swuggy = Path(str(config.dataset.swuggy_dir)).expanduser()
    sblimp = Path(str(config.dataset.sblimp_dir)).expanduser()
    jobs = [
        (sorted(swuggy.glob("dev/*.wav")), config.dataset.swuggy_dev_file),
        (sorted(sblimp.glob("dev/*.wav")), config.dataset.sblimp_dev_file),
        (sorted(swuggy.glob("test/*.wav")), config.dataset.swuggy_test_file),
        (sorted(sblimp.glob("test/*.wav")), config.dataset.sblimp_test_file),
    ]
    for paths, out_file in jobs:
        _tokenize_slm21(encoder, tokenizer, out_file, paths)


def _tokenize_slm21(encoder, tokenizer, out_file, paths, batch_size: int = 8) -> None:
    """``{stem: BPE ids}`` of ``paths``, encoded in batches padded to 20 s."""
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    dataset = {Path(p).stem: tokenizer.encode(line) for p, line in _encode_batches(encoder, paths, batch_size, 20.0)}
    with open(out_file, "w") as f:
        json.dump(dataset, f)


def write_scores(model: LlamaLM, in_file, out_file, batch_size: int, num_special_tokens: int = 2) -> None:
    """'name score' lines of the length-normalized pseudo-log-prob of every
    item of ``in_file``: one full forward per batch, without an attention
    mask (the causal rule and the dropped pad labels make right padding
    harmless), on the model's device. Each score is printed as the f32 the
    JAX package prints, so equal values give equal files."""
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    with open(out_file, "w") as f, torch.inference_mode():
        for batch in load_named_units_from_json(in_file, batch_size, num_special_tokens):
            ids = torch.from_numpy(batch["input_ids"]).to(model.device, torch.long)
            logits, _ = model(ids)
            scores = sequence_pseudo_log_prob(logits, ids).cpu().numpy().astype(np.float32)
            for name, score in zip(batch["names"], scores):
                f.write(f"{name} {score}\n")


AGGREGATE_ROWS = ("sWUGGY all", "sWUGGY in-vocab", "sWUGGY out-of-vocab", "sBLIMP")


def _weighted(rows) -> float:
    n = np.array([r[0] for r in rows], np.int64)
    score = np.array([r[1] for r in rows], np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return float(np.sum(n * score) / np.sum(n))


def aggregate_slm21_scores(result_dir, split: str = "test") -> Dict[str, float]:
    """sWUGGY all / in-vocab / out-of-vocab and sBLIMP, each a mean over its
    categories weighted by their pair counts (out-of-vocab: the ``oov``
    row, NaN without one), from the pair-scoring tables; written to
    ``scores/score.csv`` as pandas writes that one-column frame."""
    scores = Path(result_dir) / "scores"
    swuggy = read_table(scores / f"score_lexical_{split}_by_frequency.csv")
    sblimp = read_table(scores / f"score_syntactic_{split}_by_type.csv")
    out = dict(zip(AGGREGATE_ROWS, (
        _weighted(swuggy.values()),
        _weighted([v for k, v in swuggy.items() if k != "oov"]),
        swuggy["oov"][1] if "oov" in swuggy else float("nan"),
        _weighted(sblimp.values()),
    )))
    with open(scores / "score.csv", "w") as f:
        f.write(",0\n" + "".join(f"{k},{'' if np.isnan(v) else repr(v)}\n" for k, v in out.items()))
    return out


def run_zrc(result_dir, sets: str = "test") -> bool:
    """Run the external zerospeech-benchmarks CLI on the score files; False
    when it is not installed or fails."""
    try:
        subprocess.run(
            ["zrc", "benchmarks:run", "sLM21", str(result_dir), "--skip-validation", "--sets", sets,
             "--task", "lexical", "syntactic"],
            check=True,
        )
        return True
    except (FileNotFoundError, subprocess.CalledProcessError):
        return False


def evaluate(config, model: LlamaLM) -> Optional[Dict[str, float]]:
    """The sLM21 test evaluation: score files for both tasks with the batch
    size ``dataloader.batch_size_per_device`` and the special-token count of
    ``config.model`` (its distinct pad, bos and eos ids), then the pair
    scoring of ``slm21_native`` when the gold tables exist, else ``zrc``;
    the four aggregate numbers, or None when neither scorer ran."""
    special = {config.model.get(k) for k in ("pad_token_id", "bos_token_id", "eos_token_id")}
    num_special = len(special - {None})
    result_dir = Path(config.dataset.result_dir)
    batch_size = config.dataloader.batch_size_per_device
    write_scores(model, config.dataset.swuggy_test_file, result_dir / "lexical/test.txt", batch_size, num_special)
    write_scores(model, config.dataset.sblimp_test_file, result_dir / "syntactic/test.txt", batch_size, num_special)
    if run_native_slm21(
        result_dir,
        dataset_dir_lexical=Path(str(config.dataset.swuggy_dir)).expanduser(),
        dataset_dir_syntactic=Path(str(config.dataset.sblimp_dir)).expanduser(),
        split="test",
    ) or run_zrc(result_dir, "test"):
        return aggregate_slm21_scores(result_dir, "test")
    return None
