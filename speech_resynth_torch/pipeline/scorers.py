"""Evaluation scorers: an ASR transcriber and a MOS predictor.

Counterpart of speech_resynth_tpu/pipeline/scorers.py. The harness
(``pipeline.evaluate``, the CFM loop's dev sweep) takes any object with
``transcribe`` / ``score``:

* ``NativeWhisperASR``: the port's Whisper (``models.whisper``) on the card
  from a local HF checkpoint directory (``config.json``, ``model.safetensors``
  or its sharded index or ``pytorch_model.bin``, ``vocab.json`` and the added
  tokens, optionally ``generation_config.json`` for the forced ids); audio
  past 30 s in strided windows, the windows of every request batched
  together. It decodes text with ``WhisperTextDecoder``, which reads the
  checkpoint's byte-level BPE files itself, so scoring needs no
  ``transformers``.
* ``NativeUTMOS``: the port's UTMOS (``models.utmos``) on the card from the
  published lightning checkpoint (``.ckpt`` / ``.pt``) or its tensors as
  ``.safetensors``; waves padded to 1-s buckets, the frame mean masked.
* ``TorchWhisperASR`` / ``TorchUTMOS``: the host-CPU HF pipeline and a
  torchscript MOS module, as the JAX package has them, for a caller who
  builds them explicitly (their imports are lazy).
* ``NullASR`` / ``EnergyMOS``: dependency-free stand-ins, so the harness
  runs without checkpoints.

``default_asr`` / ``default_mos`` pick the native scorer when the config
names a checkpoint and the stand-in otherwise. Unlike the JAX package they
raise when the native scorer fails to load, instead of falling back to a
host-CPU pipeline.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Protocol, Sequence, Set

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.precision import BF16_INFERENCE, Policy


class ASRScorer(Protocol):
    def transcribe(self, wavs: Sequence[np.ndarray], sample_rate: int = 16000) -> List[str]: ...


class MOSScorer(Protocol):
    def score(self, wav: np.ndarray, sample_rate: int = 16000) -> float: ...


class NullASR:
    """Placeholder transcriber (empty strings): exercises the harness without
    Whisper; its WER means nothing."""

    def transcribe(self, wavs, sample_rate: int = 16000) -> List[str]:
        return ["" for _ in wavs]


class EnergyMOS:
    """Crude signal-statistics MOS proxy in [1, 5] (loudness and clipping), a
    stand-in for UTMOS when its checkpoint is absent; not comparable across
    scorer implementations."""

    def score(self, wav, sample_rate: int = 16000) -> float:
        wav = np.asarray(wav, np.float32).reshape(-1)
        if wav.size == 0:
            return 1.0
        rms = float(np.sqrt(np.mean(wav**2)))
        clip = float(np.mean(np.abs(wav) > 0.99))
        loud = np.clip(np.interp(rms, [1e-4, 0.05, 0.3], [1.0, 4.5, 3.5]), 1.0, 5.0)
        return float(np.clip(loud - 10 * clip, 1.0, 5.0))


def merge_chunk_tokens(chunks: Sequence[Sequence[int]]) -> List[int]:
    """Merge the token sequences of overlapping windows into one: the HF ASR
    pipeline's longest-common-sequence merge (the share of matching tokens
    plus a small bonus for long overlaps, more than one match required)."""
    merged: List[int] = list(chunks[0])
    for nxt in chunks[1:]:
        nxt = list(nxt)
        best_len, best_score = 0, 0.0
        for i in range(1, min(len(merged), len(nxt)) + 1):
            matches = sum(a == b for a, b in zip(merged[-i:], nxt[:i]))
            score = matches / i + i / 10000.0  # the bonus favors long exact overlaps
            if matches > 1 and score > best_score:
                best_len, best_score = i, score
        merged.extend(nxt[best_len:])
    return merged


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table of byte-level BPE."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


SPECIAL_TOKEN_NAMES = ("bos_token", "eos_token", "unk_token", "pad_token")


def _token_content(t) -> Optional[str]:
    return t.get("content") if isinstance(t, dict) else t


class WhisperTextDecoder:
    """Decode-only reader of a Whisper checkpoint's byte-level BPE files,
    giving the text of the HF tokenizer that ``AutoTokenizer`` loads for the
    JAX scorer (the fast one: it cleans up spaces before punctuation when
    ``clean_up_tokenization_spaces`` says so, which HF's slow
    ``WhisperTokenizer`` never does; timestamp tokens are dropped from the
    text as both do). The vocabulary comes from
    ``vocab.json`` (or ``tokenizer.json``'s model), the added tokens and
    which of them are special from whichever of ``tokenizer.json``,
    ``tokenizer_config.json``, ``added_tokens.json`` and
    ``special_tokens_map.json`` the directory has. Special ids are the named
    special tokens (bos, eos, unk, pad, ``additional_special_tokens``) and
    the added tokens flagged special."""

    TIMESTAMP = re.compile(r"<\|(\d+\.\d+)\|>")

    def __init__(self, vocab: Dict[str, int], added: Dict[int, str], special_ids: Set[int], clean_up_spaces: bool = False):
        self.id_to_token = {i: t for t, i in vocab.items()}
        self.added = dict(added)
        self.all_special_ids = sorted(special_ids)
        self._special = set(special_ids)
        self.clean_up_spaces = clean_up_spaces
        self.byte_decoder = {c: b for b, c in bytes_to_unicode().items()}
        content_to_id = {**vocab, **{c: i for i, c in self.added.items()}}
        self.startofprev_id = content_to_id.get("<|startofprev|>")
        self.startoftranscript_id = content_to_id.get("<|startoftranscript|>")

    @classmethod
    def from_dir(cls, model_dir) -> "WhisperTextDecoder":
        d = Path(model_dir)

        def read(name):
            path = d / name
            return json.loads(path.read_text(encoding="utf-8")) if path.is_file() else None

        vocab, added, flagged, named = read("vocab.json"), {}, set(), set()
        tok = read("tokenizer.json")
        if tok is not None:
            vocab = vocab if vocab is not None else tok["model"]["vocab"]
            for t in tok.get("added_tokens", []):
                added[int(t["id"])] = t["content"]
                if t.get("special"):
                    flagged.add(int(t["id"]))
        if vocab is None:
            raise FileNotFoundError(f"no vocab.json or tokenizer.json in {d}")
        for content, i in (read("added_tokens.json") or {}).items():
            added[int(i)] = content
        cfg = read("tokenizer_config.json") or {}
        for i, t in (cfg.get("added_tokens_decoder") or {}).items():
            added[int(i)] = t["content"]
            if t.get("special"):
                flagged.add(int(i))
        for source in (read("special_tokens_map.json") or {}, cfg):
            for key in SPECIAL_TOKEN_NAMES:
                if source.get(key) is not None:
                    named.add(_token_content(source[key]))
            named.update(_token_content(t) for t in source.get("additional_special_tokens") or [])
        content_to_id = {**vocab, **{c: i for i, c in added.items()}}
        special = flagged | {content_to_id[c] for c in named if c in content_to_id}
        return cls(vocab, added, special, bool(cfg.get("clean_up_tokenization_spaces", False)))

    def _bytes_text(self, tokens: List[str]) -> str:
        return bytearray(self.byte_decoder[c] for c in "".join(tokens)).decode("utf-8", errors="replace")

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        ids = [int(i) for i in ids]
        if skip_special_tokens and ids and ids[0] == self.startofprev_id:
            # a previous-text prompt: the transcript starts at <|startoftranscript|>
            ids = ids[ids.index(self.startoftranscript_id):] if self.startoftranscript_id in ids else []
        pieces, run = [], []
        for i in ids:
            if skip_special_tokens and i in self._special:
                continue
            if i in self.added:
                if run:
                    pieces.append(self._bytes_text(run))
                    run = []
                pieces.append(self.added[i])
            else:
                run.append(self.id_to_token.get(i, ""))
        if run:
            pieces.append(self._bytes_text(run))
        text = "".join(pieces)
        if self.clean_up_spaces:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
                         (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
                text = text.replace(a, b)
        return self.TIMESTAMP.sub("", text)


class NativeWhisperASR:
    """Whisper from a local HF checkpoint directory, on the card unless
    ``device="cpu"``, its weights cast to ``policy`` (bf16 by default).

    Audio longer than one window (30 s) is transcribed in strided windows
    (the HF chunked semantics: step = chunk - 2 stride, tokens merged by
    ``merge_chunk_tokens``); the windows of every request of a call are
    batched together, ``batch_size`` at a time."""

    def __init__(
        self,
        model_dir,
        max_new_tokens: int = 200,
        batch_size: int = 8,
        chunk_length_s: float = 30.0,
        stride_length_s: Optional[float] = None,
        policy: Policy = BF16_INFERENCE,
        device: DeviceLike = None,
    ):
        from ..models.convert import load_checkpoint
        from ..models.whisper import WhisperConfig, WhisperForASR, whisper_state_dict_from_hf

        self.device = resolve_device(device)
        model_dir = Path(model_dir)
        with open(model_dir / "config.json") as f:
            self.config = WhisperConfig.from_hf(json.load(f))
        with self.device:  # built where it runs: no host copy of large-v3's 1.5 B parameters to initialize
            model = WhisperForASR(self.config, policy)
        model.load_state_dict(whisper_state_dict_from_hf(load_checkpoint(model_dir)))
        self.model = model.eval().requires_grad_(False)
        self.tokenizer = WhisperTextDecoder.from_dir(model_dir)
        forced = []
        gen_cfg = model_dir / "generation_config.json"
        if gen_cfg.is_file():
            with open(gen_cfg) as f:
                g = json.load(f)
            forced = [t for _, t in sorted((i, t) for i, t in (g.get("forced_decoder_ids") or []))]
        # the prompt: <|startoftranscript|> and the forced language / task / notimestamps ids
        self.prompt_ids = [self.config.decoder_start_token_id] + forced
        self.max_new_tokens = max_new_tokens
        self.batch_size = batch_size
        self.chunk_length_s = chunk_length_s
        # the HF pipeline's default: a sixth of the window on each side, so the step is 2/3 of it
        self.stride_length_s = chunk_length_s / 6.0 if stride_length_s is None else stride_length_s
        if not 0 <= self.stride_length_s < chunk_length_s / 2:
            raise ValueError(
                f"stride_length_s ({self.stride_length_s}) must be in [0, chunk_length_s/2) = "
                f"[0, {chunk_length_s / 2}): the window step is chunk - 2*stride, which must stay positive"
            )

    def _window_starts(self, n_samples: int, sample_rate: int) -> List[int]:
        """Window starts as the HF pipeline's ``chunk_iter`` takes them:
        multiples of chunk - 2 stride, up to the window that reaches the
        end, less a last window whose samples all lie in the previous one's
        right stride."""
        chunk = int(self.chunk_length_s * sample_rate)
        stride = int(self.stride_length_s * sample_rate)
        if n_samples <= chunk:
            return [0]
        starts: List[int] = []
        for s in range(0, n_samples, chunk - 2 * stride):
            if s > 0 and n_samples - s <= stride:
                break
            starts.append(s)
            if s + chunk >= n_samples:
                break
        return starts

    def window_token_ids(self, windows: Sequence[np.ndarray], sample_rate: int = 16000) -> List[List[int]]:
        """Greedy ids of each window (at most one window long), less the
        prompt, cut at eos, special ids dropped."""
        from ..dsp.mel import whisper_log_mel
        from ..models.whisper import greedy_decode

        chunk = int(self.chunk_length_s * sample_rate)
        special = set(self.tokenizer.all_special_ids)
        eos = self.config.eos_token_id
        out: List[List[int]] = []
        for b0 in range(0, len(windows), self.batch_size):
            batch = windows[b0 : b0 + self.batch_size]
            padded = np.zeros((len(batch), chunk), np.float32)
            for j, w in enumerate(batch):
                padded[j, : len(w)] = w
            mel = whisper_log_mel(torch.from_numpy(padded).to(self.device), num_mels=self.config.num_mel_bins)
            prompt = torch.tensor([self.prompt_ids] * len(batch), dtype=torch.long)
            tokens = greedy_decode(self.model, mel, self.max_new_tokens, prompt).cpu().numpy()
            for row in tokens:
                ids = row[len(self.prompt_ids) :]
                ends = np.flatnonzero(ids == eos)
                if ends.size:
                    ids = ids[: ends[0]]
                out.append([t for t in ids.tolist() if t not in special])
        return out

    def transcribe(self, wavs, sample_rate: int = 16000) -> List[str]:
        chunk = int(self.chunk_length_s * sample_rate)
        windows: List[np.ndarray] = []
        owners: List[int] = []
        for ui, w in enumerate(wavs):
            w = np.asarray(w, np.float32).reshape(-1)
            for s in self._window_starts(len(w), sample_rate):
                windows.append(w[s : s + chunk])
                owners.append(ui)
        per_utt: List[List[List[int]]] = [[] for _ in wavs]
        for owner, ids in zip(owners, self.window_token_ids(windows, sample_rate)):
            per_utt[owner].append(ids)
        return [
            self.tokenizer.decode(merge_chunk_tokens(seqs) if seqs else [], skip_special_tokens=True).strip()
            for seqs in per_utt
        ]


class TorchWhisperASR:
    """The HF Whisper pipeline on the host CPU from a local checkpoint
    directory (the reference's generate arguments). Needs ``transformers``."""

    def __init__(self, model_dir: str, language: str = "english"):
        from transformers import AutoModelForSpeechSeq2Seq, AutoProcessor, pipeline

        model = AutoModelForSpeechSeq2Seq.from_pretrained(model_dir, low_cpu_mem_usage=True, use_safetensors=True)
        processor = AutoProcessor.from_pretrained(model_dir)
        self._pipe = pipeline(
            "automatic-speech-recognition",
            model=model,
            tokenizer=processor.tokenizer,
            feature_extractor=processor.feature_extractor,
        )
        self._language = language

    def transcribe(self, wavs, sample_rate: int = 16000) -> List[str]:
        outs = self._pipe(
            [np.asarray(w, np.float32) for w in wavs],
            generate_kwargs={"language": self._language},
            return_timestamps=True,
        )
        return [o["text"] for o in outs]


def load_utmos_state_dict(ckpt_path) -> Dict[str, torch.Tensor]:
    """The UTMOS lightning state_dict from a ``.safetensors`` file of its
    tensors or a torch save (``.ckpt`` / ``.pt``, its ``state_dict`` entry
    when it has one), in the port's names."""
    from ..core.safetensors import load_file
    from ..models.convert import utmos_state_dict_from_lightning

    if str(ckpt_path).endswith(".safetensors"):
        sd = load_file(ckpt_path)
    else:
        # a lightning checkpoint pickles more than tensors
        blob = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return utmos_state_dict_from_lightning(sd)


BUCKET_SAMPLES = 16000  # waves pad to whole seconds


class NativeUTMOS:
    """UTMOS from the published checkpoint, on the card unless
    ``device="cpu"``; the tower in ``policy`` (bf16 by default), the LSTM and
    the head in f32. Domain and judge ids are clamped into their tables."""

    def __init__(self, ckpt_path, domain_id: Optional[int] = None, judge_id: Optional[int] = None,
                 policy: Optional[Policy] = None, device: DeviceLike = None):
        from ..models.utmos import UTMOSPredictor, config_from_state_dict

        self.device = resolve_device(device)
        sd = load_utmos_state_dict(ckpt_path)
        self.config = config_from_state_dict(sd)
        with self.device:
            model = UTMOSPredictor(self.config, policy or BF16_INFERENCE)
        model.load_state_dict(sd)
        self.model = model.eval().requires_grad_(False)
        cfg = self.config
        self.domain_id = max(0, min(cfg.default_domain_id if domain_id is None else domain_id, cfg.num_domains - 1))
        self.judge_id = max(0, min(cfg.default_judge_id if judge_id is None else judge_id, cfg.num_judges - 1))

    @torch.inference_mode()
    def score_batch(self, wavs: Sequence[np.ndarray]) -> List[float]:
        """MOS of each wave, the batch padded to its longest wave's bucket
        (each row's valid frames equal its run alone)."""
        wavs = [np.asarray(w, np.float32).reshape(-1) for w in wavs]
        n = max(w.size for w in wavs)
        padded = np.zeros((len(wavs), max(BUCKET_SAMPLES, -(-n // BUCKET_SAMPLES) * BUCKET_SAMPLES)), np.float32)
        for j, w in enumerate(wavs):
            padded[j, : w.size] = w
        n_samples = torch.tensor([w.size for w in wavs], device=self.device)
        ids = torch.ones(len(wavs), dtype=torch.long, device=self.device)
        frames = self.model(torch.from_numpy(padded).to(self.device), ids * self.domain_id, ids * self.judge_id, n_samples)
        mos = self.model.score_from_frames(frames, self.config.ssl.num_frames(n_samples))
        return [float(m) for m in mos.cpu()]

    def score(self, wav, sample_rate: int = 16000) -> float:
        return self.score_batch([wav])[0]


class TorchUTMOS:
    """A MOS predictor from a torchscript export: any module mapping a
    (1, T) 16 kHz waveform to a scalar MOS, on the host CPU."""

    def __init__(self, ckpt_path: str):
        self._model = torch.jit.load(ckpt_path, map_location="cpu").eval()

    def score(self, wav, sample_rate: int = 16000) -> float:
        with torch.inference_mode():
            t = torch.from_numpy(np.asarray(wav, np.float32).reshape(1, -1))
            return float(self._model(t).reshape(()))


def _config_value(config, section: str, key: str):
    try:
        return config[section].get(key)
    except (AttributeError, KeyError, TypeError):
        return None


def default_asr(config, device: DeviceLike = None) -> ASRScorer:
    """``NativeWhisperASR`` of ``asr.name`` when that directory exists, else
    ``NullASR``. A checkpoint that fails to load raises."""
    name = _config_value(config, "asr", "name")
    if name and Path(str(name)).exists():
        return NativeWhisperASR(str(name), device=device)
    return NullASR()


def default_mos(config, device: DeviceLike = None) -> MOSScorer:
    """``NativeUTMOS`` of ``eval.utmos_ckpt`` when that file exists, else
    ``EnergyMOS``. A checkpoint that fails to load raises."""
    path = _config_value(config, "eval", "utmos_ckpt")
    if path and Path(str(path)).exists():
        return NativeUTMOS(str(path), device=device)
    return EnergyMOS()
