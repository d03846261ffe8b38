"""End-to-end trained-quality run: GAN + CFM + LM on a synthetic corpus.

Counterpart of speech_resynth_tpu/pipeline/e2e_quality.py: the three
training loops must produce quality, not just decreasing losses. This
module trains all three stacks on controlled synthetic corpora
(``pipeline.synthetic``) through the pipeline loops the CLI stages call
(``pipeline.train_loops``), reads their exports back through the port's own
loaders (``models.composite.load_vocoder``,
``ConditionalFlowMatchingWithHifiGan.load_pretrained``, the LM checkpoint)
and measures:

* HiFi-GAN: mel-L1 of re-vocoded audio on held-out utterances, against the
  generator the trainer started from, with both generators' output peaks and
  how far training moved the weights (``gan_weight_change``: a generator
  drawn by the JAX package's initializers is near silent, and at a small
  scale the trained one can stay so, where the mel-L1 gate cannot tell a
  trainer that moved nothing);
* CFM: mel-L1 of ODE-sampled mels against ground truth for held-out unit
  sequences, against a fresh draw of the whole model, unit table included,
  as the JAX run draws its untrained model, with Euler and midpoint
  integration;
* full resynthesis (units → CFM → vocoder → wav): log-mel distance of the
  resynthesized audio from the source audio;
* speech LM: minimal-pair accuracy (an sWUGGY analog) of the restored
  checkpoint through ``pipeline.speechlm.write_scores``.

Every model runs on ``device`` (the card unless ``"cpu"``); the trained
pair is evaluated in f32. ``scale="ci"`` is the small configuration,
``scale="chip"`` the fuller one; both are the JAX package's.
``run_gan_quality`` runs the GAN half alone at a scale dict of the caller's
(the port's learning check: ``chip_smoke.py:gan_learning_phase``).

    python -m speech_resynth_torch.pipeline.e2e_quality <workdir> [ci|chip] [--device cpu]
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..core.config import config_from_dict
from ..core.device import DeviceLike, resolve_device
from ..core.mesh import process_count
from ..dsp.mel import log_mel_spectrogram
from .synthetic import HOP, N_FFT, make_formant_corpus, make_unit_grammar_corpus

SCALES = {
    # CI: learning evidence at small size (full-width MPD/MSD discriminators
    # make GAN steps costly on a CPU, so convergence is the card's job)
    "ci": dict(
        n_train=32, n_eval=6, gan_channels=32, gan_epochs=1, gan_batch=2, frames_per_seg=8,
        cfm_hidden=32, cfm_epochs=100, cfm_batch=8,
        lm_hidden=64, lm_layers=2, lm_epochs=3, lm_batch=16, lm_sentences=2000,
    ),
    "chip": dict(
        n_train=192, n_eval=16, gan_channels=128, gan_epochs=150, gan_batch=16, frames_per_seg=16,
        cfm_hidden=64, cfm_epochs=150, cfm_batch=16,
        lm_hidden=128, lm_layers=4, lm_epochs=4, lm_batch=32, lm_sentences=8000,
    ),
}

N_UNITS = 8


def _gan_config(tmp: Path, corpus, p) -> dict:
    return config_from_dict(
        {
            "dataset": {
                "wav_dir": str(corpus["wav_dir"]),
                "spectrogram_dir": str(corpus["spec_dir"]),
                "train_file": str(corpus["train_file"]),
                "ext_audio": ".wav",
            },
            "hifigan": {
                "path": str(tmp / "hifigan"),
                "batch_size": p["gan_batch"],
                "segment_size": (p["frames_per_seg"] - 1) * HOP + N_FFT,
                "training_epochs": p["gan_epochs"],
                "learning_rate": 2e-4,
                "adam_b1": 0.8,
                "adam_b2": 0.99,
                "lr_decay": 0.999,
                "seed": 1234,
                "n_fft": N_FFT,
                "hop_size": HOP,
                "upsample_rates": [5, 4, 4, 2, 2],
                "upsample_kernel_sizes": [10, 9, 8, 4, 4],
                "upsample_initial_channel": p["gan_channels"],
                "resblock_kernel_sizes": [3, 7],
                "resblock_dilation_sizes": [[1, 3], [1, 3]],
                "stdout_interval": 1000,
                "summary_interval": 50,
                "checkpoint_interval": 10**9,  # export happens at end-of-run
                "validation_interval": 10**9,
            },
        }
    )


def _cfm_config(tmp: Path, corpus, p) -> dict:
    return config_from_dict(
        {
            "common": {"seed": 0},
            "dataset": {
                "wav_dir": str(corpus["wav_dir"]),
                "spectrogram_dir": str(corpus["spec_dir"]),
                "ext_audio": ".wav",
                "train_file": str(corpus["train_file"]),
                "dev_file": str(tmp / "missing_dev.json"),
            },
            "flow_matching": {
                "path": str(tmp / "cfm"),
                "batch_size": p["cfm_batch"],
                "frames_per_seg": p["frames_per_seg"],
                "epoch": p["cfm_epochs"],
                "warmup_steps": 20,
                "lr": 2e-3,
                "lr_min": 2e-4,
                "max_norm": 0.1,
                "summary_interval": 50,
                "save_interval_epoch": p["cfm_epochs"],
                "dt": 0.125,
                "truncation_value": 1.0,
                "dense_model_name": "_e2e_formant",  # registered below
                "quantizer_model_name": "kmeans",
                "vocab_size": N_UNITS,
                "dim_in": 80,
                "dim_cond_emb": 32,
                "hidden_size": p["cfm_hidden"],
                "depth": 2,
                "heads": 2,
                "intermediate_size": 2 * p["cfm_hidden"],
                "ff_dropout": 0.0,
                "use_unet_skip_connection": False,
                "conv_pos_embed_kernel_size": 15,
                "conv_pos_embed_groups": p["cfm_hidden"],
                "attn_dropout": 0.0,
                "mean": -5.8843,
                "std": 2.2615,
                "predict_duration": False,
            },
        }
    )


def _register_tiny_encoder():
    """The CFM loop needs a registered encoder only for the frozen embedding
    table geometry; quality here is measured on ground-truth units."""
    from ..models import speech_encoder as SE
    from ..models.hubert import HubertConfig

    SE.DENSE_MODELS["_e2e_formant"] = {
        "config": HubertConfig(
            hidden_size=32,
            num_hidden_layers=1,
            num_attention_heads=2,
            intermediate_size=48,
            conv_dim=(16, 16),
            conv_kernel=(10, 4),
            conv_stride=(5, 4),
            num_conv_pos_embeddings=8,
            num_conv_pos_embedding_groups=2,
        ),
        "output_layer": 1,
    }


def _mel_l1(a: np.ndarray, b: np.ndarray) -> float:
    n = min(a.shape[0], b.shape[0])
    return float(np.mean(np.abs(a[:n] - b[:n])))


EVAL_PAD_FRAMES = 48  # eval utterances padded to one shape, as the JAX run pads them


def _log_mel(wav: torch.Tensor) -> np.ndarray:
    return log_mel_spectrogram(wav, n_fft=N_FFT, hop_size=HOP)[0].float().cpu().numpy()


@torch.inference_mode()
def _eval_vocoder(gen, eval_names, spec_dir, device: torch.device) -> tuple:
    """(mel-L1 between mel(G(mel)) and mel, max |G(mel)|) over held-out
    utterances, each padded to EVAL_PAD_FRAMES with the log-mel floor."""
    errs, peak = [], 0.0
    for name in eval_names:
        mel = np.load(spec_dir / (name + ".npy")).astype(np.float32)
        T = mel.shape[0]
        padded = np.pad(mel, ((0, EVAL_PAD_FRAMES - T), (0, 0)), constant_values=np.log(1e-5))
        wav = gen(torch.from_numpy(padded[None]).to(device))
        errs.append(_mel_l1(_log_mel(wav)[:T], mel))
        peak = max(peak, float(wav.abs().max()))
    return float(np.mean(errs)), peak


def _weight_change(start: torch.nn.Module, end: torch.nn.Module) -> float:
    """||end - start|| / ||start|| over the tensors of two models of one
    architecture: 0 when ``end`` holds the draw ``start`` holds."""
    a, b = start.state_dict(), end.state_dict()
    diff = sum(float((b[k].double().cpu() - v.double().cpu()).pow(2).sum()) for k, v in a.items())
    return math.sqrt(diff / sum(float(v.double().pow(2).sum()) for v in a.values()))


def _padded_ids(units, device: torch.device) -> torch.Tensor:
    """(1, EVAL_PAD_FRAMES) ids: the units + 1, 0 (pad, masked frames) after them."""
    ids = np.asarray(units, np.int64) + 1
    return torch.from_numpy(np.pad(ids, (0, EVAL_PAD_FRAMES - len(ids)))[None]).to(device)


def _untrained_cfm(config, seed: int, device: DeviceLike = None):
    """The CFM the trained one is held against: a fresh draw of the whole
    model (f32, frozen), unit table included, as the JAX run draws its
    untrained model; not the trained model's table."""
    from ..core.precision import FLOAT32
    from ..train.cfm import build_model

    return build_model(config, None, FLOAT32, seed, device).eval().requires_grad_(False)


def _corpora(tmp: Path, p) -> tuple:
    """The training corpus (seed 0) and the held-out one (seed 99) of a scale."""
    train_corpus = make_formant_corpus(tmp / "train_corpus", n_utts=p["n_train"], n_units=N_UNITS, seed=0)
    eval_corpus = make_formant_corpus(tmp / "eval_corpus", n_utts=p["n_eval"], n_units=N_UNITS, seed=99)
    return train_corpus, eval_corpus


def _gan_quality(tmp: Path, p, train_corpus, eval_names, spec_dir, device: torch.device) -> Dict:
    """Train the GAN of scale ``p`` (``_gan_config``) and measure it against
    the generator the trainer started from."""
    from ..core.precision import FLOAT32
    from ..models.composite import init_random_weights, load_vocoder
    from ..models.hifigan import HifiGanGenerator
    from .train_loops import _hifigan_config, train_hifigan

    results: Dict = {}
    gan_cfg = _gan_config(tmp, train_corpus, p)
    untrained_gen = HifiGanGenerator(_hifigan_config(gan_cfg.hifigan), FLOAT32)
    init_random_weights(untrained_gen, torch.Generator().manual_seed(gan_cfg.hifigan.seed))
    untrained_gen = untrained_gen.to(device).eval().requires_grad_(False)
    results["gan_mel_l1_untrained"], results["gan_peak_untrained"] = _eval_vocoder(untrained_gen, eval_names, spec_dir, device)

    results["gan_steps"] = train_hifigan(gan_cfg, device)["step"]

    trained_gen = load_vocoder(Path(gan_cfg.hifigan.path), FLOAT32).to(device).eval().requires_grad_(False)
    results["gan_mel_l1_trained"], results["gan_peak_trained"] = _eval_vocoder(trained_gen, eval_names, spec_dir, device)
    results["gan_weight_change"] = _weight_change(untrained_gen, trained_gen)
    return results


def run_gan_quality(workdir: str | Path, p: dict, device: DeviceLike = None) -> Dict:
    """The quality run's GAN half alone at the scale dict ``p`` (the keys of
    ``SCALES`` that the GAN reads: n_train, n_eval, gan_channels,
    gan_epochs, gan_batch, frames_per_seg), on its own corpora: the
    ``gan_*`` results of ``run_e2e_quality``, the steps taken among them."""
    device = resolve_device(device)
    tmp = Path(workdir)
    tmp.mkdir(parents=True, exist_ok=True)
    train_corpus, eval_corpus = _corpora(tmp, p)
    eval_names = sorted(json.loads(Path(eval_corpus["train_file"]).read_text()))
    return _gan_quality(tmp, p, train_corpus, eval_names, eval_corpus["spec_dir"], device)


def run_e2e_quality(workdir: str | Path, scale: str = "ci", device: DeviceLike = None) -> Dict:
    from ..core.precision import FLOAT32
    from ..models.composite import ConditionalFlowMatchingWithHifiGan
    from .speechlm import write_scores
    from .train_loops import _restore_lm, train_flow_matching, train_speechlm

    device = resolve_device(device)
    p = SCALES[scale]
    tmp = Path(workdir)
    tmp.mkdir(parents=True, exist_ok=True)
    results: Dict = {"scale": scale}

    train_corpus, eval_corpus = _corpora(tmp, p)
    eval_ds = json.loads(Path(eval_corpus["train_file"]).read_text())
    eval_names = sorted(eval_ds.keys())
    spec_dir = eval_corpus["spec_dir"]

    # ---- HiFi-GAN: the generator the trainer starts from, then the trained export
    results.update(_gan_quality(tmp, p, train_corpus, eval_names, spec_dir, device))
    voc_dir = Path(_gan_config(tmp, train_corpus, p).hifigan.path)

    # ---- CFM: the trained pair through load_pretrained; the start of training beside it
    _register_tiny_encoder()
    cfm_cfg = _cfm_config(tmp, train_corpus, p)
    train_flow_matching(cfm_cfg, device)

    pair = ConditionalFlowMatchingWithHifiGan.load_pretrained(
        Path(cfm_cfg.flow_matching.path) / "hf", voc_dir, policy=FLOAT32, device=device
    )
    trained = pair.model
    untrained = _untrained_cfm(trained.config, int(cfm_cfg.common.seed), device)

    def sample(model, name, dt: float, seed: int, ode_method: str = "euler") -> torch.Tensor:
        generator = torch.Generator(device=device).manual_seed(seed)
        mel, _ = model.sample(_padded_ids(eval_ds[name]["units"], device), dt, 1.0, generator=generator,
                              ode_method=ode_method)
        return mel

    def cfm_eval(model, dt: float = 0.125, ode_method: str = "euler") -> float:
        errs = []
        for name in eval_names:
            T = len(eval_ds[name]["units"])
            mel_gt = np.load(spec_dir / (name + ".npy")).astype(np.float32)
            errs.append(_mel_l1(sample(model, name, dt, 5, ode_method)[0, :T].cpu().numpy(), mel_gt))
        return float(np.mean(errs))

    results["cfm_mel_l1_untrained"] = cfm_eval(untrained)
    results["cfm_mel_l1_trained"] = cfm_eval(trained)
    # the midpoint integrator on the same trained flow: equal evaluations (4
    # midpoint steps = 8, as Euler at dt 0.125) and half (2 steps = 4)
    results["cfm_mel_l1_trained_midpoint_eqnfe"] = cfm_eval(trained, dt=0.25, ode_method="midpoint")
    results["cfm_mel_l1_trained_midpoint_halfnfe"] = cfm_eval(trained, dt=0.5, ode_method="midpoint")

    # ---- full resynthesis: units -> CFM mel -> vocoder -> wav -------------
    dists = []
    with torch.inference_mode():
        for name in eval_names:
            T = len(eval_ds[name]["units"])
            mel_gt = np.load(spec_dir / (name + ".npy")).astype(np.float32)
            wav = pair.vocoder(sample(trained, name, 0.125, 6))
            dists.append(_mel_l1(_log_mel(wav)[:T], mel_gt))
    results["resynth_mel_l1"] = float(np.mean(dists))

    # ---- speech LM: minimal-pair accuracy ---------------------------------
    grammar = make_unit_grammar_corpus(tmp / "lm_corpus", n_sentences=p["lm_sentences"], seed=0)
    lm_cfg = config_from_dict(
        {
            "model": {
                "path": str(tmp / "lm"),
                "vocab_size": 10,
                "hidden_size": p["lm_hidden"],
                "intermediate_size": 4 * p["lm_hidden"],
                "num_hidden_layers": p["lm_layers"],
                "num_attention_heads": 2,
                "pad_token_id": 0,
                "eos_token_id": 1,
            },
            "dataset": {
                "train_file": str(grammar["train_file"]),
                "units_per_sample": 16,
                "result_dir": str(tmp / "lm_results"),
                "swuggy_dev_file": str(tmp / "missing.json"),
                "sblimp_dev_file": str(tmp / "missing.json"),
            },
            "dataloader": {"batch_size_per_device": max(p["lm_batch"] // process_count(), 1)},
            "optim": {
                "epoch": p["lm_epochs"],
                "warmup_steps": 20,
                "lr": 2e-3,
                "lr_min": 2e-4,
                "beta1": 0.9,
                "beta2": 0.98,
                "max_norm": 1.0,
                "summary_interval": 100,
            },
        }
    )
    train_speechlm(lm_cfg, device)

    # the trained checkpoint restored, the minimal pairs scored
    lm, num_special = _restore_lm(lm_cfg, device)
    scores_file = tmp / "pair_scores.txt"
    write_scores(lm, grammar["pairs_file"], scores_file, batch_size=16, num_special_tokens=num_special)
    scores = {}
    for line in scores_file.read_text().splitlines():
        name, s = line.rsplit(" ", 1)
        scores[name] = float(s)
    n_pairs = sum(1 for k in scores if k.startswith("real_"))
    wins = sum(1 for k in scores if k.startswith("real_") and scores[k] > scores["fake_" + k[5:]])
    results["lm_pair_accuracy"] = wins / max(n_pairs, 1)
    results["lm_pairs"] = n_pairs

    with open(tmp / "E2E_QUALITY.json", "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    import argparse
    import time

    parser = argparse.ArgumentParser(description="the end-to-end trained-quality run; writes <workdir>/E2E_QUALITY.json")
    parser.add_argument("workdir")
    parser.add_argument("scale", nargs="?", default="chip", choices=sorted(SCALES))
    parser.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    args = parser.parse_args()
    t0 = time.perf_counter()
    out = run_e2e_quality(args.workdir, args.scale, args.device)
    print(json.dumps({**out, "wall_seconds": time.perf_counter() - t0}, indent=2))
