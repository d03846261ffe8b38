"""The port's CLIs, synthetic corpora and package surface against the JAX package.

* ``pipeline.synthetic``: both corpora from the same seeds, against the JAX
  package's: the wav files byte-equal, the unit JSON, file list and pair
  files equal, the mel ``.npy`` within ``CORPUS_MEL_TOL``.
* ``cli.resynth`` / ``cli.speechlm``: the stages and the argparse options
  (less the port's ``--device``) equal the JAX CLIs'; ``run_stage`` of
  every stage calls the counterpart functions in the same order with the
  same arguments (both packages' targets replaced by recorders: no stage
  runs); without a card and without ``--device cpu`` ``main`` exits
  non-zero before any stage; ``--help`` in subprocesses; the
  ``[project.scripts]`` targets.
* The port's own chain on the CPU: ``cli.resynth`` ``all`` then
  ``synthesize`` on tests/test_cli_chain.py's corpus and YAML (a tiny HuBERT
  registered in the port's ``DENSE_MODELS``, the discriminators cut to 8
  and 16 channels as tests/test_torch_train_loops.py cuts them), with that
  test's checks; ``cli.speechlm`` ``train`` then ``eval`` on a tiny corpus.
* ``models.__all__`` and ``parallel.__all__`` against the JAX package's
  (less the GSPMD-only ``data_sharded``, ``replicate``, ``replicated``).
"""

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from speech_resynth_tpu.cli import resynth as jax_resynth
from speech_resynth_tpu.cli import speechlm as jax_speechlm
from speech_resynth_tpu.pipeline import synthetic as jax_synthetic
from speech_resynth_torch.cli import resynth as torch_resynth
from speech_resynth_torch.cli import speechlm as torch_speechlm
from speech_resynth_torch.dsp import audio_io
from speech_resynth_torch.models import hifigan as TH
from speech_resynth_torch.models import speech_encoder as SE
from speech_resynth_torch.models.hubert import HubertConfig
from speech_resynth_torch.pipeline import synthetic as torch_synthetic

REPO = Path(__file__).resolve().parent.parent
# tests/test_torch_preprocess.py's bound on a corpus's log-mels, held here on
# the mel energies exp(mel) as a relative bound, with an absolute floor: the
# formant corpus's pure tones leave most bins at the 1e-5 clamp, where both
# packages' f32 DFT sums (400 unit-scale terms) are off the f64 mel by
# ~1e-8 of energy, i.e. up to 2e-3 in log (measured: 1.7e-3 for the port,
# 9e-4 for the JAX package, 6e-7 the largest energy difference between them)
CORPUS_MEL_TOL = dict(rtol=5e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch: the suite runs six workers on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# synthetic corpora
# ---------------------------------------------------------------------------


def test_formant_corpus_equals_jax(tmp_path):
    kw = dict(n_utts=6, n_units=5, n_speakers=2, units_per_utt=(3, 6), frames_per_unit=3, seed=7)
    ours = torch_synthetic.make_formant_corpus(tmp_path / "torch", **kw)
    theirs = jax_synthetic.make_formant_corpus(tmp_path / "jax", **kw)
    assert (torch_synthetic.SR, torch_synthetic.HOP, torch_synthetic.N_FFT) == (jax_synthetic.SR, jax_synthetic.HOP, jax_synthetic.N_FFT)
    np.testing.assert_array_equal(ours["formants"], theirs["formants"])
    for key in ("train_file", "filelist"):
        assert Path(ours[key]).read_text() == Path(theirs[key]).read_text(), key
    names = Path(ours["filelist"]).read_text().split()
    assert len(names) == 6
    for name in names:
        assert (ours["wav_dir"] / f"{name}.wav").read_bytes() == (theirs["wav_dir"] / f"{name}.wav").read_bytes(), name
        mel, want = (np.load(c["spec_dir"] / f"{name}.npy") for c in (ours, theirs))
        assert mel.shape == want.shape and mel.dtype == np.float32
        np.testing.assert_allclose(np.exp(mel.astype(np.float64)), np.exp(want.astype(np.float64)), **CORPUS_MEL_TOL,
                                   err_msg=name)
        loud = want > np.log(1e-3)  # away from the floor the log-mels hold the bound as it stands
        np.testing.assert_allclose(mel[loud], want[loud], rtol=0, atol=CORPUS_MEL_TOL["rtol"], err_msg=name)


def test_synth_utterance_equals_jax():
    formants = torch_synthetic._unit_formants(4)
    units = np.array([0, 3, 1, 2])
    ours = torch_synthetic.synth_utterance(units, formants, 1.12, 2, np.random.default_rng(3))
    theirs = jax_synthetic.synth_utterance(units, formants, 1.12, 2, np.random.default_rng(3))
    np.testing.assert_array_equal(ours, theirs)
    assert len(ours) == (len(units) * 2 - 1) * torch_synthetic.HOP + torch_synthetic.N_FFT


def test_unit_grammar_corpus_equals_jax(tmp_path):
    ours = torch_synthetic.make_unit_grammar_corpus(tmp_path / "torch", n_sentences=60, seed=3)
    theirs = jax_synthetic.make_unit_grammar_corpus(tmp_path / "jax", n_sentences=60, seed=3)
    for key in ("train_file", "pairs_file"):
        assert Path(ours[key]).read_text() == Path(theirs[key]).read_text(), key
    assert len(json.loads(Path(ours["pairs_file"]).read_text())) == 400


# ---------------------------------------------------------------------------
# the CLIs: stages, options, dispatch
# ---------------------------------------------------------------------------


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch) -> argparse.ArgumentParser:
    """The parser ``main`` builds, caught at its ``parse_args``."""
    caught = {}

    def parse_args(self, *args, **kwargs):
        caught["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_Parsed):
        main([])
    monkeypatch.undo()
    return caught["parser"]


def _options(parser) -> list:
    return [
        (tuple(a.option_strings), a.dest, a.default, a.type, tuple(a.choices or ()), a.nargs, a.help)
        for a in parser._actions
        if "--device" not in a.option_strings
    ]


@pytest.mark.parametrize("ours,theirs", [(torch_resynth, jax_resynth), (torch_speechlm, jax_speechlm)], ids=["resynth", "speechlm"])
def test_cli_stages_and_options_equal_jax(ours, theirs, monkeypatch):
    assert ours.STAGES == theirs.STAGES
    assert ours.DEFAULT_CONFIG == theirs.DEFAULT_CONFIG
    ours_parser, theirs_parser = _parser_of(ours.main, monkeypatch), _parser_of(theirs.main, monkeypatch)
    assert _options(ours_parser) == _options(theirs_parser)
    device = [a for a in ours_parser._actions if "--device" in a.option_strings]
    assert len(device) == 1 and device[0].default == "cuda"


# the functions each CLI's run_stage reaches, by module (relative to the package)
RESYNTH_TARGETS = {
    "pipeline.preprocess": ("resample", "tokenize", "extract_features", "preprocess"),
    "pipeline.train_loops": ("train_hifigan", "train_flow_matching"),
    "pipeline.evaluate": ("evaluate",),
    "pipeline.synthesize": ("synthesize",),
}
SPEECHLM_TARGETS = {
    "pipeline.speechlm": ("encode", "tokenize", "tokenize_slm21"),
    "pipeline.train_loops": ("train_speechlm", "eval_speechlm", "generate_speechlm"),
}


def _record(monkeypatch, package: str, targets: dict) -> list:
    """Replace ``targets`` in ``package`` by recorders of (module.function, args, kwargs)."""
    calls = []
    for module, names in targets.items():
        mod = importlib.import_module(f"{package}.{module}")
        for name in names:
            def recorder(*args, _name=f"{module}.{name}", **kwargs):
                calls.append((_name, args, kwargs))

            monkeypatch.setattr(mod, name, recorder)
    return calls


@pytest.mark.parametrize("stage", torch_resynth.STAGES)
def test_resynth_dispatch_equals_jax(stage, monkeypatch):
    ours = _record(monkeypatch, "speech_resynth_torch", RESYNTH_TARGETS)
    theirs = _record(monkeypatch, "speech_resynth_tpu", RESYNTH_TARGETS)
    config, device = object(), torch.device("cpu")
    torch_resynth.run_stage(stage, config, device)
    jax_resynth.run_stage(stage, config)
    assert [c[0] for c in ours] == [c[0] for c in theirs] and ours
    for (name, args, kwargs), (_, jargs, jkwargs) in zip(ours, theirs):
        # the port passes the device, as the last positional argument or by name, and nothing else more
        got = list(args) + list(kwargs.values())
        assert got.pop() is device and kwargs.get("device", device) is device, (name, args, kwargs)
        assert got == list(jargs) + list(jkwargs.values()), name
    assert len(ours) == (4 if stage == "all" else 1)


@pytest.mark.parametrize("stage", torch_speechlm.STAGES)
def test_speechlm_dispatch_equals_jax(stage, monkeypatch):
    ours = _record(monkeypatch, "speech_resynth_torch", SPEECHLM_TARGETS)
    theirs = _record(monkeypatch, "speech_resynth_tpu", SPEECHLM_TARGETS)
    config, device = object(), torch.device("cpu")
    generate = dict(prompt_wav="p.wav", out_wav="o.wav", decoder_dir="d", max_new_tokens=3, temperature=0.5, top_k=2,
                    top_p=0.9, seed=4) if stage == "generate" else {}
    torch_speechlm.run_stage(stage, config, "2-3", device, **generate)
    jax_speechlm.run_stage(stage, config, "2-3", **generate)
    assert len(ours) == len(theirs) == 1 and ours[0][0] == theirs[0][0]
    (_, args, kwargs), (_, jargs, jkwargs) = ours[0], theirs[0]
    assert args == jargs
    if stage == "tokenize":  # BPE on the host: no device
        assert kwargs == jkwargs
    else:
        assert kwargs.pop("device") is device and kwargs == jkwargs


@pytest.mark.parametrize("cli", [torch_resynth, torch_speechlm], ids=["resynth", "speechlm"])
def test_cli_without_a_card_exits_before_any_stage(cli, monkeypatch, tmp_path):
    """No card and no ``--device cpu``: a non-zero exit naming the way out,
    and no stage runs (the config is not even read)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli, "run_stage", lambda *a, **k: pytest.fail("a stage ran without a card"))
    missing = str(tmp_path / "absent.yaml")
    with pytest.raises(SystemExit) as exc:
        cli.main(["tokenize", "--config", missing])
    assert exc.value.code not in (0, None) and "device='cpu'" in str(exc.value.code)
    with pytest.raises(SystemExit) as exc:
        cli.main(["tokenize", "--config", missing, "--device", "tpu"])
    assert exc.value.code not in (0, None)


@pytest.mark.parametrize("module", ["speech_resynth_torch.cli.resynth", "speech_resynth_torch.cli.speechlm"])
def test_cli_help(module):
    proc = subprocess.run([sys.executable, "-m", module, "--help"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "usage" in proc.stdout.lower() and "--device" in proc.stdout


def test_pyproject_scripts_resolve_to_the_port_mains():
    text = (REPO / "pyproject.toml").read_text()
    scripts = {}
    section = text.split("[project.scripts]", 1)[1].split("\n[", 1)[0]
    for line in section.splitlines():
        if "=" in line and not line.lstrip().startswith("#"):
            key, value = (s.strip().strip('"') for s in line.split("=", 1))
            scripts[key] = value
    assert scripts["speech-resynth"] == "speech_resynth_tpu.cli.resynth:main"
    assert scripts["speech-lm"] == "speech_resynth_tpu.cli.speechlm:main"
    for name, main in (("speech-resynth-torch", torch_resynth.main), ("speech-lm-torch", torch_speechlm.main)):
        module, attr = scripts[name].split(":")
        assert getattr(importlib.import_module(module), attr) is main


# ---------------------------------------------------------------------------
# the port's own chains on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def cli_chain(tmp_path, monkeypatch):
    """tests/test_cli_chain.py's corpus and YAML, its tiny HuBERT registered
    in the port's registry, the discriminators cut to 8 and 16 channels."""
    from test_cli_chain import _write_corpus, _write_yaml

    monkeypatch.setitem(SE.DENSE_MODELS, "_cli_tiny", {
        "config": HubertConfig(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=24,
                               conv_dim=(8, 8, 8), conv_kernel=(10, 8, 4), conv_stride=(10, 8, 4),
                               num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2),
        "output_layer": 1,
    })
    monkeypatch.setattr(TH, "PERIOD_CHANNELS", (8, 8, 8, 8))
    monkeypatch.setattr(TH, "SCALE_SPECS", tuple((16, k, s, p, g) for _, k, s, p, g in TH.SCALE_SPECS))
    _write_corpus(tmp_path)
    return tmp_path, _write_yaml(tmp_path)


def test_resynth_cli_full_chain_on_cpu(cli_chain):
    """``all`` then ``synthesize`` through ``main``, as tests/test_cli_chain.py
    drives the JAX CLI: preprocessing, both trainers' exports (the port's
    ``model.safetensors``), the six-row score CSV and the resynthesized file."""
    root, cfg_path = cli_chain
    torch_resynth.main(["all", "--config", str(cfg_path), "--device", "cpu"])

    assert len(list((root / "16k").glob("**/*.wav"))) == 6
    units = json.loads((root / "units/train.json").read_text())
    assert len(units) == 4
    assert len(list((root / "spec").glob("**/*.npy"))) == 6
    for export in (root / "hifigan", root / "cfm/hf"):
        assert (export / "model.safetensors").is_file() and (export / "config.json").is_file()
    csv = (root / "results/score.csv").read_text().splitlines()
    assert len(csv) == 7  # header + 6 metric rows

    torch_resynth.main(["synthesize", "--config", str(cfg_path), "--device", "cpu"])
    outs = list((root / "resynth").glob("**/*.wav"))
    assert len(outs) == 1
    wav, sr = audio_io.read(outs[0])
    assert sr == 16000 and len(wav) > 1000 and np.isfinite(wav).all()


def _lm_yaml(root: Path) -> Path:
    """A tiny LM's config (tests/test_torch_train_speechlm.py's): 32 lines of
    6-20 units, 4 steps an epoch at batch 8, test sLM21 JSONs, no gold tables."""
    rng = np.random.default_rng(0)
    (root / "train.txt").write_text("\n".join(" ".join(map(str, rng.integers(0, 20, rng.integers(6, 20)))) for _ in range(32)) + "\n")
    for name in ("swuggy_test", "sblimp_test"):
        (root / f"{name}.json").write_text(json.dumps({f"{name}_a": [1, 2, 3], f"{name}_b": [2, 3], f"{name}_c": [4, 5, 6, 7]}))
    cfg = {
        "dataset": {"train_file": str(root / "train.txt"), "units_per_sample": 8,
                    "swuggy_dev_file": str(root / "absent.json"), "sblimp_dev_file": str(root / "absent.json"),
                    "swuggy_test_file": str(root / "swuggy_test.json"), "sblimp_test_file": str(root / "sblimp_test.json"),
                    "swuggy_dir": str(root / "no_lex"), "sblimp_dir": str(root / "no_syn"), "result_dir": str(root / "results")},
        "dataloader": {"batch_size_per_device": 8, "num_workers": 0},
        "model": {"path": str(root / "model"), "vocab_size": 22, "hidden_size": 16, "intermediate_size": 32,
                  "num_hidden_layers": 1, "num_attention_heads": 2, "pad_token_id": 0, "bos_token_id": None, "eos_token_id": 1},
        "optim": {"epoch": 1, "warmup_steps": 2, "lr": 1e-3, "lr_min": 1e-4, "beta1": 0.9, "beta2": 0.98, "max_norm": 1.0,
                  "summary_interval": 1},
    }
    path = root / "lm.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_speechlm_cli_trains_then_evaluates_on_cpu(tmp_path):
    cfg_path = _lm_yaml(tmp_path)
    torch_speechlm.main(["train", "--config", str(cfg_path), "--device", "cpu"])
    assert (tmp_path / "model/hf/model.safetensors").is_file()
    assert sorted(int(p.name) for p in (tmp_path / "model/ckpt").iterdir() if p.name.isdigit()) == [4]
    torch_speechlm.main(["eval", "--config", str(cfg_path), "--device", "cpu"])
    for task, name in (("lexical", "swuggy_test"), ("syntactic", "sblimp_test")):
        lines = (tmp_path / "results" / task / "test.txt").read_text().splitlines()
        assert [line.split()[0] for line in lines] == [f"{name}_a", f"{name}_b", f"{name}_c"]
        assert all(np.isfinite(float(line.split()[1])) for line in lines)


# ---------------------------------------------------------------------------
# the package surface
# ---------------------------------------------------------------------------

GSPMD_ONLY = {"data_sharded", "replicate", "replicated"}


def test_models_exports_equal_jax():
    jax_models = importlib.import_module("speech_resynth_tpu.models")
    torch_models = importlib.import_module("speech_resynth_torch.models")
    assert torch_models.__all__ == jax_models.__all__ and len(torch_models.__all__) == 25
    assert all(getattr(torch_models, name) is not None for name in torch_models.__all__)
    assert torch_models.ConditionalFlowMatchingWithHifiGan.__module__ == "speech_resynth_torch.models.composite"


def test_parallel_exports_equal_jax_less_gspmd_helpers():
    jax_parallel = importlib.import_module("speech_resynth_tpu.parallel")
    torch_parallel = importlib.import_module("speech_resynth_torch.parallel")
    assert torch_parallel.__all__ == [n for n in jax_parallel.__all__ if n not in GSPMD_ONLY]
    assert all(callable(getattr(torch_parallel, n)) or isinstance(getattr(torch_parallel, n), str) for n in torch_parallel.__all__)


def test_package_version_and_layering_doc():
    import speech_resynth_torch

    assert speech_resynth_torch.__version__ == importlib.import_module("speech_resynth_tpu").__version__
    for layer in ("core/", "ops/", "models/", "parallel/", "train/", "pipeline/", "cli/"):
        assert layer in speech_resynth_torch.__doc__
