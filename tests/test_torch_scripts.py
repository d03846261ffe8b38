"""The port's command-line tools (``speech_resynth_torch/scripts``) against
the JAX package's scripts (``scripts/fit_kmeans.py``,
``scripts/convert_checkpoints.py``, ``scripts/gan_longrun.py``) on the CPU.

The JAX scripts are loaded from their files and their ``main`` (or
subcommand) called in this process, as ``tests/test_convert_workflow.py``
runs them, with ``sys.argv`` set; the port's tools take ``--device cpu``.
Sources are tiny and seeded: a HuBERT tower written as an HF checkpoint and
registered in both packages' ``DENSE_MODELS``, centers, a composite
directory, a UTMOS lightning checkpoint, a Whisper directory.
"""

import argparse
import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
import types
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import hubert as jax_hubert
from speech_resynth_tpu.models import kmeans as jax_kmeans
from speech_resynth_tpu.models import speech_encoder as jax_se
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.core.safetensors import load_file, save_file
from speech_resynth_torch.dsp import audio_io
from speech_resynth_torch.models import hubert as torch_hubert
from speech_resynth_torch.models import kmeans as torch_kmeans
from speech_resynth_torch.models import speech_encoder as torch_se
from speech_resynth_torch.models.cfm import CFMConfig, ConditionalFlowMatchingModel
from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan, init_random_weights
from speech_resynth_torch.models.convert import (
    hubert_state_dict_from_hf,
    save_composite_pretrained,
    save_pretrained,
    utmos_state_dict_from_lightning,
)
from speech_resynth_torch.models.hifigan import HifiGanConfig, HifiGanGenerator
from speech_resynth_torch.models.utmos import UTMOSConfig, UTMOSPredictor
from speech_resynth_torch.models.whisper import WhisperConfig, WhisperForASR, whisper_state_dict_from_hf
from speech_resynth_torch.pipeline.scorers import NativeUTMOS, NativeWhisperASR
from speech_resynth_torch.scripts import convert_checkpoints as port_convert
from speech_resynth_torch.scripts import fit_kmeans as port_fit
from speech_resynth_torch.scripts import gan_longrun as port_gan
from test_torch_composite import CFM_KW, VOC_KW
from test_torch_cuda import write_whisper_tokenizer
from chip_smoke import lightning_utmos_state_dict

REPO = Path(__file__).resolve().parent.parent
TOOLS = ("fit_kmeans", "convert_checkpoints", "gan_longrun")
HUBERT = "_scripts_tiny"
HUBERT_KW = dict(hidden_size=24, num_hidden_layers=2, num_attention_heads=4, intermediate_size=48, conv_dim=(12, 12, 12),
                 conv_kernel=(10, 8, 4), conv_stride=(5, 8, 8), num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
UTMOS_SSL_KW = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=1, intermediate_size=128, conv_dim=(32, 32, 32),
                    conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
WHISPER_KW = dict(num_mel_bins=16, d_model=128, encoder_layers=1, encoder_attention_heads=2, decoder_layers=1,
                  decoder_attention_heads=2, encoder_ffn_dim=128, decoder_ffn_dim=128, max_source_positions=50,
                  max_target_positions=40)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch: the suite runs six workers on the
    host's cores, where torch's default pools spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_script(name: str) -> types.ModuleType:
    """A JAX script loaded from its file (``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax(monkeypatch, name: str, *argv) -> None:
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, argv)])
    jax_script(name).main()


def tensors(path: Path) -> dict:
    """A safetensors file's tensors as numpy, read by the ``safetensors`` package."""
    from safetensors.numpy import load_file as np_load_file

    return np_load_file(str(path))


def assert_same_tensors(a: dict, b: dict) -> None:
    """The same names, dtypes, shapes and bytes."""
    assert sorted(a) == sorted(b)
    for k in a:
        assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
        assert a[k].tobytes() == b[k].tobytes(), k


def assert_state_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k].detach().cpu(), v.to(got[k].dtype)), k


# -- sources --------------------------------------------------------------------


def hf_hubert_state_dict() -> dict:
    """A tiny HuBERT tower as an HF ``HubertModel`` state dict: the port's
    keys, the positional conv weight-normed as HF keeps it."""
    tower = torch_hubert.HubertEncoder(torch_hubert.HubertConfig(**HUBERT_KW), FLOAT32)
    init_random_weights(tower, torch.Generator().manual_seed(33))
    sd = dict(tower.state_dict())
    w = sd.pop("encoder.pos_conv_embed.conv.weight")
    sd["encoder.pos_conv_embed.conv.weight_v"] = w
    sd["encoder.pos_conv_embed.conv.weight_g"] = torch.sqrt(torch.sum(w * w, dim=(0, 1), keepdim=True))
    return sd


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Every source in each format the converters take."""
    root = tmp_path_factory.mktemp("sources")
    out = {"root": root}
    hubert = hf_hubert_state_dict()
    out["hubert_sd"] = hubert
    for fmt in ("bin", "safetensors"):
        d = root / f"hubert_{fmt}"
        d.mkdir()
        if fmt == "bin":
            torch.save(hubert, d / "pytorch_model.bin")
        else:
            save_file(hubert, d / "model.safetensors")
        out[f"hubert_{fmt}"] = d
    centers = np.random.default_rng(3).standard_normal((20, HUBERT_KW["hidden_size"]))  # f64: the writer casts
    np.save(root / "centers.npy", centers)
    import joblib

    joblib.dump(types.SimpleNamespace(cluster_centers_=centers), root / "kmeans.joblib")
    out["centers"] = centers

    cfm = ConditionalFlowMatchingModel(CFMConfig(**CFM_KW), FLOAT32)
    voc = HifiGanGenerator(HifiGanConfig(**VOC_KW), FLOAT32)
    init_random_weights(cfm, torch.Generator().manual_seed(5))
    init_random_weights(voc, torch.Generator().manual_seed(6))
    save_composite_pretrained(root / "composite_safetensors", cfm, voc)
    comp = root / "composite_bin"
    comp.mkdir()
    (comp / "config.json").write_bytes((root / "composite_safetensors" / "config.json").read_bytes())
    torch.save(load_file(root / "composite_safetensors" / "model.safetensors"), comp / "pytorch_model.bin")
    out["composite_sd"] = load_file(root / "composite_safetensors" / "model.safetensors")

    utmos = UTMOSPredictor(UTMOSConfig(ssl=torch_hubert.HubertConfig(**UTMOS_SSL_KW), domain_dim=8, num_judges=10, judge_dim=8,
                                       lstm_hidden=16, projection_hidden=32), FLOAT32)
    init_random_weights(utmos, torch.Generator().manual_seed(7))
    lightning = lightning_utmos_state_dict(torch, utmos.state_dict())
    lightning["model.feature_extractors.1.embedding.weight"] = lightning["model.feature_extractors.1.embedding.weight"].double()
    lightning["model.output_layers.1.net.3.bias"] = lightning["model.output_layers.1.net.3.bias"].bfloat16()
    lightning["model.output_layers.0.num_batches_tracked"] = torch.tensor(7)  # an int buffer keeps its dtype
    lightning["model.output_layers.0.flag"] = torch.tensor([True, False])
    torch.save({"state_dict": lightning, "epoch": 3}, root / "utmos_lightning.ckpt")
    torch.save(lightning, root / "utmos_bare.pt")
    out["utmos_sd"] = lightning

    whisper = root / "whisper_safetensors"
    whisper.mkdir()
    ids = write_whisper_tokenizer(whisper, 200)["added"]
    cfg = WhisperConfig(**WHISPER_KW, vocab_size=200 + len(ids), decoder_start_token_id=ids["<|startoftranscript|>"],
                        eos_token_id=ids["<|endoftext|>"])
    model = WhisperForASR(cfg, FLOAT32)
    init_random_weights(model, torch.Generator().manual_seed(1))
    sd = model.state_dict()
    save_file(sd, whisper / "model.safetensors")
    (whisper / "config.json").write_text(json.dumps({"model_type": "whisper", **dataclasses.asdict(cfg)}))
    (whisper / "generation_config.json").write_text(json.dumps({"forced_decoder_ids": [[1, ids["<|en|>"]]]}))
    side_files = [p.name for p in whisper.iterdir() if p.name != "model.safetensors"]
    sharded = root / "whisper_sharded"
    binned = root / "whisper_bin"
    for d in (sharded, binned):
        d.mkdir()
        for name in side_files:
            (d / name).write_bytes((whisper / name).read_bytes())
    keys = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": keys[: len(keys) // 2], "model-00002-of-00002.safetensors": keys[len(keys) // 2 :]}
    for name, part in shards.items():
        save_file({k: sd[k] for k in part}, sharded / name)
    (sharded / "model.safetensors.index.json").write_text(
        json.dumps({"weight_map": {k: name for name, part in shards.items() for k in part}}))
    torch.save(sd, binned / "pytorch_model.bin")
    out["whisper_sd"] = sd
    out.update(whisper_safetensors=whisper, whisper_sharded=sharded, whisper_bin=binned)
    return out


# -- convert_checkpoints --------------------------------------------------------

CONVERSIONS = [
    ("hubert", "hubert_bin"), ("hubert", "hubert_safetensors"),
    ("kmeans", "centers.npy"), ("kmeans", "kmeans.joblib"),
    ("composite", "composite_bin"), ("composite", "composite_safetensors"),
    ("utmos", "utmos_lightning.ckpt"), ("utmos", "utmos_bare.pt"),
    ("whisper", "whisper_safetensors"), ("whisper", "whisper_sharded"), ("whisper", "whisper_bin"),
]


def output_of(kind: str, out: Path) -> Path:
    return {"hubert": out / f"{HUBERT}.safetensors", "kmeans": out / f"{HUBERT}-kmeans-expresso-2000.npz",
            "utmos": out / "utmos.safetensors"}.get(kind, out)


@pytest.mark.parametrize("kind,src", CONVERSIONS)
def test_convert_checkpoints_equals_the_jax_script(sources, tmp_path, monkeypatch, kind, src):
    """Each kind from each source format: the port's output holds the JAX
    script's tensors (names, dtypes, shapes, bytes), copied files are
    byte-equal, and it loads through the port's loader to the source weights."""
    root = sources["root"]
    outs = {}
    for pkg in ("jax", "port"):
        out = tmp_path / pkg / "utmos.safetensors" if kind == "utmos" else tmp_path / pkg
        argv = [kind, "--src", root / src, "--name", HUBERT, "--out", out]
        if pkg == "jax":
            run_jax(monkeypatch, "convert_checkpoints", *argv)
        else:
            port_convert.main([str(a) for a in argv])
        outs[pkg] = output_of(kind, tmp_path / pkg)
    jax_out, port_out = outs["jax"], outs["port"]

    if kind == "kmeans":
        a, b = np.load(jax_out), np.load(port_out)
        assert a.files == b.files == ["centers"] and a["centers"].dtype == b["centers"].dtype == np.float32
        assert a["centers"].tobytes() == b["centers"].tobytes()
        q = torch_kmeans.KMeansQuantizer.load(port_out)
        assert torch.equal(q.centers, torch.from_numpy(sources["centers"].astype(np.float32)))
        return
    if kind in ("composite", "whisper"):
        names = sorted(p.name for p in jax_out.iterdir())
        assert names == sorted(p.name for p in port_out.iterdir())
        for name in names:
            if name.endswith(".safetensors"):
                assert_same_tensors(tensors(jax_out / name), tensors(port_out / name))
            else:
                assert (jax_out / name).read_bytes() == (port_out / name).read_bytes(), name
    else:
        assert_same_tensors(tensors(jax_out), tensors(port_out))

    if kind == "hubert":  # with the converted centers beside it, as by_name reads them
        port_convert.main(["kmeans", "--src", str(root / "centers.npy"), "--name", HUBERT, "--out", str(tmp_path / "port")])
        monkeypatch.setitem(torch_se.DENSE_MODELS, HUBERT, {"config": torch_hubert.HubertConfig(**HUBERT_KW), "output_layer": 2})
        enc = torch_se.SpeechEncoder.by_name(HUBERT, "kmeans-expresso", 2000, checkpoint_dir=str(tmp_path / "port"),
                                             policy=FLOAT32, device="cpu")
        assert_state_equal(enc.encoder.state_dict(), hubert_state_dict_from_hf(sources["hubert_sd"]))
        assert torch.equal(enc.quantizer.centers, torch.from_numpy(sources["centers"].astype(np.float32)))
    elif kind == "composite":
        dec = ConditionalFlowMatchingWithHifiGan.from_pretrained(port_out, FLOAT32, device="cpu")
        want = sources["composite_sd"]
        assert_state_equal(dec.model.state_dict(), {k[6:]: v for k, v in want.items() if k.startswith("model.")})
        assert_state_equal(dec.vocoder.state_dict(), {k[8:]: v for k, v in want.items() if k.startswith("vocoder.")})
    elif kind == "utmos":
        got = tensors(port_out)
        assert got["model.output_layers.0.num_batches_tracked"].dtype == np.int64
        assert got["model.output_layers.0.flag"].dtype == np.bool_
        assert got["model.feature_extractors.1.embedding.weight"].dtype == np.float32
        scorer = NativeUTMOS(port_out, policy=FLOAT32, device="cpu")
        assert_state_equal(scorer.model.state_dict(), utmos_state_dict_from_lightning(
            {k: v.float() if v.is_floating_point() else v for k, v in sources["utmos_sd"].items()}))
    else:
        asr = NativeWhisperASR(port_out, policy=FLOAT32, device="cpu")
        assert_state_equal(asr.model.state_dict(), whisper_state_dict_from_hf(sources["whisper_sd"]))


def test_convert_kmeans_without_joblib_names_it(sources, tmp_path, monkeypatch):
    """A non-``.npy`` source needs joblib, as in the JAX script; without it the
    ImportError names the package."""
    monkeypatch.setitem(sys.modules, "joblib", None)
    with pytest.raises(ImportError, match="joblib"):
        port_convert.main(["kmeans", "--src", str(sources["root"] / "kmeans.joblib"), "--out", str(tmp_path)])


# -- fit_kmeans -----------------------------------------------------------------


def test_fit_kmeans_equals_the_jax_script(sources, tmp_path, monkeypatch, capsys):
    """The same tiny HuBERT (an HF checkpoint under $SPEECH_RESYNTH_MODELS)
    in both packages, both in f32: the frames handed to ``kmeans_fit`` agree
    within 1e-4, with the same per-file counts, the same unreadable file
    skipped and the same ``--max-frames`` cut; each package's
    ``KMeansQuantizer.load`` reads the other's ``.npz`` to the same centers
    and units."""
    models = tmp_path / "models"
    models.mkdir()
    save_file(sources["hubert_sd"], models / f"{HUBERT}.safetensors")
    wavs = tmp_path / "wavs"
    rng = np.random.default_rng(8)
    for i, seconds in enumerate((1.2, 0.6, 2.5, 0.9, 1.5)):
        t = np.arange(int(seconds * 16000)) / 16000
        wave = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) + 0.05 * rng.standard_normal(t.size)
        audio_io.write(wavs / f"s{i % 2}" / f"u{i}.wav", wave.astype(np.float32), 16000)
    (wavs / "s0" / "broken.wav").write_bytes(b"not a wav file")
    monkeypatch.setenv("SPEECH_RESYNTH_MODELS", str(models))
    jcfg = jax_hubert.HubertConfig(**HUBERT_KW)
    monkeypatch.setitem(jax_se.DENSE_MODELS, HUBERT, {"config": jcfg, "output_layer": 2})
    monkeypatch.setitem(torch_se.DENSE_MODELS, HUBERT, {"config": torch_hubert.HubertConfig(**HUBERT_KW), "output_layer": 2})
    for se, policy in ((jax_se, JAX_FLOAT32), (torch_se, FLOAT32)):  # both towers in f32 (bf16 by default)
        by_name = se.SpeechEncoder.by_name.__func__
        monkeypatch.setattr(se.SpeechEncoder, "by_name", classmethod(lambda cls, *a, f=by_name, p=policy, **k: f(cls, *a, policy=p, **k)))
    seen = {}
    for name, module in (("jax", jax_kmeans), ("port", torch_kmeans)):
        fit = module.kmeans_fit

        def capture(*args, fit=fit, name=name, **kwargs):
            if name == "jax":
                seen[name] = np.asarray(args[1])
                # the JAX script hands over a numpy array, which the fit's lax.scan cannot index
                # (models/kmeans.py:39 raises TracerArrayConversionError): give it a jax array
                return fit(args[0], jnp.asarray(args[1]), *args[2:], **kwargs)
            seen[name] = args[0].cpu().numpy()
            return fit(*args, **kwargs)

        monkeypatch.setattr(module, "kmeans_fit", capture)
    # 2 s padding: files of 30-124 frames (the 2.5-s one cut to 2 s), 99 frames a padded row
    argv = ["--wav-dir", wavs, "--glob", "**/*.wav", "--dense-model", HUBERT, "--vocab", 6, "--max-seconds", 2,
            "--batch-size", 2, "--iters", 3, "--max-frames", 200]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # random centers: no quantizer file for this vocabulary
        run_jax(monkeypatch, "fit_kmeans", *argv, "--out", tmp_path / "jax.npz")
        jax_lines = capsys.readouterr().out.splitlines()
        port_fit.main([str(a) for a in argv] + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
        port_lines = capsys.readouterr().out.splitlines()

    assert seen["jax"].shape == seen["port"].shape == (200, HUBERT_KW["hidden_size"])
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=0, atol=1e-4)
    assert jax_lines[0] == port_lines[0] == f"fitting k=6 on 200 frames of dim {HUBERT_KW['hidden_size']}"
    assert port_lines[2] == f"wrote {tmp_path / 'port.npz'}" and len(port_lines) == len(jax_lines) == 3
    for npz in ("jax.npz", "port.npz"):
        jq, tq = jax_kmeans.KMeansQuantizer.load(tmp_path / npz), torch_kmeans.KMeansQuantizer.load(tmp_path / npz)
        assert np.asarray(jq.centers).tobytes() == tq.centers.numpy().tobytes()
        assert np.array_equal(np.asarray(jq(seen["jax"])), tq(torch.from_numpy(seen["jax"])).numpy())


# -- gan_longrun ----------------------------------------------------------------


def gan_args(**kw) -> argparse.Namespace:
    base = dict(workdir="w", steps=50000, epochs=None, batch=16, n_utts=512, ckpt_interval=5000, val_interval=5000,
                summary_interval=100, run_name="run", extend_steps=128)
    return argparse.Namespace(**{**base, **kw})


def test_gan_longrun_config_and_epoch_arithmetic_equal_the_jax_script(tmp_path):
    jax_gan = jax_script("gan_longrun")
    corpus = {"wav_dir": tmp_path / "w", "spec_dir": tmp_path / "s", "train_file": tmp_path / "t.json"}
    for kw in ({}, {"batch": 8, "epochs": 3, "summary_interval": 1, "ckpt_interval": 6, "val_interval": 12}):
        args = gan_args(**kw)
        assert port_gan._gan_config(tmp_path / "run", corpus, args).to_dict() == jax_gan._gan_config(tmp_path / "run", corpus, args).to_dict()
    for n_utts, batch in ((512, 16), (64, 16), (10, 16), (100, 7)):
        assert port_gan._steps_per_epoch(n_utts, batch) == jax_gan._steps_per_epoch(n_utts, batch)


def test_gan_longrun_report_is_byte_equal_to_the_jax_script(tmp_path):
    """One event file written by tensorboardX: the port's ``report`` (through
    ``core.tbevents``) writes the JAX ``cmd_report``'s ``report.md`` byte for byte."""
    from tensorboardX import SummaryWriter

    from test_torch_events import event_accumulator

    event_accumulator()  # the JAX report reads through tensorboard's EventAccumulator
    log = tmp_path / "run" / "logs"
    writer = SummaryWriter(str(log))
    rng = np.random.default_rng(2)
    t = 1.7e9
    for step in range(1, 61):
        t += rng.uniform(0.05, 0.3)
        for tag in ("loss_gen", "loss_disc", "mel_error", "lr"):
            value = float("nan") if (tag, step) == ("loss_disc", 17) else float(rng.uniform(0.1, 5))
            writer.add_scalar(f"training/{tag}", value, step, walltime=t)
        if step % 10 == 0:
            writer.add_scalar("validation/mel_spec_error", float(rng.uniform(0.5, 2)), step, walltime=t)
    writer.close()
    jax_script("gan_longrun").cmd_report(gan_args(workdir=str(tmp_path)))
    want = (tmp_path / "report.md").read_bytes()
    (tmp_path / "report.md").unlink()
    port_gan.cmd_report(gan_args(workdir=str(tmp_path)))
    assert (tmp_path / "report.md").read_bytes() == want
    assert b"training/loss_disc': 1" in want and want.count(b"\n| ") == 20


def test_gan_longrun_hash_equals_the_jax_script(tmp_path):
    gen = HifiGanGenerator(HifiGanConfig(**VOC_KW), FLOAT32)
    init_random_weights(gen, torch.Generator().manual_seed(4))
    save_pretrained(tmp_path, gen.state_dict(), {"model_type": "hifigan"})
    path = tmp_path / "model.safetensors"
    assert port_gan._hash_tree(path) == jax_script("gan_longrun")._hash_tree(path)


# -- the command lines ----------------------------------------------------------


def options(main, argv, capsys) -> set:
    """The option strings a ``--help`` prints."""
    with pytest.raises(SystemExit) as exit_:
        main(argv)
    assert exit_.value.code == 0
    return set(re.findall(r"(?<![\w-])--[a-z][a-z-]*", capsys.readouterr().out))


def test_flags_and_subcommands_are_the_jax_scripts_plus_device(monkeypatch, capsys):
    def jax_main(name):
        def main(argv):
            monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
            jax_script(name).main()
        return main

    assert options(port_fit.main, ["--help"], capsys) == options(jax_main("fit_kmeans"), ["--help"], capsys) | {"--device"}
    assert options(port_convert.main, ["--help"], capsys) == options(jax_main("convert_checkpoints"), ["--help"], capsys)
    for sub in ("run", "report", "resume-check", "resume-check-at", "supervise"):
        got = options(port_gan.main, [sub, "--help"], capsys)
        extra = {"--device", "--max-stalls"} if sub == "supervise" else {"--device"}  # the port's bounded supervisor
        assert got == options(jax_main("gan_longrun"), [sub, "--help"], capsys) | extra, sub
    with pytest.raises(SystemExit):
        port_gan.main(["no-such-command", "w"])


def test_help_of_each_tool_exits_zero_in_one_process():
    code = ("import runpy, sys\n"
            "for name in %r:\n"
            "    sys.argv = [name, '--help']\n"
            "    try:\n"
            "        runpy.run_module('speech_resynth_torch.scripts.' + name, run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (name, e.code)\n"
            "    print('ok', name)\n") % (TOOLS,)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert [l for l in proc.stdout.splitlines() if l.startswith("ok ")] == [f"ok {t}" for t in TOOLS]


# ``gan_longrun supervise``'s trainers: processes that fail at once, that
# checkpoint one step further and then fail, or that finish
FAILING_TRAINER = "raise SystemExit(1)"
ADVANCING_TRAINER = (
    "import pathlib, sys\n"
    "ckpt = pathlib.Path(sys.argv[1]) / 'run' / 'ckpt'\n"
    "ckpt.mkdir(parents=True, exist_ok=True)\n"
    "(ckpt / str(max((int(p.name) for p in ckpt.iterdir()), default=0) + 1)).mkdir()\n"
    "raise SystemExit(1)\n"
)
FINISHING_TRAINER = "pass"


def supervise(tmp_path, monkeypatch, trainer: str, *flags: str) -> tuple:
    """``gan_longrun supervise`` over 5 steps with each generation's trainer
    a ``python -c trainer <workdir>`` process and the pause between
    generations patched out: (the SystemExit code or None, launches, pauses)."""
    real, launches, pauses = subprocess.run, [], []

    def run(cmd, *args, **kwargs):
        launches.append(cmd)
        return real([sys.executable, "-c", trainer, cmd[cmd.index("run") + 1]], *args, **kwargs)

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(port_gan.time, "sleep", pauses.append)
    try:
        port_gan.main(["supervise", str(tmp_path / "w"), "--device", "cpu", "--steps", "5", *flags])
    except SystemExit as exit_:
        return exit_.code, launches, pauses
    return None, launches, pauses


@pytest.mark.parametrize("flags,generations", [((), port_gan.SUPERVISE_MAX_STALLS), (("--max-stalls", "2"), 2)],
                         ids=["default", "max_stalls_2"])
def test_supervise_gives_up_on_a_trainer_that_always_fails(tmp_path, monkeypatch, flags, generations):
    """A trainer that fails without checkpointing a step: after
    ``--max-stalls`` generations (3 by default) in a row the supervisor
    exits non-zero, where the JAX script relaunches forever."""
    code, launches, pauses = supervise(tmp_path, monkeypatch, FAILING_TRAINER, *flags)
    assert code not in (0, None) and "giving up" in str(code)
    assert len(launches) == generations and pauses == [5.0] * (generations - 1)


@pytest.mark.parametrize("trainer,generations", [(ADVANCING_TRAINER, 5), (FINISHING_TRAINER, 1)],
                         ids=["advancing", "finishing"])
def test_supervise_relaunches_a_trainer_that_advances_and_stops_on_a_clean_exit(tmp_path, monkeypatch, trainer, generations):
    """A crash that advanced the checkpointed step resets the count: five
    failing generations, each a step further, reach the 5-step target; a
    clean exit ends the run at once."""
    code, launches, _ = supervise(tmp_path, monkeypatch, trainer)
    assert code is None and len(launches) == generations


def test_tools_that_touch_a_device_refuse_to_start_without_a_card(tmp_path, monkeypatch):
    """Without a card and without ``--device cpu``, ``fit_kmeans`` and
    ``gan_longrun`` exit non-zero before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        port_fit.main(["--wav-dir", str(tmp_path), "--out", str(tmp_path / "c.npz")])
    assert exit_.value.code not in (0, None) and not (tmp_path / "c.npz").exists()
    for sub in ("run", "resume-check", "supervise"):
        with pytest.raises(SystemExit) as exit_:
            port_gan.main([sub, str(tmp_path / "w")])
        assert exit_.value.code not in (0, None) and not (tmp_path / "w").exists(), sub
