"""The port's whole slice against the JAX package: unit ids -> waveform.

A tiny JAX composite (the ``bench.py --tiny`` configs, FLOAT32) is built,
its variables are carried across with the port's ``models/convert.py`` (and,
separately, through the HF-format directory that the JAX package's
``save_composite_pretrained`` writes), and both sides synthesize the same ids
from the same ODE noise ``x0``.

Tolerances: f32 on both sides with another summation order; the waveforms
are O(1) after the ODE and the vocoder, atol 2e-5. Wire formats may differ
by one code where a sample sits on a rounding boundary.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.dsp.mulaw import mulaw_encode as jax_mulaw_encode
from speech_resynth_tpu.models import cfm as jax_cfm
from speech_resynth_tpu.models import composite as jax_composite
from speech_resynth_tpu.models import hifigan as jax_hifigan
from speech_resynth_tpu.models.export import save_composite_pretrained
from speech_resynth_torch.core.device import resolve_device
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.models import cfm as torch_cfm
from speech_resynth_torch.models import hifigan as torch_hifigan
from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
from speech_resynth_torch.models.convert import cfm_state_dict, hifigan_generator_state_dict
from speech_resynth_torch.pipeline.serving import SynthesisRequest, SynthesisServer

REPO = Path(__file__).resolve().parent.parent
WAV_TOL = dict(rtol=1e-5, atol=2e-5)
DT, TRUNC = 0.25, 1.0

# bench.py --tiny
CFM_KW = dict(
    vocab_size=2000,
    dim_in=8,
    dim_cond_emb=12,
    hidden_size=16,
    depth=2,
    heads=2,
    intermediate_size=24,
    conv_pos_embed_kernel_size=7,
    conv_pos_embed_groups=16,
)
VOC_KW = dict(
    model_in_dim=8,
    upsample_initial_channel=16,
    upsample_rates=(5, 4),
    upsample_kernel_sizes=(10, 8),
    resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),),
)


def _reinit(tree, seed):
    """Fan-in-scaled random kernels and small random biases/gains, so every
    weight matters and the waveform is O(1) (the JAX init's std 0.01 vocoder
    would give ~1e-5 samples and all-zero PCM16)."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a, np.float32)
        std = 0.1 if a.ndim == 1 else 1.0 / np.sqrt(np.prod(a.shape[:-1]))
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * std)

    return jax.tree_util.tree_map(fill, tree)


@pytest.fixture(scope="module")
def jax_decoder():
    dec = jax_composite.ConditionalFlowMatchingWithHifiGan.from_config(
        jax_cfm.CFMConfig(**CFM_KW), jax_hifigan.HifiGanConfig(**VOC_KW), policy=JAX_FLOAT32
    )
    mvars = dict(dec.model_variables)
    mvars["params"] = _reinit(mvars["params"], 0)
    return jax_composite.ConditionalFlowMatchingWithHifiGan(dec.model, mvars, dec.vocoder, _reinit(dec.vocoder_variables, 1))


def _carry_across(jdec) -> ConditionalFlowMatchingWithHifiGan:
    model = torch_cfm.ConditionalFlowMatchingModel(torch_cfm.CFMConfig(**CFM_KW), FLOAT32)
    model.load_state_dict(cfm_state_dict(jdec.model_variables))
    vocoder = torch_hifigan.HifiGanGenerator(torch_hifigan.HifiGanConfig(**VOC_KW), FLOAT32)
    vocoder.load_state_dict(hifigan_generator_state_dict(jdec.vocoder_variables["params"]))
    return ConditionalFlowMatchingWithHifiGan(model, vocoder, device="cpu")


@pytest.fixture(scope="module")
def port_decoder(jax_decoder):
    return _carry_across(jax_decoder)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, CFM_KW["vocab_size"] + 1, (3, 14))
    ids[1, 9:] = 0
    ids[2, 4:] = 0
    x0 = rng.standard_normal((3, 14, CFM_KW["dim_in"])).astype(np.float32)
    return ids, x0


@pytest.fixture(scope="module")
def jax_waveforms(jax_decoder, inputs):
    ids, x0 = inputs
    mel, mask = jax_decoder.model.apply(
        jax_decoder.model_variables, jnp.asarray(ids), dt=DT, truncation_value=TRUNC, x0=jnp.asarray(x0), method="sample"
    )
    wav = jax_decoder.vocoder.apply(jax_decoder.vocoder_variables, mel)
    lengths = jax_decoder.vocoder.config.waveform_lengths(jnp.sum(mask, axis=1))
    return np.asarray(wav), np.asarray(lengths)


def _synth(dec, inputs, **kw):
    ids, x0 = inputs
    wav, lengths = dec.synthesize(ids, DT, TRUNC, x0=torch.from_numpy(x0), **kw)
    return wav.numpy(), lengths.numpy()


def test_synthesize_matches_jax(port_decoder, inputs, jax_waveforms):
    wav, lengths = _synth(port_decoder, inputs)
    want_wav, want_lengths = jax_waveforms
    assert wav.dtype == np.float32 and wav.shape == want_wav.shape
    np.testing.assert_array_equal(lengths, want_lengths)
    np.testing.assert_allclose(wav, want_wav, **WAV_TOL)
    assert 0.05 < np.abs(want_wav).max() <= 1.0  # O(1) samples: the wire-format tests below mean something


def test_pcm16_matches_jax(port_decoder, inputs, jax_waveforms):
    wav, _ = _synth(port_decoder, inputs, pcm16=True)
    want = np.asarray(jnp.round(jnp.clip(jnp.asarray(jax_waveforms[0]), -1.0, 1.0) * 32767.0).astype(jnp.int16))
    assert wav.dtype == np.int16
    assert np.abs(wav.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_mulaw_matches_jax(port_decoder, inputs, jax_waveforms):
    wav, _ = _synth(port_decoder, inputs, mulaw=True)
    want = np.asarray(jax_mulaw_encode(jnp.asarray(jax_waveforms[0])))
    assert wav.dtype == np.uint8
    assert np.abs(wav.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_pcm16_and_mulaw_together_raise(port_decoder, inputs):
    with pytest.raises(ValueError, match="exclusive"):
        _synth(port_decoder, inputs, pcm16=True, mulaw=True)


def test_call_returns_trimmed_list(port_decoder, inputs, jax_waveforms):
    ids, x0 = inputs
    out = port_decoder(ids, DT, TRUNC, x0=torch.from_numpy(x0))
    want_wav, want_lengths = jax_waveforms
    assert [w.shape for w in out] == [(1, int(n)) for n in want_lengths]
    for w, ref, n in zip(out, want_wav, want_lengths):
        np.testing.assert_allclose(w[0], ref[:n], **WAV_TOL)


@pytest.mark.parametrize("ode_method", ["euler", "midpoint"])
def test_synthesize_ode_methods_match_jax(jax_decoder, port_decoder, inputs, ode_method):
    ids, x0 = inputs
    mel, mask = jax_decoder.model.apply(
        jax_decoder.model_variables, jnp.asarray(ids), dt=0.5, truncation_value=TRUNC, x0=jnp.asarray(x0),
        ode_method=ode_method, method="sample",
    )
    want = np.asarray(jax_decoder.vocoder.apply(jax_decoder.vocoder_variables, mel))
    wav, _ = port_decoder.synthesize(ids, 0.5, TRUNC, x0=torch.from_numpy(x0), ode_method=ode_method)
    np.testing.assert_allclose(wav.numpy(), want, **WAV_TOL)


@pytest.mark.parametrize("weights", ["safetensors", "pytorch_model.bin"])
def test_from_pretrained_reads_the_jax_export(jax_decoder, port_decoder, inputs, jax_waveforms, tmp_path, weights):
    save_composite_pretrained(
        tmp_path,
        jax_decoder.model_variables,
        jax_decoder.model.config,
        jax_decoder.vocoder_variables,
        jax_decoder.vocoder.config,
    )
    if weights == "pytorch_model.bin":
        from safetensors.torch import load_file

        torch.save(load_file(str(tmp_path / "model.safetensors")), tmp_path / "pytorch_model.bin")
        (tmp_path / "model.safetensors").unlink()
    loaded = ConditionalFlowMatchingWithHifiGan.from_pretrained(tmp_path, policy=FLOAT32, device="cpu")
    assert loaded.model.config == port_decoder.model.config
    assert loaded.vocoder.config == port_decoder.vocoder.config
    wav, lengths = _synth(loaded, inputs)
    np.testing.assert_array_equal(wav, _synth(port_decoder, inputs)[0])
    np.testing.assert_allclose(wav, jax_waveforms[0], **WAV_TOL)


def test_from_pretrained_refuses_a_hub_id():
    with pytest.raises(FileNotFoundError):
        ConditionalFlowMatchingWithHifiGan.from_pretrained("org/not-a-local-dir", device="cpu")


def test_from_config_is_seeded(inputs):
    cfm, voc = torch_cfm.CFMConfig(**CFM_KW), torch_hifigan.HifiGanConfig(**VOC_KW)
    a, b = (
        ConditionalFlowMatchingWithHifiGan.from_config(cfm, voc, FLOAT32, generator=torch.Generator().manual_seed(3), device="cpu")
        for _ in range(2)
    )
    wa, wb = _synth(a, inputs)[0], _synth(b, inputs)[0]
    np.testing.assert_array_equal(wa, wb)
    assert np.isfinite(wa).all()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def server(port_decoder):
    return SynthesisServer(port_decoder, batch_size=2, dt=0.5, length_multiple=8, pcm16=True)


def test_server_answers_in_order_with_waveform_lengths(server):
    rng = np.random.default_rng(0)
    seqs = [rng.integers(1, 2001, n) for n in (5, 9, 3, 7, 6)]  # 5 requests, batch 2: a partial last batch
    wavs = server.synthesize_many(seqs)
    cfg = server.decoder.vocoder.config
    assert [w.shape for w in wavs] == [(cfg.waveform_lengths(len(s)),) for s in seqs]
    assert all(w.dtype == np.int16 for w in wavs)


def test_server_matches_direct_synthesis(port_decoder):
    """A request's waveform is the decoder's own output for its padded batch row."""
    srv = SynthesisServer(port_decoder, batch_size=2, dt=0.5, length_multiple=8, pcm16=False, seed=4)
    seqs = [np.arange(1, 6), np.arange(10, 17)]
    got = srv.synthesize_many(seqs)
    ids = np.zeros((2, 8), np.int64)
    ids[0, :5], ids[1, :7] = seqs
    wav, lengths = port_decoder.synthesize(ids, 0.5, 1.0, generator=torch.Generator().manual_seed(4))
    for j in range(2):
        np.testing.assert_array_equal(got[j], wav[j, : lengths[j]].numpy())


def test_server_stream_returns_every_id_and_mulaw(port_decoder):
    srv = SynthesisServer(port_decoder, batch_size=2, dt=0.5, length_multiple=8, mulaw=True, max_inflight=1)
    rng = np.random.default_rng(1)
    reqs = [SynthesisRequest(rng.integers(1, 2001, 4), request_id=100 + i) for i in range(5)]
    got = list(srv.synthesize_stream(reqs))
    assert [rid for rid, _ in got] == [100, 101, 102, 103, 104]
    assert all(w.dtype == np.uint8 for _, w in got)


# ---------------------------------------------------------------------------
# isolation from the JAX package, and the card as the default device
# ---------------------------------------------------------------------------

PORT = REPO / "speech_resynth_torch"
# the JAX package and its stack, and libraries the card's machine does not have
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "speech_resynth_tpu", "pandas", "librosa", "torchaudio")


def test_port_imports_nothing_of_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__") for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(" + repr(modules) + "))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.strip()) == len(modules) >= 15


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py", "tests/test_torch_cuda.py"]
)
def test_no_jax_import_in_source(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] in FORBIDDEN for n in names), (path, names)


# checkpoint and tokenizer libraries the port does without: it reads safetensors and the
# Whisper tokenizer's files itself; only the host-CPU fallback scorer TorchWhisperASR imports transformers, lazily
HUB_LIBRARIES = ("transformers", "tokenizers", "huggingface_hub", "safetensors")


def test_port_loads_no_hub_library_on_import():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__") for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {HUB_LIBRARIES!r})\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")))
def test_no_hub_library_import_in_source(path):
    """No source of the port imports a hub library, at module level or
    lazily, except ``TorchWhisperASR``'s import of ``transformers``."""
    tree = ast.parse((REPO / path).read_text())
    allowed = set()
    if path == "speech_resynth_torch/pipeline/scorers.py":
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name == "TorchWhisperASR":
                allowed |= {id(n) for n in ast.walk(node) if isinstance(n, ast.ImportFrom) and n.module == "transformers"}
        assert allowed, "TorchWhisperASR's lazy transformers import moved"
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:  # not the port's own subpackages
            names = [node.module or ""]
        else:
            continue
        if id(node) not in allowed:
            assert not any(n.split(".")[0] in HUB_LIBRARIES for n in names), (path, names)


def test_entry_points_default_to_the_card_and_refuse_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfm, voc = torch_cfm.CFMConfig(**CFM_KW), torch_hifigan.HifiGanConfig(**VOC_KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        ConditionalFlowMatchingWithHifiGan.from_config(cfm, voc)
    with pytest.raises(RuntimeError, match="CUDA"):
        ConditionalFlowMatchingWithHifiGan.from_pretrained(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device().type == "cuda"
