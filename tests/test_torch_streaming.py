"""The port's streaming vocoder against the batch run and against the JAX package.

The claim under test (pipeline/streaming.py) is exactness: every sample the
stream emits is the sample the whole-utterance generator gives, the
zero-padded edges included, because the windows carry the receptive field
and the first and last windows are pinned to the true utterance edges. The
tests follow tests/test_streaming.py on the port's generator, and hold the
port's stream against the JAX package's ``stream_waveform`` on the same
weights.

Tolerances: f32 on the CPU. The window-shaped and whole-utterance runs sum
in other orders, so samples agree to 1e-6 of their O(1) values; the port
against JAX, 1e-5 (two frameworks, ~20 convs); PCM16 within 1 LSB (a sample
on a rounding boundary may flip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import hifigan as jax_hifigan
from speech_resynth_tpu.pipeline import streaming as jax_streaming
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.dsp.mulaw import mulaw_encode
from speech_resynth_torch.models.convert import hifigan_generator_state_dict
from speech_resynth_torch.models.hifigan import HifiGanConfig, HifiGanGenerator
from speech_resynth_torch.ops import fused_mrf as TM
from speech_resynth_torch.pipeline.streaming import (
    StreamingVocoder,
    context_frames_for,
    receptive_field_samples,
    stream_waveform,
)

TINY_KW = dict(
    model_in_dim=8,
    upsample_initial_channel=32,
    upsample_rates=(4, 2),
    upsample_kernel_sizes=(8, 4),
    resblock_kernel_sizes=(3, 5),
    resblock_dilation_sizes=((1, 2), (1, 2)),
)
TINY = HifiGanConfig(**TINY_KW)
EXACT = dict(rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny generator's variables (every tensor refilled with seeded
    values) and the port's generator on the same weights."""
    cfg = jax_hifigan.HifiGanConfig(**TINY_KW)
    variables = jax_hifigan.HifiGanGenerator(cfg, policy=JAX_FLOAT32).init(jax.random.key(0), jnp.zeros((1, 4, 8)))
    rng = np.random.default_rng(0)

    def fill(a):
        a = np.asarray(a, np.float32)
        std = 0.1 if a.ndim == 1 else 1.0 / np.sqrt(np.prod(a.shape[:-1]))
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * std)

    variables = {"params": jax.tree_util.tree_map(fill, variables["params"])}
    gen = HifiGanGenerator(TINY, FLOAT32)
    gen.load_state_dict(hifigan_generator_state_dict(variables["params"]))
    return cfg, variables, gen.eval()


@torch.no_grad()
def _full(gen, mel):
    return gen(torch.from_numpy(mel[None]))[0].numpy()


def _mel(T, seed):
    return np.random.default_rng(seed).standard_normal((T, TINY.model_in_dim)).astype(np.float32)


@pytest.mark.parametrize("cfg", [HifiGanConfig(), TINY], ids=["production", "tiny"])
def test_context_equals_jax(cfg):
    jcfg = jax_hifigan.HifiGanConfig(**{k: getattr(cfg, k) for k in TINY_KW})
    assert receptive_field_samples(cfg) == jax_streaming.receptive_field_samples(jcfg)
    assert context_frames_for(cfg) == jax_streaming.context_frames_for(jcfg)


def test_context_is_analytic_and_small():
    prod = HifiGanConfig()
    assert receptive_field_samples(prod) < 10 * prod.total_upsample * 4
    assert context_frames_for(prod) == 22  # chunk 50: windows of 72 (first) and 94 frames
    assert context_frames_for(TINY) == -(-receptive_field_samples(TINY) // TINY.total_upsample)


def test_stream_equals_batch_irregular_pushes(pair):
    _, _, gen = pair
    mel = _mel(57, 0)
    sv = StreamingVocoder(gen, chunk_frames=7)
    parts, i = [], 0
    for step in [1, 3, 5, 11, 2, 9, 30]:  # irregular arrival sizes
        parts.append(sv.push(mel[i : i + step]))
        i += step
    parts.append(sv.flush())
    got, want = np.concatenate(parts), _full(gen, mel)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **EXACT)
    assert sum(p.size for p in parts[:-1]) > 0  # audio came out before the flush


def test_stream_shorter_than_one_window(pair):
    _, _, gen = pair
    mel = _mel(9, 1)
    np.testing.assert_allclose(stream_waveform(gen, mel, chunk_frames=4), _full(gen, mel), **EXACT)


def test_stream_pcm16_wire(pair):
    _, _, gen = pair
    mel = _mel(41, 2)
    want16 = np.round(np.clip(_full(gen, mel), -1.0, 1.0) * 32767.0).astype(np.int16)
    got = stream_waveform(gen, mel, chunk_frames=5, wire="pcm16")
    assert got.dtype == np.int16
    np.testing.assert_allclose(got.astype(np.int32), want16.astype(np.int32), rtol=0, atol=1)


def test_stream_mulaw_wire(pair):
    _, _, gen = pair
    mel = _mel(30, 6)
    want = mulaw_encode(torch.from_numpy(_full(gen, mel))).numpy()
    got = stream_waveform(gen, mel, chunk_frames=6, wire="mulaw")
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_first_audio_after_chunk_plus_ctx(pair):
    """The left-pinned first window (chunk + ctx frames) emits the first
    chunk as soon as its right context has arrived."""
    _, _, gen = pair
    mel = _mel(40, 3)
    sv = StreamingVocoder(gen, chunk_frames=12)
    assert sv.first_window == 12 + sv.ctx < sv.window
    parts = []
    for i in range(40):
        out = sv.push(mel[i : i + 1])
        if out.size and not parts:
            assert i == sv.first_window - 1
            assert out.size == 12 * sv.hop
        if out.size:
            parts.append(out)
    parts.append(sv.flush())
    np.testing.assert_allclose(np.concatenate(parts), _full(gen, mel), **EXACT)


def _frame_by_frame(gen, T, chunk, seed):
    mel = _mel(T, seed)
    sv = StreamingVocoder(gen, chunk_frames=chunk)
    parts = [sv.push(mel[i : i + 1]) for i in range(T)]
    parts.append(sv.flush())
    np.testing.assert_allclose(np.concatenate(parts), _full(gen, mel), **EXACT)
    return sv


def test_small_chunk_runs_no_redundant_windows(pair):
    """chunk < ctx: the left-pinned interior window emits every ready frame
    in one call: 1 first window, 1 left-pinned interior window, one
    interior window per chunk while a full window fits, 1 flush."""
    _, _, gen = pair
    T, chunk = 80, 3
    sv = _frame_by_frame(gen, T, chunk, 4)
    assert chunk < sv.ctx  # the regime under test
    interior, emitted = 0, chunk + sv.ctx
    while emitted + chunk + sv.ctx <= T:
        interior += 1
        emitted += chunk
    assert sv.device_calls == 2 + interior + 1


def test_buffer_stays_bounded(pair):
    """Frames one window behind the frontier are dropped: the buffer holds
    at most a window plus the not-yet-ready tail, whatever the length."""
    _, _, gen = pair
    chunk = 3
    sv = _frame_by_frame(gen, 120, chunk, 5)
    assert sv._base > 0 and len(sv._mel) <= sv.window + chunk + sv.ctx


def test_push_after_flush_raises(pair):
    _, _, gen = pair
    sv = StreamingVocoder(gen, chunk_frames=4)
    sv.flush()
    with pytest.raises(RuntimeError):
        sv.push(np.zeros((1, TINY.model_in_dim), np.float32))


@pytest.mark.parametrize("chunk", [7, 50])
def test_stream_equals_jax_stream(pair, chunk):
    """The port's stream against the JAX package's on the same weights."""
    cfg, variables, gen = pair
    mel = _mel(70, 7)
    theirs = jax_streaming.stream_waveform(variables, cfg, mel, chunk_frames=chunk, policy=JAX_FLOAT32, fused=False)
    ours = stream_waveform(gen, mel, chunk_frames=chunk)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)


def test_stream_with_stage_fusion_equals_batch():
    """A generator whose narrow stage K3 takes (C = 16), streamed with stage
    fusion on: equal to its batch run with fusion off."""
    gen = HifiGanGenerator(HifiGanConfig(**{**TINY_KW, "resblock_dilation_sizes": ((1, 3), (1, 3))}), FLOAT32)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(torch.from_numpy(np.random.default_rng(p.numel()).standard_normal(p.shape).astype(np.float32) * 0.1))
    assert gen.stage_eligible == (True, False)
    mel = _mel(45, 8)
    want = _full(gen.eval(), mel)
    with TM.mrf_stage_fusion(True):
        got = stream_waveform(gen, mel, chunk_frames=6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
