"""The port's UTMOS (speech_resynth_torch.models.utmos, pipeline.scorers
NativeUTMOS) against the JAX package's, and the port's safetensors reader
and writer against the ``safetensors`` package.

Tiny widths: a 2-layer wav2vec2 tower of hidden 64 (one head of 64), 3
convs (x20), LSTM 16, head 32, in f32; the JAX side at "highest". Valid
frames only are compared (pad frames are garbage in the JAX model, zero in
the port's), at 1e-4, and the MOS at 1e-4. The published lightning layout
comes from ``tests/test_utmos.py``'s torch oracle.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import utmos as JU
from speech_resynth_tpu.models.convert import _torch_lstm_dir, utmos_params
from speech_resynth_tpu.pipeline import scorers as JS
from speech_resynth_torch.core import safetensors as ST
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.models import utmos as TU
from speech_resynth_torch.models.convert import utmos_state_dict, utmos_state_dict_from_lightning
from speech_resynth_torch.pipeline import scorers as TS
from test_utmos import _TorchOracle, tiny_ssl_cfg

TOL = dict(rtol=0, atol=1e-4)
LENS = [1600, 1200, 800]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch: the suite runs six workers on the
    host's cores, where torch's default pools spin against each other (a
    tiny UTMOS forward took 10-60 s under that load, 0.01 s with one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _waves(seed=1, lens=LENS):
    rng = np.random.default_rng(seed)
    wavs = [rng.standard_normal(n).astype(np.float32) * 0.1 for n in lens]
    padded = np.zeros((len(wavs), max(lens)), np.float32)
    for i, w in enumerate(wavs):
        padded[i, : len(w)] = w
    return wavs, padded


@pytest.fixture(scope="module")
def lightning():
    """The oracle's lightning state_dict, the JAX params converted from it and
    the port's state_dict converted from it."""
    sd = _TorchOracle(tiny_ssl_cfg()).lightning_state_dict()
    return sd, utmos_params({k: v.numpy() for k, v in sd.items()}), utmos_state_dict_from_lightning(sd)


def test_lightning_loader_equals_the_jax_tree(lightning):
    """``utmos_state_dict_from_lightning`` and ``utmos_state_dict`` of the JAX
    converter's tree give the same tensors (the LSTM's two biases summed
    into ``bias_ih``), and the config read from the shapes equals the JAX one."""
    _, params, sd = lightning
    from_jax = utmos_state_dict(params)
    assert sorted(from_jax) == sorted(sd)
    for k, v in sd.items():
        if k.startswith("decoder_rnn.bias"):
            continue
        torch.testing.assert_close(v, from_jax[k], rtol=0, atol=1e-6, msg=k)  # the folded weight norm rounds apart
    for suffix in ("", "_reverse"):
        torch.testing.assert_close(sd[f"decoder_rnn.bias_ih_l0{suffix}"] + sd[f"decoder_rnn.bias_hh_l0{suffix}"],
                                   from_jax[f"decoder_rnn.bias_ih_l0{suffix}"], rtol=0, atol=1e-7)
    cfg, jcfg = TU.config_from_state_dict(sd), JU.config_from_params(params)
    assert cfg.ssl.__dict__ == jcfg.ssl.__dict__
    assert {k: v for k, v in cfg.__dict__.items() if k != "ssl"} == {k: v for k, v in jcfg.__dict__.items() if k != "ssl"}


def test_padded_batch_matches_jax_on_valid_frames(lightning):
    """A right-padded batch of three lengths, domain and judge ids per row:
    valid-frame scores and MOS against the JAX model."""
    _, params, sd = lightning
    cfg = TU.config_from_state_dict(sd)
    model = TU.UTMOSPredictor(cfg, FLOAT32).eval()
    model.load_state_dict(sd)
    _, padded = _waves()
    dom, judge = np.array([0, 1, 2]), np.array([3, 0, 9])
    n_frames = np.array([cfg.ssl.num_frames(n) for n in LENS])
    jmodel = JU.UTMOSPredictor(JU.config_from_params(params), policy=JAX_FLOAT32, attn_implementation="xla")
    with jax.default_matmul_precision("highest"):
        j_frames = np.asarray(jmodel.apply({"params": params}, jnp.asarray(padded), jnp.asarray(dom), jnp.asarray(judge),
                                           num_samples=jnp.asarray(LENS)))
        j_mos = np.asarray(JU.UTMOSPredictor.score_from_frames(jnp.asarray(j_frames), jnp.asarray(n_frames)))
    with torch.no_grad():
        frames = model(torch.from_numpy(padded), torch.from_numpy(dom), torch.from_numpy(judge), torch.tensor(LENS))
        mos = TU.UTMOSPredictor.score_from_frames(frames, torch.from_numpy(n_frames))
    for i, n in enumerate(n_frames):
        np.testing.assert_allclose(frames[i, :n].numpy(), j_frames[i, :n], **TOL)
    np.testing.assert_allclose(mos.numpy(), j_mos, **TOL)


def test_lstm_backward_starts_at_each_rows_last_frame():
    """The packed LSTM against the JAX ``BiLSTM`` with lengths (one row a
    single frame), valid frames only."""
    torch.manual_seed(3)
    rnn = torch.nn.LSTM(6, 5, batch_first=True, bidirectional=True)
    x = np.random.default_rng(0).standard_normal((3, 12, 6)).astype(np.float32)
    lengths = np.array([12, 7, 1])
    sd = rnn.state_dict()
    params = {**_torch_lstm_dir(sd, "", "fwd"), **_torch_lstm_dir(sd, "", "bwd")}
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JU.BiLSTM(5).apply({"params": params}, jnp.asarray(x), lengths=jnp.asarray(lengths)))
    packed = torch.nn.utils.rnn.pack_padded_sequence(torch.from_numpy(x), torch.from_numpy(lengths), batch_first=True,
                                                     enforce_sorted=False)
    with torch.no_grad():
        got, _ = torch.nn.utils.rnn.pad_packed_sequence(rnn(packed)[0], batch_first=True, total_length=12)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n], rtol=0, atol=1e-5)


def test_native_utmos_equals_jax_from_ckpt_and_safetensors(lightning, tmp_path):
    """The port's ``NativeUTMOS`` from a lightning ``.ckpt`` and from the same
    tensors as ``.safetensors`` (written by the port's writer), against the
    JAX ``NativeUTMOS`` (its 1-s buckets), both in f32; ids clamped into the
    tables; ``score_batch`` of several waves equals each wave alone."""
    sd, _, _ = lightning
    ckpt, st = tmp_path / "utmos.ckpt", tmp_path / "utmos.safetensors"
    torch.save({"state_dict": sd}, ckpt)
    ST.save_file(sd, st)
    jax_scorer = JS.NativeUTMOS(str(ckpt), domain_id=0, judge_id=500, policy=JAX_FLOAT32)
    wavs, _ = _waves(2, lens=[2000, 15000, 9000])  # one 1-s bucket: one JAX compile
    with jax.default_matmul_precision("highest"):
        want = [jax_scorer.score(w) for w in wavs]
    for path in (ckpt, st):
        ours = TS.NativeUTMOS(str(path), domain_id=0, judge_id=500, policy=FLOAT32, device="cpu")
        assert (ours.domain_id, ours.judge_id) == (jax_scorer.domain_id, jax_scorer.judge_id) == (0, 9)
        np.testing.assert_allclose([ours.score(w) for w in wavs], want, **TOL)
        np.testing.assert_allclose(ours.score_batch(wavs), want, **TOL)


def test_default_mos_picks_native_and_raises_on_a_bad_checkpoint(lightning, tmp_path):
    """``eval.utmos_ckpt`` names the native scorer; a file that does not load
    raises instead of falling back; no checkpoint gives ``EnergyMOS``."""
    from speech_resynth_torch.core.config import config_from_dict

    sd, _, _ = lightning
    ckpt = tmp_path / "utmos.ckpt"
    torch.save({"state_dict": sd}, ckpt)
    assert isinstance(TS.default_mos(config_from_dict({"eval": {"utmos_ckpt": str(ckpt)}}), device="cpu"), TS.NativeUTMOS)
    bad = tmp_path / "bad.ckpt"
    torch.save({"state_dict": {"unrelated": torch.zeros(1)}}, bad)
    with pytest.raises(KeyError):
        TS.default_mos(config_from_dict({"eval": {"utmos_ckpt": str(bad)}}), device="cpu")
    assert isinstance(TS.default_mos(config_from_dict({"eval": {}})), TS.EnergyMOS)


DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.bool, torch.float64, torch.uint8]


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dtype in enumerate(DTYPES):
        shape = [(3, 5), (7,), (2, 1, 4), ()][i % 4]
        x = torch.randn(shape, generator=g) * 100
        out[f"t{i}.{dtype}"] = x > 0 if dtype == torch.bool else x.to(dtype)
    out["empty"] = torch.zeros(0, 3)
    return out


@pytest.mark.parametrize("writer", ["package", "port"])
def test_safetensors_round_trip_with_the_package(tmp_path, writer):
    """A file the ``safetensors`` package writes reads back bit-equal through
    the port's reader, and the reverse, for every dtype the reader takes."""
    from safetensors.torch import load_file, save_file

    tensors = _tensors()
    path = tmp_path / "t.safetensors"
    (save_file if writer == "package" else ST.save_file)(tensors, str(path), metadata={"format": "pt"})
    back = (ST.load_file if writer == "package" else load_file)(str(path))
    assert sorted(back) == sorted(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k


def test_sharded_index_is_read(tmp_path):
    tensors = _tensors(1)
    names = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": names[: len(names) // 2], "model-00002-of-00002.safetensors": names[len(names) // 2 :]}
    for shard, keys in shards.items():
        ST.save_file({k: tensors[k] for k in keys}, tmp_path / shard)
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"weight_map": {k: shard for shard, keys in shards.items() for k in keys}}))
    back = ST.load_hf_state_dict(tmp_path)
    assert sorted(back) == names and all(torch.equal(back[k], tensors[k]) for k in names)
    with pytest.raises(FileNotFoundError):
        ST.load_hf_state_dict(tmp_path / "nothing")
