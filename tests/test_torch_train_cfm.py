"""The port's CFM training path against the JAX package: the loss and its
gradients, one trainer step, remat and dropout.

Weights come from the JAX package's init (FLOAT32 policy; zero-initialised
leaves filled with small random values so every parameter matters) through
``models/convert.py``. The noise x0 and the flow times are the JAX model's
own draws from ``jax.random.split(rng)``, passed to the port's ``loss``.

Tolerances (f32): loss rtol 1e-5; gradients atol 1e-5 * max|g| of each
tensor (one backward through the same formulas in another summation order).
After one AdamW step the parameters are compared only where |g| > 1e-6 *
max|g|: Adam's first update is about lr * sign(g), so an element whose
gradient is ~0 may take the opposite sign in the two frameworks and differ
by 2 lr there; elsewhere they agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_resynth_tpu.core.flaxinit import jitted_init
from speech_resynth_tpu.core.mesh import make_mesh
from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.models import cfm as jax_cfm
from speech_resynth_tpu.train import cfm as jax_train_cfm
from speech_resynth_torch.core.precision import FLOAT32
from speech_resynth_torch.models import cfm as torch_cfm
from speech_resynth_torch.models import transformer as torch_tr
from speech_resynth_torch.models.convert import cfm_state_dict
from speech_resynth_torch.train import cfm as torch_train_cfm

CFM_KW = dict(
    vocab_size=11,
    dim_in=8,
    dim_cond_emb=12,
    hidden_size=16,
    depth=2,
    heads=2,
    intermediate_size=24,
    conv_pos_embed_kernel_size=7,
    conv_pos_embed_groups=16,
)
B, L, N = 2, 10, 12


def _fill_zeros(tree, seed):
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.1) if not a.any() else jnp.asarray(a)

    return jax.tree_util.tree_map(fill, tree)


def _batch(predict_duration, seed=0):
    """Units, mels with padded frames at -100 and, for the duration model,
    durations whose totals cover each row's real frames."""
    rng = np.random.default_rng(seed)
    if predict_duration:
        ids = rng.integers(1, CFM_KW["vocab_size"] + 1, (B, L)).astype(np.int32)
        ids[1, 7:] = 0
        durs = np.where(ids != 0, rng.integers(1, 3, (B, L)), 0).astype(np.int32)
        frames = np.minimum(durs.sum(1), N)
    else:
        ids = rng.integers(1, CFM_KW["vocab_size"] + 1, (B, N)).astype(np.int32)
        ids[1, 9:] = 0
        durs = np.ones_like(ids)
        frames = (ids != 0).sum(1)
    mels = rng.standard_normal((B, N, CFM_KW["dim_in"])).astype(np.float32) * 2 - 5
    mels[np.arange(N)[None, :] >= frames[:, None]] = -100.0
    return {"input_ids": ids, "spectrogram_labels": mels, "duration_labels": durs}


def _jax_draws(rng, batch):
    """The noise and times the JAX model draws from ``rng`` (its ``__call__``)."""
    k_x0, k_t = jax.random.split(rng)
    x0 = jax.random.normal(k_x0, batch["spectrogram_labels"].shape, jnp.float32)
    times = jax.random.uniform(k_t, (B,), jnp.float32)
    return torch.from_numpy(np.array(x0)), torch.from_numpy(np.array(times))


def _pair(predict_duration, **overrides):
    cfg = jax_cfm.CFMConfig(**CFM_KW, predict_duration=predict_duration, **overrides)
    jmodel = jax_cfm.ConditionalFlowMatchingModel(cfg, policy=JAX_FLOAT32)
    ids, mels = jnp.ones((1, 8), jnp.int32), jnp.zeros((1, 8, cfg.dim_in))
    variables = _fill_zeros(jitted_init(jmodel, {"params": jax.random.key(0)}, ids, mels, jnp.ones((1, 8), jnp.int32),
                                        rng=jax.random.key(1)), 5)
    port = torch_cfm.ConditionalFlowMatchingModel(
        torch_cfm.CFMConfig(**CFM_KW, predict_duration=predict_duration, **overrides), FLOAT32
    )
    port.load_state_dict(cfm_state_dict(variables))
    return jmodel, variables, port


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grad_sd(grads, variables):
    """JAX gradients keyed as the port's parameters."""
    return cfm_state_dict({"params": grads, "buffers": variables["buffers"]})


@pytest.mark.parametrize("predict_duration", [False, True])
def test_loss_and_gradients_match_jax(predict_duration):
    jmodel, variables, port = _pair(predict_duration)
    batch = _batch(predict_duration)
    rng = jax.random.key(7)

    def loss_fn(params):
        loss, aux = jmodel.apply({**variables, "params": params}, *(jnp.asarray(batch[k]) for k in batch), rng=rng)
        return loss, aux

    (jloss, jaux), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    x0, times = _jax_draws(rng, batch)
    t = _tensors(batch)
    loss, aux = port.loss(t["input_ids"], t["spectrogram_labels"], t["duration_labels"], x0=x0, times=times)
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    assert aux["mse"].item() == pytest.approx(float(jaux["mse"]), rel=1e-5)
    assert aux["duration_loss"].item() == pytest.approx(float(jaux["duration_loss"]), rel=1e-5, abs=1e-7)
    assert (float(aux["duration_loss"]) > 0) == predict_duration
    want = _grad_sd(jgrads, variables)
    params = dict(port.named_parameters())
    assert set(params) == set(want) - {"time_cond_mlp.0.weights"}
    for name, p in params.items():
        g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=1e-5 * max(np.abs(g).max(), 1e-12), err_msg=name)


def test_train_step_matches_jax():
    """One step of ``make_train_step`` against the JAX trainer's, from the
    same weights, table, batch and draws: loss, gradient norm, and the
    updated parameters where the gradient is not ~0 (see the module doc);
    the frozen unit embedding does not move."""
    model_config = jax_cfm.CFMConfig(**CFM_KW)
    tcfg = jax_train_cfm.CFMTrainerConfig(warmup_steps=2, lr=1e-3, lr_min=1e-4)
    table = np.random.default_rng(3).standard_normal((CFM_KW["vocab_size"] + 1, CFM_KW["dim_cond_emb"])).astype(np.float32)
    table[0] = 0
    _, jstate, jstep, _ = jax_train_cfm.make_trainer(model_config, tcfg, make_mesh(data=1), 10, table, policy=JAX_FLOAT32)
    jstate = jstate.replace(params=_fill_zeros(jstate.params, 9))
    # the step donates its state: keep host copies
    variables = jax.tree_util.tree_map(np.array, {"params": jstate.params, "buffers": jstate.extra})

    port_cfg = torch_cfm.CFMConfig(**CFM_KW)
    ptcfg = torch_train_cfm.CFMTrainerConfig(warmup_steps=2, lr=1e-3, lr_min=1e-4)
    model, state, step = torch_train_cfm.make_trainer(port_cfg, ptcfg, 10, table, policy=FLOAT32, device="cpu")
    model.load_state_dict(cfm_state_dict(variables))
    assert not model.to_cond_emb.weight.requires_grad

    batch = _batch(False, seed=4)
    rng = jax.random.key(11)
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    x0, times = _jax_draws(jax.random.split(rng)[0], batch)

    # the port's gradients, for the comparison mask
    t = _tensors(batch)
    loss, _ = model.loss(t["input_ids"], t["spectrogram_labels"], x0=x0, times=times)
    grads = dict(zip([n for n, p in model.named_parameters() if p.requires_grad],
                     torch.autograd.grad(loss, [p for p in model.parameters() if p.requires_grad])))
    state, metrics = step(state, t, seed=0, x0=x0, times=times)
    assert state.step == 1
    for key in ("loss", "mse", "grad_norm"):
        assert float(metrics[key]) == pytest.approx(float(jmetrics[key]), rel=1e-5), key
    after = cfm_state_dict({"params": jax.tree_util.tree_map(np.asarray, jstate.params), "buffers": variables["buffers"]})
    before = cfm_state_dict(variables)
    assert torch.equal(model.to_cond_emb.weight, after["to_cond_emb.weight"])
    assert torch.equal(model.to_cond_emb.weight, before["to_cond_emb.weight"])
    for name, p in model.named_parameters():
        if name == "to_cond_emb.weight":
            continue
        g = grads[name].abs()
        live = g > 1e-6 * g.max()
        assert live.float().mean() > 0.9, name
        moved = (p.detach() - before[name])[live]
        assert moved.abs().max() > 0, name
        np.testing.assert_allclose(p.detach()[live].numpy(), after[name][live].numpy(), rtol=0, atol=1e-6, err_msg=name)


def test_remat_gives_the_same_loss_and_gradients():
    _, variables, port = _pair(False)
    remat = torch_cfm.ConditionalFlowMatchingModel(torch_cfm.CFMConfig(**CFM_KW, remat=True), FLOAT32)
    remat.load_state_dict(port.state_dict())
    t = _tensors(_batch(False, seed=2))
    x0, times = _jax_draws(jax.random.key(5), _batch(False, seed=2))
    results = []
    for model in (port, remat):
        loss, _ = model.loss(t["input_ids"], t["spectrogram_labels"], x0=x0, times=times, dropout_seed=3)
        results.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    torch.testing.assert_close(results[0][0], results[1][0], rtol=1e-6, atol=0)
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_remat_recomputes_attention_in_the_backward(monkeypatch):
    """Under remat every layer's attention runs again in the backward pass:
    twice the attention calls of a plain step (K1 launches twice on the card)."""
    calls = []
    real = torch_tr.dot_product_attention
    monkeypatch.setattr(torch_tr, "dot_product_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    t = _tensors(_batch(False))
    x0, times = torch.zeros(B, N, CFM_KW["dim_in"]), torch.full((B,), 0.5)
    for remat, want in ((False, 2), (True, 4)):
        model = torch_cfm.ConditionalFlowMatchingModel(torch_cfm.CFMConfig(**CFM_KW, remat=remat), FLOAT32)
        loss, _ = model.loss(t["input_ids"], t["spectrogram_labels"], x0=x0, times=times)
        loss.backward()
        assert len(calls) == want, remat
        calls.clear()


def test_dropout_never_reaches_the_kernel_route(monkeypatch):
    """With attention dropout on, a training forward takes the explicit path
    (dropout on the probabilities) and never calls ``dot_product_attention``
    (the K1 route); masks come from the seed, so a seed repeats its loss and
    another seed changes it. Without a seed (inference) the route serves."""
    cfg = torch_cfm.CFMConfig(**CFM_KW, attn_dropout=0.3, ff_dropout=0.2)
    model = torch_cfm.ConditionalFlowMatchingModel(cfg, FLOAT32)
    routed = []
    real = torch_tr.dot_product_attention
    monkeypatch.setattr(torch_tr, "dot_product_attention", lambda *a, **k: routed.append(1) or real(*a, **k))
    t = _tensors(_batch(False))
    x0, times = torch.randn(B, N, CFM_KW["dim_in"]), torch.rand(B)
    losses = [float(model.loss(t["input_ids"], t["spectrogram_labels"], x0=x0, times=times, dropout_seed=s)[0])
              for s in (1, 1, 2)]
    assert routed == []
    assert losses[0] == losses[1] != losses[2]
    model.loss(t["input_ids"], t["spectrogram_labels"], x0=x0, times=times)
    assert len(routed) == cfg.depth


def test_explicit_attention_path_masks_with_minus_1e30():
    """The dropout path at rate ~0 equals the plain attention where a row has a
    valid key, and gives the mean of V (uniform weights) to a row with none."""
    attn = torch_tr.Attention(16, 2, FLOAT32, dropout=1e-12)
    torch.nn.init.normal_(attn.to_qkv.weight, std=0.3)
    x = torch.randn(2, 6, 16)
    mask = torch.tensor([[True] * 4 + [False] * 2, [False] * 6])
    ours = attn(x, mask, dropout_seed=0)
    plain = attn(x, mask)
    torch.testing.assert_close(ours, plain, rtol=1e-5, atol=1e-6)
