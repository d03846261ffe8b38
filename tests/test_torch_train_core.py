"""The port's training core against the JAX package: K1's gradient, the
kernels' gradient gate, the schedules, the optimizer, the random streams and
the checkpoint manager.

K1 itself runs only on the card; here its autograd Function runs with the
kernel swapped for its plain version (as ``chip_smoke.py``'s rehearsal does),
so what is tested is the Function's wiring and its backward, which is the
plain version's gradient on both sides.

Tolerances (f32): attention gradients atol 1e-5 (O(1) values, one softmax
apart in summation order); optimizer parameters within 1e-6 after 5
updates of O(1e-2) (AdamW's update is the same formula in another order);
schedules rtol 1e-6 (JAX evaluates them in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_resynth_tpu.ops import attention as JA
from speech_resynth_tpu.train import common as jax_common
from speech_resynth_tpu.train import hifigan as jax_train_hifigan
from speech_resynth_torch.core.checkpoint import CheckpointManager
from speech_resynth_torch.core.rng import RngStream
from speech_resynth_torch.models import hifigan as TH
from speech_resynth_torch.ops import attention as TA
from speech_resynth_torch.ops import codebook as TC
from speech_resynth_torch.ops import fused_mrf as TM
from speech_resynth_torch.train import common

GRAD_ATOL = 1e-5


def _attention_inputs(case, seed=0):
    B, H, Nq, Nk, D = 2, 2, 12, 20, 8
    causal = case == "causal"
    if causal:
        Nq = Nk
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in ((B, H, Nq, D), (B, H, Nk, D), (B, H, Nk, D), (B, H, Nq, D)))
    mask = np.arange(Nk)[None, :] < np.array([[Nk], [Nk // 2 + 1]])
    if case == "all_masked":
        mask[1] = False  # a row whose keys are all masked: the mean of V
    if causal:
        mask[1, :3] = False  # left padding: the first queries see no valid key
    return q, k, v, mask, causal, g


@pytest.mark.parametrize("case", ["masked", "causal", "all_masked"])
def test_flash_backward_matches_jax_vjp(case):
    """``flash_attention_backward`` against the JAX ``_flash_bwd`` (the VJP of
    its ``custom_vjp``: the reference's gradient)."""
    q, k, v, mask, causal, g = _attention_inputs(case)
    ours = TA.flash_attention_backward(*map(torch.from_numpy, (q, k, v, mask)), causal, torch.from_numpy(g))
    theirs = JA._flash_bwd(causal, tuple(map(jnp.asarray, (q, k, v, mask))), jnp.asarray(g))
    for a, b in zip(ours, theirs[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("case", ["masked", "causal", "all_masked"])
def test_flash_function_gradient_matches_jax_grad(monkeypatch, case):
    """``FlashAttention`` with the kernel swapped for its plain version: its
    output against the JAX Pallas forward (interpret) and its gradients
    against ``jax.grad`` through the JAX custom VJP's backward."""
    q, k, v, mask, causal, g = _attention_inputs(case, seed=1)
    launches = []

    def plain_kernel(q, k, v, mask, causal):
        TA.refuse_grad("flash_attention", q, k, v)  # the Function runs its forward without grad
        launches.append(1)
        return TA.attention_reference(q, k, v, mask, causal)

    monkeypatch.setattr(TA, "flash_attention", plain_kernel)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = TA.FlashAttention.apply(tq, tk, tv, torch.from_numpy(mask), causal)
    assert out.grad_fn is not None and launches == [1]
    out.backward(torch.from_numpy(g))

    jq, jk, jv, jmask = map(jnp.asarray, (q, k, v, mask))
    fwd = JA._flash_forward(jq, jk, jv, jmask, causal, interpret=True)
    # batch row 0 only: the Pallas kernel's rows without a valid key differ from
    # the reference it differentiates (ROADMAP queue 3, accepted differences)
    np.testing.assert_allclose(out.detach().numpy()[0], np.asarray(fwd)[0], rtol=0, atol=GRAD_ATOL)

    def loss(q, k, v):
        return jnp.sum(JA.attention_reference(q, k, v, jmask, causal) * jnp.asarray(g))

    grads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    for t, want in zip((tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=0, atol=GRAD_ATOL)


def test_flash_attention_refuses_a_tensor_that_requires_grad():
    q = torch.zeros(1, 1, 4, 64, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        TA.flash_attention(q, q.detach(), q.detach())


def test_kernel_wrappers_refuse_tensors_that_require_grad():
    """K2, K3 and K4 raise rather than return a result without a gradient;
    under ``no_grad`` the same call gets past the check (and then refuses
    the CPU tensors)."""
    x = torch.zeros(1, 16, 40, requires_grad=True)
    w = torch.zeros(1, 16, 16, 3)
    b = torch.zeros(1, 16)
    for call in (
        lambda: TM.mrf_branch_kernel(x, w, b, w, b, (1,)),
        lambda: TM.mrf_stage_kernel(x, [(w, b, w, b, (1,))]),
        lambda: TC.assign_kernel(x[0].T.contiguous(), torch.zeros(4, 16)),
    ):
        with pytest.raises(ValueError, match="no backward"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="card"):
            call()


def test_mrf_route_takes_the_kernel_only_without_gradient():
    assert TH.mrf_route(fits=True, on_card=True, grad=False) == "kernel"
    assert TH.mrf_route(fits=True, on_card=True, grad=True) == "plain chain"
    assert TH.mrf_route(fits=True, on_card=False, grad=False) == "reference"
    assert TH.mrf_route(fits=False, on_card=True, grad=False) == "plain chain"


def test_generator_under_gradient_runs_the_plain_chain(monkeypatch):
    """A generator whose stages K2 and K3 take: while a gradient is recorded
    neither the branch nor the stage route is called, and every parameter
    gets a gradient; under ``no_grad`` the fused routes serve."""
    cfg = TH.HifiGanConfig(model_in_dim=8, upsample_initial_channel=64, upsample_rates=(5, 4), upsample_kernel_sizes=(10, 8),
                           resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)))
    gen = TH.HifiGanGenerator(cfg)
    for p in gen.parameters():
        torch.nn.init.normal_(p, std=0.1)
    calls = []
    real_branch, real_stage = TH.mrf_branch, TH.mrf_stage
    monkeypatch.setattr(TH, "mrf_branch", lambda *a: calls.append("branch") or real_branch(*a))
    monkeypatch.setattr(TH, "mrf_stage", lambda *a: calls.append("stage") or real_stage(*a))
    mel = torch.randn(1, 6, 8)
    blocks = list(gen.resblocks)
    assert all(blk.fused for blk in blocks)
    for fusion in (False, True):
        with TM.mrf_stage_fusion(fusion):
            gen(mel).square().sum().backward()
            assert calls == [] and all(p.grad is not None and p.grad.abs().sum() > 0 for p in gen.parameters())
            assert all(blk.route(mel.transpose(1, 2)) == "plain chain" for blk in blocks)
            with torch.no_grad():
                gen(mel)
                assert blocks[0].route(mel.transpose(1, 2)) == "reference"
            assert calls == (["stage"] * 2 if fusion else ["branch"] * 4)
            calls.clear()
    with torch.no_grad():
        x = torch.randn(1, 64, 10)
        assert not TH.records_grad(x, blocks[0])
    assert TH.records_grad(x, blocks[0]) and not TH.records_grad(x, blocks[0].requires_grad_(False))


# ---------------------------------------------------------------------------
# schedules and the optimizer
# ---------------------------------------------------------------------------


def test_warmup_linear_decay_matches_jax():
    total, warmup = 50, 10
    ours = common.warmup_linear_decay(total, warmup, 1e-3, 1e-4)
    theirs = jax_common.warmup_linear_decay(total, warmup, 1e-3, 1e-4)
    for step in (0, 1, warmup - 1, warmup, warmup + 1, total - 1, total):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6), step


def test_epoch_exponential_schedule_matches_jax():
    ours = common.epoch_exponential_schedule(2e-4, 0.999, 10)
    theirs = jax_train_hifigan.epoch_exponential_schedule(2e-4, 0.999, 10)
    for step in (0, 9, 10, 11, 25, 181 * 10 - 1):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6), step


@pytest.mark.parametrize("accum_steps", [1, 3])
@pytest.mark.parametrize("max_norm", [0.05, 100.0, None])
def test_optimizer_matches_optax(accum_steps, max_norm):
    """The same gradients into optax's chain (clip, adamw, MultiSteps) and the
    port's ``Optimizer`` for 5 updates: parameters within 1e-6 after every
    micro-step. max_norm 0.05 clips every update, 100 none."""
    rng = np.random.default_rng(accum_steps)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(b1=0.9, b2=0.98, eps=1e-9, max_norm=max_norm, weight_decay=0.01, accum_steps=accum_steps)
    tx = jax_common.make_optimizer(jax_common.warmup_linear_decay(8, 2, 1e-2, 1e-3), **kw)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)
    ours = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in sorted(shapes)]
    opt = common.make_optimizer(ours, common.warmup_linear_decay(8, 2, 1e-2, 1e-3), **kw)
    emitted = []
    for _ in range(5 * accum_steps):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        emitted.append(opt.step([torch.from_numpy(grads[k]) for k in sorted(shapes)]))
        for k, p in zip(sorted(shapes), ours):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=0, atol=1e-6)
    assert emitted == ([False] * (accum_steps - 1) + [True]) * 5 and opt.count == 5


def test_global_norm_matches_optax():
    rng = np.random.default_rng(3)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (7,))]
    ours = float(common.global_norm([torch.from_numpy(a) for a in leaves]))
    assert ours == pytest.approx(float(optax.global_norm([jnp.asarray(a) for a in leaves])), rel=1e-6)


# ---------------------------------------------------------------------------
# random streams and checkpoints
# ---------------------------------------------------------------------------


def test_rng_stream_fold_in_is_reproducible():
    a, b = RngStream(7), RngStream(7)
    a.next()  # walking the sequence does not move fold_in
    draw = lambda g: torch.randn(5, generator=g)  # noqa: E731
    assert torch.equal(draw(a.fold_in(3)), draw(b.fold_in(3)))
    assert not torch.equal(draw(a.fold_in(3)), draw(a.fold_in(4)))
    assert not torch.equal(draw(RngStream(8).fold_in(3)), draw(a.fold_in(3)))
    assert a.seed_for(3) == b.seed_for(3) and 0 <= a.seed_for(3) < 2**63
    assert not torch.equal(draw(b.next()), draw(b.next()))


def _tiny_state(accum_steps=2):
    torch.manual_seed(0)
    module = torch.nn.Linear(3, 2)
    module.register_buffer("u", torch.randn(2))
    opt = common.make_optimizer(module.parameters(), lambda n: 1e-2, max_norm=1.0, accum_steps=accum_steps)
    return common.TrainState(step=0, modules={"m": module}, optimizers={"m": opt})


def _advance(state, seed):
    gen = torch.Generator().manual_seed(seed)
    opt = state.optimizers["m"]
    opt.step([torch.randn(p.shape, generator=gen) for p in opt.params])
    state.step += 1


def test_checkpoint_round_trip_with_accumulation_state(tmp_path):
    """Saved mid-accumulation window and restored into a fresh template, the
    run continues with the same updates; the step, the buffer, the AdamW
    moments, the count and the accumulated gradients come back."""
    state = _tiny_state()
    for s in range(3):  # one update, then one micro-step into the next window
        _advance(state, s)
    assert state.optimizers["m"].mini_step == 1
    with CheckpointManager(tmp_path / "ckpt") as mgr:
        assert not mgr.has_checkpoint()
        assert mgr.save(3, state)
        assert mgr.latest_step() == 3
    restored = CheckpointManager(tmp_path / "ckpt").restore(_tiny_state())
    assert restored.step == 3 and restored.optimizers["m"].mini_step == 1 and restored.optimizers["m"].count == 1
    for a, b in zip(state.optimizers["m"].acc, restored.optimizers["m"].acc):
        assert torch.equal(a, b)
    for s in range(3, 6):
        _advance(state, s)
        _advance(restored, s)
    for (ka, a), (kb, b) in zip(state.modules["m"].state_dict().items(), restored.modules["m"].state_dict().items()):
        assert ka == kb and torch.equal(a, b)


def test_checkpoint_keeps_the_newest_and_ignores_leftovers(tmp_path):
    state = _tiny_state(accum_steps=1)
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=3)
    for step in range(1, 6):
        _advance(state, step)
        assert mgr.save(step, state)
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert not mgr.save(5, state) and not mgr.save(4, state)  # not after the latest unless forced
    assert mgr.save(5, state, force=True) and mgr.all_steps() == [3, 4, 5]
    leftover = tmp_path / "ckpt" / ".tmp-9-1"  # a save killed before its rename
    leftover.mkdir()
    (leftover / "state.pt").write_bytes(b"partial")
    assert mgr.latest_step() == 5
    assert mgr.restore(_tiny_state(accum_steps=1)).step == 5
    assert mgr.restore(_tiny_state(accum_steps=1), step=3).step == 3
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(state)


def test_metrics_writer_is_a_no_op_without_tensorboardx(tmp_path, monkeypatch):
    """The writer writes its event files itself (``core.tbevents``), so it
    writes them where tensorboardX does not import (the card's machine);
    disabled (every rank but 0), it does nothing."""
    import sys

    from speech_resynth_torch.core.metrics import MetricsWriter
    from speech_resynth_torch.core.tbevents import read_scalars

    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import fails
    writer = MetricsWriter(tmp_path / "on")
    writer.scalars({"loss": torch.tensor(1.5), "lr": 1e-3}, 3, prefix="train/")
    writer.audio("a", np.zeros(160, np.float32), 3)
    writer.close()
    scalars = {tag: [(step, value) for step, value, _ in events] for tag, events in read_scalars(tmp_path / "on").items()}
    assert scalars == {"train/loss": [(3, 1.5)], "train/lr": [(3, pytest.approx(1e-3))]}
    off = MetricsWriter(tmp_path / "disabled", enabled=False)
    off.scalar("loss", 1.0, 1)
    off.audio("a", np.zeros(160, np.float32), 1)
    off.close()
    assert not (tmp_path / "disabled").exists()


def test_step_timer_and_trace_span():
    import time

    from speech_resynth_torch.core.metrics import StepTimer, trace_span
    from speech_resynth_torch.core.tracing import recorded

    timer = StepTimer()
    assert timer.synced_step_time(0) is None
    time.sleep(0.01)
    assert 0.005 <= timer.synced_step_time(2) < 1.0  # seconds per step: two steps in one interval of >= 10 ms
    assert timer.synced_step_time(2) is None  # no step since the last call
    assert not any(hasattr(timer, gone) for gone in ("tick", "mean_step_time", "throughput", "rtf"))
    before = recorded()
    with trace_span("cfm_train_step"):  # no profiler session: nothing recorded
        pass
    assert recorded() == before
    with torch.profiler.profile() as prof:
        t0 = time.time_ns()
        with trace_span("cfm_train_step", step=7):
            torch.ones(3).sum()
        t1 = time.time_ns()
    assert "cfm_train_step" in {e.key for e in prof.key_averages()}
    (span,) = [s for s in recorded().spans if s.name == "cfm_train_step"]
    assert t0 <= span.start_ns <= span.end_ns <= t1 and span.attrs == {"step": 7} and span.parent is None
