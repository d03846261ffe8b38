"""K5, the channels-last conv feed-forward (``ops.conv_ff``), on the CPU: its
plain version against the velocity transformer's plain chain, the weights'
layout and its cache, the route ``ConvFeedForward`` takes, and the frame-row
counters it records. tests/test_torch_cuda.py holds the kernel itself
against the plain version on a card.

Tolerances: in f32 the plain version and the chain compute the same sums in
another order (1e-5 of O(1) outputs); in bf16 the chain rounds conv1's
output, its bias sum, the SiGLU and the product to bf16, where the plain
version keeps them in f32 and rounds h once, so the two differ by a few bf16
ulps of h carried through conv2 (2e-2 of outputs of O(1))."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch import nn

from speech_resynth_torch.core.precision import BF16_INFERENCE, DEFAULT, FLOAT32
from speech_resynth_torch.core.tracing import recorded
from speech_resynth_torch.models import transformer as TR
from speech_resynth_torch.ops import conv_ff as K5

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
C, I = 256, 128  # the smallest widths K5 takes


def feed_forward(policy, c=C, i=I, dropout=0.0, seed=0) -> TR.ConvFeedForward:
    """A feed-forward with weights and biases drawn from ``seed``."""
    torch.manual_seed(seed)
    ff = TR.ConvFeedForward(c, i, policy=policy, dropout=dropout)
    with torch.no_grad():
        for p in ff.parameters():
            p.copy_(torch.randn(p.shape) * (0.5 if p.dim() == 1 else 1.0 / (3 * p.shape[1]) ** 0.5))
    return ff


def inputs(B, N, mask_kind, c=C, seed=1):
    """x (B, N, C) and a frame mask: none, padded tails, or holes (and a tail)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, N, c)).astype(np.float32))
    if mask_kind == "none":
        return x, None
    lengths = rng.integers(1, N + 1, B)
    lengths[0] = N
    mask = np.arange(N)[None, :] < lengths[:, None]
    if mask_kind == "holes":
        mask &= rng.random((B, N)) > 0.3
        mask[:, 0] = True
    return x, torch.from_numpy(mask)


def plain_chain(ff, x, mask):
    """The chain the velocity transformer runs where no kernel route is taken."""
    cd = ff.policy.compute_dtype
    if mask is not None:
        x = x.masked_fill(~mask[..., None], 0)
    value, gate = TR._conv_same(x, ff.conv1, cd).chunk(2, dim=-1)
    h = torch.nn.functional.silu(gate) * value
    if mask is not None:
        h = h.masked_fill(~mask[..., None], 0)
    return TR._conv_same(h, ff.conv2, cd)


def profiled():
    """A CPU profiler session whose recording starts afresh: a read-out while
    no session records lets the next session start anew."""
    recorded()
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def laid_out(ff, dtype):
    return K5.ff_operands(ff.conv1.weight, ff.conv1.bias, ff.conv2.weight, ff.conv2.bias, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,mask_kind", [(2, 37, "tail"), (3, 50, "holes"), (2, 130, "none"), (3, 1, "tail")])
def test_plain_version_matches_the_plain_chain(dtype, B, N, mask_kind):
    """K5's plain version on laid-out weights computes the chain's function:
    in f32 to f32 rounding, in bf16 within the roundings the chain adds."""
    ff = feed_forward(FLOAT32 if dtype == torch.float32 else DEFAULT)
    x, mask = inputs(B, N, mask_kind)
    with torch.no_grad():
        want = plain_chain(ff, x, mask)
        xm = x if mask is None else x.masked_fill(~mask[..., None], 0)
        got = K5.conv_ff_reference(xm.to(dtype), laid_out(ff, dtype), mask)
    assert got.dtype == want.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **(F32_TOL if dtype == torch.float32 else BF16_TOL))


def test_masked_frames_take_no_part_in_h():
    """A masked frame's h is zero whatever its input: a frame whose
    neighbours are masked too gets conv2's bias alone."""
    ff = feed_forward(FLOAT32)
    x, _ = inputs(1, 9, "none")
    mask = torch.ones(1, 9, dtype=torch.bool)
    mask[0, 3:6] = False
    y = K5.conv_ff_reference(x, laid_out(ff, torch.float32), mask)  # x left unmasked: the mask on h alone
    torch.testing.assert_close(y[0, 4], ff.conv2.bias.detach(), **F32_TOL)
    assert not torch.allclose(y[0, 2], ff.conv2.bias.detach())


def test_weights_are_laid_out_tap_major_with_values_beside_their_gates():
    ff = feed_forward(FLOAT32, c=64, i=192)
    ops = laid_out(ff, torch.float32)
    w1, w2 = ff.conv1.weight, ff.conv2.weight
    order = K5.pair_order(192)
    assert order[:64].tolist() == list(range(64)) and order[64:128].tolist() == list(range(192, 256))
    assert order[128:192].tolist() == list(range(64, 128)) and sorted(order.tolist()) == list(range(384))
    for q in (0, 63, 64, 200, 383):
        for tap in range(3):
            torch.testing.assert_close(ops.w1[q, tap * 64 : (tap + 1) * 64], w1[order[q], :, tap], rtol=0, atol=0)
    for tap in range(3):
        torch.testing.assert_close(ops.w2[:, tap * 192 : (tap + 1) * 192], w2[:, :, tap], rtol=0, atol=0)
    torch.testing.assert_close(ops.b1, ff.conv1.bias[order], rtol=0, atol=0)
    bf = laid_out(ff, torch.bfloat16)  # biases: the compute dtype's values, in f32
    assert bf.w1.dtype == torch.bfloat16 and bf.b1.dtype == torch.float32
    torch.testing.assert_close(bf.b2, ff.conv2.bias.to(torch.bfloat16).float(), rtol=0, atol=0)


def test_layout_is_cached_and_laid_out_again_when_a_parameter_changes():
    ff = feed_forward(DEFAULT)
    first = ff.operands()
    assert ff.operands() is first  # no parameter changed: the same laid-out weights
    with torch.no_grad():
        ff.conv1.weight.add_(1.0)  # in place: the version moves
    second = ff.operands()
    assert second is not first
    torch.testing.assert_close(second.w1, laid_out(ff, torch.bfloat16).w1, rtol=0, atol=0)
    ff.conv2.bias = nn.Parameter(torch.zeros(C))  # replaced
    third = ff.operands()
    assert third is not second and not third.b2.any()
    assert ff.operands() is third


@pytest.mark.parametrize("case,policy,want", [
    ("cpu", DEFAULT, "reference"),
    ("cpu_bf16_params", BF16_INFERENCE, "reference"),
    ("grad", DEFAULT, "plain chain"),
    ("f32", FLOAT32, "plain chain"),
    ("dropout", DEFAULT, "plain chain"),
    ("narrow", DEFAULT, "plain chain"),
    ("card", DEFAULT, "kernel"),
    ("card_grad", DEFAULT, "plain chain"),
])
def test_route_and_its_row_counter(monkeypatch, case, policy, want):
    """Each call's route comes from what it shows; K5's plain version runs
    only for a call the kernel would take on the card. While a profiler
    session records, the call counts its B * N rows as kernel or plain rows."""
    launches = []
    if case.startswith("card"):
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        monkeypatch.setattr(K5, "conv_ff_kernel", lambda x, ops, mask: launches.append(x.shape) or K5.conv_ff_reference(x, ops, mask))
    ff = feed_forward(policy, i=192 if case == "narrow" else I, dropout=0.1 if case == "dropout" else 0.0)  # 2 I = 384: no whole tiles
    x, mask = inputs(2, 20, "tail")
    x = x.to(policy.compute_dtype)
    seed = 7 if case == "dropout" else None
    grad = case in ("grad", "card_grad")
    with torch.set_grad_enabled(grad), profiled():
        assert ff.route(x, seed is not None) == want
        y = ff(x, mask, seed)
        counts = {c.name: c.n for c in recorded().counts if c.name.startswith("decoder.ff_")}
    assert counts == {"decoder.ff_kernel_rows" if want == "kernel" else "decoder.ff_plain_rows": 40}
    assert len(launches) == (want == "kernel")
    assert y.shape == x.shape and y.dtype == policy.compute_dtype and y.requires_grad == grad
    if want == "plain chain":
        with torch.no_grad():
            torch.testing.assert_close(y, plain_chain(ff, x, mask) if case != "dropout" else y, rtol=0, atol=0)
    else:
        with torch.no_grad():
            xm = x.masked_fill(~mask[..., None], 0)
            torch.testing.assert_close(y, K5.conv_ff_reference(xm, ff.operands(), mask), rtol=0, atol=0)


def test_row_counters_are_recorded_only_inside_a_profiler_session():
    ff = feed_forward(DEFAULT)
    x, mask = inputs(3, 11, "holes")
    with torch.no_grad():
        with profiled():
            ff(x.to(torch.bfloat16), mask)
            inside = recorded().total("decoder.ff_plain_rows")
        ff(x.to(torch.bfloat16), mask)  # no session: nothing more is recorded
        after = recorded()
    assert inside == 33
    assert after.total("decoder.ff_plain_rows") == 33 and after.total("decoder.ff_kernel_rows") == 0


def test_a_training_step_of_the_velocity_model_counts_plain_rows_only(monkeypatch):
    """A step that records a gradient never reaches K5, on the card or off it."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(K5, "conv_ff_kernel", lambda *a: pytest.fail("K5 launched in a training step"))
    cfg = TR.TransformerConfig(hidden_size=C, depth=2, heads=2, intermediate_size=I)
    model = TR.Transformer(cfg, DEFAULT, attn_implementation="xla")
    x, mask = inputs(2, 12, "tail")
    cond = torch.randn(2, C)
    with profiled():
        model(x, mask, cond).float().sum().backward()
        rec = recorded()
    assert rec.total("decoder.ff_plain_rows") == 2 * 2 * 12 and rec.total("decoder.ff_kernel_rows") == 0


@pytest.mark.parametrize("case", ["cpu", "f32", "narrow", "mask_dtype", "grad"])
def test_kernel_wrapper_refuses_what_it_does_not_take(monkeypatch, case):
    if case != "cpu":
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    c, i = (128, I) if case == "narrow" else (C, I)
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    ff = feed_forward(DEFAULT, c=c, i=i)
    ops = K5.ff_operands(ff.conv1.weight.detach(), ff.conv1.bias.detach(), ff.conv2.weight.detach(), ff.conv2.bias.detach(), dtype)
    x, mask = inputs(2, 10, "tail", c=c)
    x = x.to(dtype).requires_grad_(case == "grad")
    if case == "mask_dtype":
        mask = mask.to(torch.uint8)
    with pytest.raises(ValueError):
        K5.conv_ff_kernel(x, ops, mask)
