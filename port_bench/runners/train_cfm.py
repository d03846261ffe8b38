"""Training cell: the step of ``train.cfm.make_trainer`` on batches drawn on
the card from the seed, one a step.

Set-up builds the trainer once (DEFAULT: f32 parameters, bf16 compute; the
configuration's AdamW, clip and schedule), loads the weights drawn from the
seed (the unit table frozen), and drives that same step object through its
first ``reference_steps`` steps with the window's own feed and call: they
warm every shape, and the check holds them against the plain reference.
The window then steps on until its time is up and ends in a synchronize. Its
first step is held too: the trainable weights and AdamW's moments are cloned
on the card before it (at the end of set-up) and after it.

The check: the reference follows the first steps from the same weights,
batches and noise (the step's generator seeded as the step seeds it). Per
step the loss; per leaf (parameter tensor) the norm of the first gradient
as the optimizer got it (AdamW's first moment after one step over 1 - b1)
and of the weights' change after the steps, each gap measured against the
larger of that leaf's reference norm and the median leaf's. The held step
is followed from the program's own state before it, on its batch and noise
drawn again from the seed: its loss, its gradient as the optimizer got it
((first moment after - b1 x first moment before) / (1 - b1)) and its change,
by the same measures (its loss is printed beside the reference's, not
compared).
"""

from __future__ import annotations

import time

import torch

from port_bench.harness import Check, sub_seed, tf32_off
from port_bench.program import cfm_config, cfm_weights
from port_bench.reference import resynth as ref
from port_bench.reference import train as ref_train
from port_bench.yardstick import traffic as T

FROZEN = ("to_cond_emb.weight",)


class State:
    pass


def step_seed(seed: int, i: int) -> int:
    return sub_seed(seed, 100 + i)


def setup(run):
    from speech_resynth_torch.core.precision import DEFAULT
    from speech_resynth_torch.train.cfm import CFMTrainerConfig, make_trainer

    fm, tr, dev = run.config["flow_matching"], run.traffic, run.device
    st = State()
    w = cfm_weights(torch, run.config, run.seed, dev, torch.float32)
    trainer = CFMTrainerConfig(batch_size=tr["batch_size"], frames_per_seg=tr["frames_per_seg"], warmup_steps=fm["warmup_steps"],
                               lr=fm["lr"], lr_min=fm["lr_min"], max_norm=fm["max_norm"], seed=sub_seed(run.seed, 6))
    st.model, st.state, st.step = make_trainer(cfm_config(fm), trainer, run.config["assumed"]["train_total_steps"],
                                               w["to_cond_emb.weight"].cpu().numpy(), DEFAULT, dev)
    st.model.load_state_dict(w)
    st.optimizer = st.state.optimizers["model"]
    run.synchronize()
    run.lap("the trainer built, its weights loaded")
    st.names = [n for n, p in st.model.named_parameters() if p.requires_grad]
    del w
    st.gen = torch.Generator(device=dev).manual_seed(sub_seed(run.seed, 5))
    st.n, st.valid, st.losses = 0, [], []
    for _ in range(tr["reference_steps"]):
        metrics = one_step(run, st)
        st.losses.append(metrics["loss"])
        if st.n == 1:
            params = dict(st.model.named_parameters())
            b1 = st.optimizer.adamw.param_groups[0]["betas"][0]
            st.first_grad = {n: st.optimizer.adamw.state[params[n]]["exp_avg"].detach() / (1 - b1)
                             if params[n] in st.optimizer.adamw.state else torch.zeros_like(params[n]) for n in st.names}
    st.before_held = snapshot(st)
    st.after = {n: leaf[0] for n, leaf in st.before_held.items()}
    run.synchronize()
    run.lap(f"the first {tr['reference_steps']} steps")
    st.losses = [float(x) for x in st.losses]
    return st


def one_step(run, st) -> dict:
    """The window's feed and call: a batch drawn on the card, one trainer step."""
    fm, tr = run.config["flow_matching"], run.traffic
    with run.span("feed"):
        batch, lengths = T.train_batch(torch, st.gen, tr, fm["vocab_size"], fm["dim_in"])
    with run.span("step"):
        st.state, metrics = st.step(st.state, batch, step_seed(run.seed, st.n))
    st.valid.append(lengths.sum())
    st.n += 1
    return metrics


def snapshot(st) -> dict:
    """Clones, on the card, of each trainable leaf and its AdamW moments (zeros where the optimizer holds none)."""
    params, state = dict(st.model.named_parameters()), st.optimizer.adamw.state
    out = {}
    for n in st.names:
        w = params[n].detach()
        moments = state.get(params[n], {})
        out[n] = (w.clone(), *(moments[k].clone() if k in moments else torch.zeros_like(w) for k in ("exp_avg", "exp_avg_sq")))
    return out


def window(run, st) -> dict:
    tr = run.traffic
    first = st.n
    t0 = time.perf_counter()
    metrics = one_step(run, st)
    st.held = {"n": first, "before": st.before_held, "after": snapshot(st), "loss": metrics["loss"]}
    while time.perf_counter() - t0 < run.seconds:
        metrics = one_step(run, st)
    with run.span("sync"):
        run.synchronize()
    wall = time.perf_counter() - t0
    steps = st.n - first
    st.last_loss = float(metrics["loss"])
    run.records.update(steps=steps, wall_s=wall, valid_keys=[int(v) for v in st.valid[first:]])
    run.note(f"steps {steps} in {wall!r} s, {wall / steps * 1e3!r} ms a step; last loss {st.last_loss!r}")
    return {"metrics": {"train_frames_per_s": steps * tr["batch_size"] * tr["frames_per_seg"] / wall},
            "attempted": steps, "failed": 0}


def release(run, st) -> None:
    del st.model, st.state, st.step, st.optimizer
    if run.device != "cpu":
        torch.cuda.empty_cache()


def reference_inputs(run, steps):
    """The batches and noise of the steps numbered ``steps`` (ascending), drawn
    again from the seed as the feed and the step draw them."""
    fm, tr, dev = run.config["flow_matching"], run.traffic, run.device
    gen = torch.Generator(device=dev).manual_seed(sub_seed(run.seed, 5))
    batches, noises = [], []
    for i in range(max(steps) + 1):
        batch, _ = T.train_batch(torch, gen, tr, fm["vocab_size"], fm["dim_in"])
        if i not in steps:
            continue
        g = torch.Generator(device=dev).manual_seed(step_seed(run.seed, i))
        labels = batch["spectrogram_labels"]
        x0 = torch.randn(labels.shape, generator=g, device=dev)
        times = torch.rand((labels.shape[0],), generator=g, device=dev)
        batches.append(batch)
        noises.append((x0, times))
    return batches, noises


def leaf_gap(got: dict, want: dict, names) -> float:
    """The worst leaf's | |got| - |want| | over the larger of |want| and the median leaf's |want|."""
    norms = {n: float(want[n].norm()) for n in names}
    median = sorted(norms.values())[len(norms) // 2]
    return max(abs(float(got[n].norm()) - norms[n]) / max(norms[n], median) for n in names)


def compare(run, losses, first_grad, after, want) -> list:
    """The numbers compared: the steps' worst relative loss gap, the first
    gradient's and the change's worst leaf gaps (the change only over leaves
    whose reference gradient is at least 1e-3 of the median leaf's)."""
    w0 = cfm_weights(torch, run.config, run.seed, run.device, torch.float32)
    ref_losses, ref_first, ref_after = want[:3]
    names = list(ref_first)
    moved = moved_leaves(ref_first)
    change = {n: after[n] - w0[n] for n in names}
    ref_change = {n: ref_after[n] - w0[n] for n in names}
    limits = run.traffic["limits"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    run.note(f"losses {losses} reference {ref_losses}; {len(moved)} of {len(names)} leaves counted in the change")
    return [
        Check("loss_gap", loss_gap, limits["loss_gap"]),
        Check("grad_gap", leaf_gap(first_grad, ref_first, names), limits["grad_gap"]),
        Check("change_gap", leaf_gap(change, ref_change, moved), limits["change_gap"]),
    ]


def moved_leaves(ref_grads: dict) -> list:
    """The leaves counted in a change: those whose reference gradient is at
    least 1e-3 of the median leaf's (the rest move by round-off alone)."""
    norms = {n: float(g.norm()) for n, g in ref_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return [n for n in norms if norms[n] >= 1e-3 * median]


def compare_held(run, loss, before: dict, after: dict, want) -> list:
    """The numbers compared of the held window step, from the state
    ``before`` it to the state ``after`` it (leaf -> (weights, first moment,
    second moment)), against the reference's one step from ``before``."""
    b1 = run.config["flow_matching"]["adam_b1"]
    ref_losses, ref_grad, ref_after = want[:3]
    names = list(ref_grad)
    grad = {n: (after[n][1] - b1 * before[n][1]) / (1 - b1) for n in names}
    change = {n: after[n][0] - before[n][0] for n in names}
    ref_change = {n: ref_after[n] - before[n][0] for n in names}
    limits = run.traffic["limits"]
    # its loss gap is printed, not compared: neither the control nor a fault moves it three times past sound runs
    run.note(f"held window step: loss {float(loss)!r} reference {ref_losses[0]!r}, "
             f"gap {abs(float(loss) - ref_losses[0]) / abs(ref_losses[0])!r}")
    return [
        Check("window_grad_gap", leaf_gap(grad, ref_grad, names), limits["window_grad_gap"]),
        Check("window_change_gap", leaf_gap(change, ref_change, moved_leaves(ref_grad)), limits["window_change_gap"]),
    ]


def trainable(run) -> list:
    return [k for k, _, _, is_buffer in ref.cfm_spec(run.config["flow_matching"], run.config["assumed"]["weights"])
            if not is_buffer and k not in FROZEN]


def reference_steps(run, p=ref.F32, n=None, start=None, weights=None):
    """The reference's steps: the first ``reference_steps`` from the seed's
    weights, or, given ``start`` (AdamW's state, its last item the step's
    number) and ``weights``, ``n`` steps from there."""
    fm, tr = run.config["flow_matching"], run.traffic
    n = tr["reference_steps"] if n is None else n
    w0 = cfm_weights(torch, run.config, run.seed, run.device, torch.float32)
    if weights is not None:
        w0.update(weights)
    first = 0 if start is None else start[2]
    batches, noises = reference_inputs(run, list(range(first, first + n)))
    with tf32_off(torch):
        return ref_train.steps(w0, trainable(run), fm, batches, noises, n, run.config["assumed"]["train_total_steps"], p,
                               tr["reference_rows"], start)


def check(run, st) -> list:
    finite = Check("window_loss_finite", float(torch.isfinite(torch.tensor(st.last_loss))), 1.0, "min")
    before, after = st.held["before"], st.held["after"]
    names = trainable(run)
    want = reference_steps(run, n=1, weights={n: before[n][0] for n in names},
                           start=({n: before[n][1] for n in names}, {n: before[n][2] for n in names}, st.held["n"]))
    held = compare_held(run, st.held["loss"], before, after, want)
    return compare(run, st.losses, st.first_grad, st.after, reference_steps(run)) + held + [finite]


def control(run, fmt: str = "fp8") -> list:
    """The control: the reference's steps computed in ``fmt`` put in the
    program's place, held by the same comparison against the f32 reference:
    the first steps from the seed's weights, and the held window step from
    the f32 reference's own state after them."""
    low, low_p = reference_steps(run, ref.Precision(fmt)), ref.Precision(fmt)
    want = reference_steps(run)
    _, _, w_n, state = want
    step = {"weights": w_n, "start": state}
    one, one_low = reference_steps(run, n=1, **step), reference_steps(run, low_p, n=1, **step)
    before = {k: (w_n[k], state[0][k], state[1][k]) for k in w_n}
    after = {k: (one_low[2][k], one_low[3][0][k], one_low[3][1][k]) for k in w_n}
    return compare(run, *low[:3], want) + compare_held(run, one_low[0][0], before, after, one)
