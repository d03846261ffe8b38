"""Long-horizon HiFi-GAN stability run.

Counterpart of scripts/gan_longrun.py: it drives the real training loop
(``pipeline.train_loops.train_hifigan``: bf16 LSGAN, spectral-norm power
iteration in the step, per-epoch LR decay, checkpoints) on the card unless
``--device cpu``, at full-width discriminators (MPD {2,3,5,7,11} + MSD) on
the synthetic formant corpus (``pipeline.synthetic.make_formant_corpus``,
built in this process), and extracts the evidence:

  run              a 50k-step (default) training run; re-running the same
                   command resumes from the last checkpoint
  report           parse the TensorBoard event files (``core.tbevents``) ->
                   <workdir>/report.md curve table (loss_gen / loss_disc /
                   mel L1 / LR / wall steps/s, non-finite counts)
  resume-check     kill -9 the trainer mid-epoch right after a checkpoint,
                   resume it, and require the final exported generator to
                   equal an uninterrupted control run's byte for byte
  resume-check-at  the same check from the last checkpoint of an existing run
  supervise        re-launch ``run`` after every exit until the step target
                   is reached, so a long run outlives crashes; exit non-zero
                   after ``--max-stalls`` (3) failed generations in a row
                   without step progress

The checks' trainers run in processes of their own under
``torch.use_deterministic_algorithms(True)`` with CUBLAS_WORKSPACE_CONFIG
set before CUDA starts; the one to kill announces its checkpoint and waits
to be killed, so the kill lands at that checkpoint on any card.

Usage: python -m speech_resynth_torch.scripts.gan_longrun run /tmp/gan50k --steps 50000 [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
MODULE = "speech_resynth_torch.scripts.gan_longrun"
SAVED = "[gan_longrun] saved"  # a deterministic child's announcement of the checkpoint it waits at


def _build_corpus(workdir: Path, n_utts: int):
    """Formant corpus with utterances long enough for production crops
    (segment_size 16080 = 50 frames at hop 320): 40-80 units x 4 frames
    -> 160-320 mel frames (3.2-6.4 s) per utterance."""
    from ..pipeline.synthetic import make_formant_corpus

    corpus_dir = workdir / "corpus"
    if not (corpus_dir / "train.json").is_file():
        make_formant_corpus(corpus_dir, n_utts=n_utts, units_per_utt=(40, 80), frames_per_unit=4, seed=0)
    return {
        "wav_dir": corpus_dir / "wavs",
        "spec_dir": corpus_dir / "spec",
        "train_file": corpus_dir / "train.json",
    }


def _gan_config(run_dir: Path, corpus, args):
    """Production-shape config: full-width G (512 initial channels, kernels
    {3,7,11}, dilations {1,3,5}) + full MPD/MSD, reference hyperparameters
    (configs/resynth/mhubert-expresso-2000.yaml:69-79)."""
    from ..core.config import config_from_dict

    return config_from_dict(
        {
            "dataset": {
                "wav_dir": str(corpus["wav_dir"]),
                "spectrogram_dir": str(corpus["spec_dir"]),
                "train_file": str(corpus["train_file"]),
                "dev_file": str(corpus["train_file"]),
                "ext_audio": ".wav",
            },
            "hifigan": {
                "path": str(run_dir),
                "batch_size": args.batch,
                "segment_size": 16080,
                "training_epochs": args.epochs,
                "learning_rate": 2e-4,
                "adam_b1": 0.8,
                "adam_b2": 0.99,
                "lr_decay": 0.999,
                "seed": 1234,
                "n_fft": 400,
                "hop_size": 320,
                "upsample_rates": [5, 4, 4, 2, 2],
                "upsample_kernel_sizes": [10, 9, 8, 4, 4],
                "stdout_interval": 500,
                "summary_interval": args.summary_interval,
                "checkpoint_interval": args.ckpt_interval,
                "validation_interval": args.val_interval,
            },
        }
    )


def _steps_per_epoch(n_utts: int, batch: int) -> int:
    return max(n_utts // batch, 1)


def _device(args):
    from ..core.device import resolve_device

    try:
        return resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        raise SystemExit(f"gan_longrun: {exc}") from exc


def cmd_run(args):
    from ..pipeline.train_loops import train_hifigan

    device = _device(args)
    workdir = Path(args.workdir)
    corpus = _build_corpus(workdir, args.n_utts)
    spe = _steps_per_epoch(args.n_utts, args.batch)
    if args.epochs is None:
        args.epochs = -(-args.steps // spe)
    print(f"[gan_longrun] {args.epochs} epochs x {spe} steps/epoch -> {args.epochs * spe} steps", flush=True)
    t0 = time.time()
    train_hifigan(_gan_config(workdir / args.run_name, corpus, args), device=device)
    print(f"[gan_longrun] done in {time.time() - t0:.0f}s", flush=True)


def cmd_report(args):
    import math

    from ..core.tbevents import read_scalars

    workdir = Path(args.workdir)
    log_dir = workdir / args.run_name / "logs"
    if not log_dir.is_dir():
        raise SystemExit(f"no event logs at {log_dir} (wrong --run-name?)")
    scal = read_scalars(log_dir)
    keys = [k for k in ("training/loss_gen", "training/loss_disc", "training/mel_error", "training/lr", "validation/mel_spec_error") if k in scal]
    # wall-clock steps/s between summary events: each summary reads the step's
    # metrics back, a host sync, so the interval covers the device's work
    anchor = scal.get("training/loss_gen", [])
    rate_at = {}
    for (s0, _, t0), (s1, _, t1) in zip(anchor, anchor[1:]):
        if t1 > t0 and s1 > s0:
            rate_at[s1] = (s1 - s0) / (t1 - t0)

    # downsample each curve to ~20 evenly spaced rows keyed by step
    steps = sorted({s for k in keys for s, _, _ in scal[k]})
    picks = steps[:: max(1, len(steps) // 20)]
    by_step = {k: {s: v for s, v, _ in scal[k]} for k in keys}

    lines = ["| step | " + " | ".join(k.split("/")[-1] for k in keys) + " | wall steps/s |",
             "|---" * (len(keys) + 2) + "|"]
    for s in picks:
        row = [f"{by_step[k].get(s, float('nan')):.4g}" if isinstance(by_step[k].get(s), float) else "" for k in keys]
        rate = rate_at.get(s)
        lines.append(f"| {s} | " + " | ".join(row) + f" | {rate:.2f} |" if rate else f"| {s} | " + " | ".join(row) + " |  |")

    # drift / stability summary
    bad = {k: sum(1 for _, v, _ in scal[k] if not math.isfinite(v)) for k in scal}
    nonfinite = {k: n for k, n in bad.items() if n}
    if anchor:
        total_steps = anchor[-1][0] - anchor[0][0]
        total_wall = anchor[-1][2] - anchor[0][2]
        lines.append("")
        lines.append(f"- steps {anchor[0][0]}..{anchor[-1][0]}; mean wall rate "
                     f"{total_steps / total_wall:.2f} steps/s ({total_wall / 3600:.2f} h)")
    lines.append(f"- non-finite scalar events: {nonfinite if nonfinite else 'none (no bf16/spectral-norm divergence)'}")
    print("\n".join(lines))
    out = workdir / "report.md"
    out.write_text("\n".join(lines) + "\n")
    print(f"wrote {out}")


def _hash_tree(path: Path) -> str:
    """Order-stable sha256 of every tensor of an exported ``model.safetensors``."""
    from ..core.safetensors import load_file

    sd = load_file(path)
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].numpy().tobytes())
    return h.hexdigest()


# A check's trainer (``deterministic_run``) in a process of its own.
CHILD = "import sys; from speech_resynth_torch.scripts.gan_longrun import deterministic_run; deterministic_run(int(sys.argv[1]), sys.argv[2:])"


def deterministic_run(stop_from: int, argv) -> None:
    """``run`` with ``argv`` under deterministic algorithms, set before CUDA
    starts. With a positive ``stop_from``, the run announces its first
    checkpoint at or after that step and waits on its standard input for the
    parent's SIGKILL (exiting if the parent goes away first)."""
    import torch

    torch.use_deterministic_algorithms(True)
    from ..pipeline import train_loops

    if stop_from > 0:
        class StopAfterSave(train_loops.CheckpointManager):
            def save(self, step, state, force=False):
                saved = super().save(step, state, force)
                if saved and step >= stop_from:
                    print(f"{SAVED} {step}", flush=True)
                    sys.stdin.read()
                    os._exit(1)
                return saved

        train_loops.CheckpointManager = StopAfterSave
    cmd_run(_parser().parse_args(["run", *argv]))


def _child(args, run_name: str, epochs: int, ckpt_interval: int, stop_from: int = 0, capture: bool = False):
    """A check's trainer as a process: ``run`` of ``run_name`` under
    deterministic algorithms, stopping at its first checkpoint at or after
    ``stop_from`` when that is positive (its standard output then piped)."""
    argv = [str(args.workdir), "--batch", str(args.batch), "--n-utts", str(args.n_utts), "--epochs", str(epochs),
            "--summary-interval", "1000000", "--val-interval", "1000000", "--ckpt-interval", str(ckpt_interval),
            "--run-name", run_name, "--device", args.device]
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
           "PYTHONPATH": os.pathsep.join(filter(None, (str(REPO), os.environ.get("PYTHONPATH"))))}
    pipe = subprocess.PIPE if capture else None
    return subprocess.Popen([sys.executable, "-c", CHILD, str(stop_from), *argv], env=env, stdin=pipe, stdout=pipe,
                            text=True)


def _kill_at_checkpoint(proc) -> int:
    """Read the child's output until it announces its checkpoint, SIGKILL it,
    and return the step; fails if it ends first."""
    for line in proc.stdout:
        if line.startswith(SAVED):
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait()
            return int(line.split()[-1])
        print(line, end="", flush=True)
    proc.wait()
    raise SystemExit("trainer finished before the kill checkpoint appeared")


def _wait(proc, what: str) -> None:
    if proc.wait() != 0:
        raise SystemExit(f"{what} failed with exit code {proc.returncode}")


def cmd_resume_check(args):
    """Control run (4 epochs uninterrupted) vs kill-at-mid-epoch + resume;
    the final exported generators must hash identically."""
    _device(args)
    workdir = Path(args.workdir)
    _build_corpus(workdir, args.n_utts)
    spe = _steps_per_epoch(args.n_utts, args.batch)
    total_epochs = 4
    kill_step = spe + spe // 2  # mid-epoch of epoch 2 -> exercises the resume's batch skip

    # control: uninterrupted, with the same mid-run checkpoint cadence so any
    # checkpoint-save side effect is identical in both runs; it runs beside
    # the interrupted one (each is deterministic on its own)
    print(f"[resume-check] control: {total_epochs} epochs = {total_epochs * spe} steps", flush=True)
    control = _child(args, "control", total_epochs, kill_step)
    killed = _child(args, "interrupted", total_epochs, kill_step, stop_from=kill_step, capture=True)
    at = _kill_at_checkpoint(killed)
    print(f"[resume-check] killed trainer at step {at}", flush=True)
    _wait(_child(args, "interrupted", total_epochs, kill_step), "the resumed run")
    _wait(control, "the control run")

    h_control = _hash_tree(workdir / "control" / "model.safetensors")
    h_resumed = _hash_tree(workdir / "interrupted" / "model.safetensors")
    verdict = {"kill_step": kill_step, "total_steps": total_epochs * spe,
               "control_sha256": h_control[:16], "resumed_sha256": h_resumed[:16],
               "step_exact": h_control == h_resumed}
    print(json.dumps(verdict))
    (workdir / "resume_check.json").write_text(json.dumps(verdict))
    if at != kill_step or h_control != h_resumed:
        raise SystemExit("resumed run diverged from uninterrupted control")


# generations in a row that may exit non-zero without advancing the
# checkpointed step before ``supervise`` gives up: a deterministic failure (a
# corrupt checkpoint, a bad flag) fails the same way on every relaunch
SUPERVISE_MAX_STALLS = 3


def cmd_supervise(args):
    """Auto-restarting supervisor for multi-hour runs: re-launch ``run`` (which
    resumes from the last checkpoint) every time the trainer exits (a
    crash, a kill, or a clean finish) until the step target is reached.
    Checkpoint cadence bounds the lost work per relaunch to <=
    ckpt_interval steps. After ``--max-stalls`` generations in a row that
    exit non-zero without advancing the checkpointed step it exits non-zero
    itself (the JAX script relaunches forever)."""
    _device(args)
    workdir = Path(args.workdir)
    base = [sys.executable, "-m", MODULE, "run", str(workdir), "--batch", str(args.batch),
            "--n-utts", str(args.n_utts), "--steps", str(args.steps),
            "--ckpt-interval", str(args.ckpt_interval), "--val-interval", str(args.val_interval),
            "--summary-interval", str(args.summary_interval), "--run-name", args.run_name, "--device", args.device]

    def last_step() -> int:
        ckpt_dir = workdir / args.run_name / "ckpt"
        if not ckpt_dir.is_dir():
            return 0
        steps = [int(p.name) for p in ckpt_dir.iterdir() if p.name.isdigit()]
        return max(steps, default=0)

    gen = stalls = 0
    while last_step() < args.steps:
        gen += 1
        start = last_step()
        print(f"[supervise] generation {gen}: resuming from step {start}", flush=True)
        rc = subprocess.run(base).returncode
        print(f"[supervise] generation {gen} exited rc={rc} at step {last_step()}", flush=True)
        if rc == 0:
            break
        stalls = stalls + 1 if last_step() <= start else 0
        if stalls >= args.max_stalls:
            raise SystemExit(f"[supervise] {stalls} generations in a row exited non-zero at step {start}: giving up")
        time.sleep(5.0)
    print(f"[supervise] done at step {last_step()} after {gen} generation(s)", flush=True)


def cmd_resume_check_at(args):
    """The resume check from the LAST checkpoint of an existing long run:
    snapshot the run dir, then run two continuations of ``--extend-steps``
    from that state, control (uninterrupted) and interrupted (SIGKILL'd at
    its first new checkpoint, then resumed), and require byte-identical
    exported generators. Run after the long run has stopped (the snapshot
    copies its checkpoint dir)."""
    import shutil

    _device(args)
    workdir = Path(args.workdir)
    src = workdir / args.run_name
    spe = _steps_per_epoch(args.n_utts, args.batch)
    ckpts = sorted(int(p.name) for p in (src / "ckpt").iterdir() if p.name.isdigit())
    if not ckpts:
        raise SystemExit(f"no checkpoints under {src}/ckpt")
    s0 = ckpts[-1]
    target = s0 + args.extend_steps
    epochs = -(-target // spe)
    ckpt_int = 64  # the first new save lands mid-continuation: the kill point
    for name in ("boundary_control", "boundary_interrupted"):
        dst = workdir / name
        if dst.exists():
            shutil.rmtree(dst)
        shutil.copytree(src, dst)

    print(f"[resume-check-at] boundary step {s0}, continuing to {epochs * spe}", flush=True)
    control = _child(args, "boundary_control", epochs, ckpt_int)
    killed = _child(args, "boundary_interrupted", epochs, ckpt_int, stop_from=s0 + 1, capture=True)
    kill_step = _kill_at_checkpoint(killed)
    print(f"[resume-check-at] killed continuation at step {kill_step}", flush=True)
    _wait(_child(args, "boundary_interrupted", epochs, ckpt_int), "the resumed continuation")
    _wait(control, "the control continuation")

    h_control = _hash_tree(workdir / "boundary_control" / "model.safetensors")
    h_resumed = _hash_tree(workdir / "boundary_interrupted" / "model.safetensors")
    verdict = {"boundary_step": s0, "kill_step": kill_step, "total_steps": epochs * spe,
               "control_sha256": h_control[:16], "resumed_sha256": h_resumed[:16],
               "step_exact": h_control == h_resumed}
    print(json.dumps(verdict))
    (workdir / "boundary_resume_check.json").write_text(json.dumps(verdict))
    if h_control != h_resumed:
        raise SystemExit("resumed continuation diverged from uninterrupted control")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("run", "report", "resume-check", "resume-check-at", "supervise"):
        s = sub.add_parser(name)
        s.add_argument("workdir")
        s.add_argument("--steps", type=int, default=50000)
        s.add_argument("--epochs", type=int, default=None)
        s.add_argument("--batch", type=int, default=16)
        s.add_argument("--n-utts", type=int, default=512)
        s.add_argument("--ckpt-interval", type=int, default=5000)
        s.add_argument("--val-interval", type=int, default=5000)
        s.add_argument("--summary-interval", type=int, default=100)
        s.add_argument("--run-name", default="run")
        s.add_argument("--extend-steps", type=int, default=128,
                       help="resume-check-at: continuation length past the boundary checkpoint")
        s.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu; report reads files only")
        if name == "supervise":
            s.add_argument("--max-stalls", type=int, default=SUPERVISE_MAX_STALLS,
                           help="exit non-zero after this many generations in a row that fail without step progress")
    return parser


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.cmd == "run":
        cmd_run(args)
    elif args.cmd == "report":
        cmd_report(args)
    elif args.cmd == "resume-check-at":
        cmd_resume_check_at(args)
    elif args.cmd == "supervise":
        cmd_supervise(args)
    else:
        cmd_resume_check(args)


if __name__ == "__main__":
    main()
