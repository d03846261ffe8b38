#!/usr/bin/env python3
"""Phase clocks of the fused MRF block (K2 and K3) on the card.

    python3 scripts/mrf_block_clocks.py          # from the repo root, on a machine with an H100 and nvcc

Builds a copy of ``speech_resynth_torch/ops/csrc`` under ``build/mrf_block_clocks/``
in which the block that runs one tile (time tile 40 of batch row 5) stamps
``%globaltimer`` at the tile's phase boundaries: each branch's window load
(for K3 after the first branch, with the sum pass before it), each conv's
products and each conv's epilogue, the last before the store. It then launches
that library's K3 and K2 (the K = 11 branch, whose window K3 runs every branch
on) at the three stage widths of a served batch (16 rows of 512 frames, bf16)
and prints, per launch, the device time of the whole launch (CUDA events over
10 launches), the tile and the stamped tile's phases in microseconds. The
package's own library is not touched. The patch finds its places in
``mrf_block.cuh`` by text and stops if they change.
"""

from __future__ import annotations

import ctypes
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from speech_resynth_torch.ops import build as B  # noqa: E402
from speech_resynth_torch.ops import fused_mrf as M  # noqa: E402

SRC = ROOT / "build" / "mrf_block_clocks"
STAMPED = (40, 5)  # (time tile, batch row) of the tile that is stamped
DILATIONS = (1, 3, 5)
SHAPES = ((64, 40980), (32, 81960), (16, 163920))  # one served vocoder call's stages: 16 x 512 frames


def patched(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"mrf_block_clocks: the block's source changed; anchor not found:\n{old}")
    return text.replace(old, new, 1)


def build() -> ctypes.CDLL:
    shutil.rmtree(SRC, ignore_errors=True)
    shutil.copytree(B.CSRC, SRC)
    h = (SRC / "mrf_block.cuh").read_text()
    h = patched(h, "namespace mrf_block {", """namespace mrf_block {
static __device__ unsigned long long g_clk[128];
static __device__ int g_clk_tile;
#define STAMP(k) do { if (clk_on && threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_clk[(k)] = t_; } } while (0)""")
    anchor = "    const int n_out = min(t_tile, T_len - t0);"
    h = patched(h, anchor, "    const bool clk_on = tile == g_clk_tile;\n    int clk_i = 1;\n    STAMP(0);\n" + anchor)
    h = patched(h, "      fence_async_shared();\n      named_barrier_sync(1, CONSUMERS);\n\n      int rem",
                "      fence_async_shared();\n      named_barrier_sync(1, CONSUMERS);\n      STAMP(clk_i); ++clk_i;\n\n      int rem")
    for anchor in ("named_barrier_sync(1, CONSUMERS);  // every warpgroup is done reading the operand\n",
                   "named_barrier_sync(1, CONSUMERS);  // the operand and the residual are complete\n"):
        h = patched(h, anchor, anchor + "        STAMP(clk_i); ++clk_i;\n")
    h = patched(h, "    // the tile's outputs: K2's residual", "    STAMP(127);\n    // the tile's outputs: K2's residual")
    (SRC / "mrf_block.cuh").write_text(h)
    reader = """
extern "C" int clocks_%s(unsigned long long* host, int tile, int set) {
  if (set) return cudaMemcpyToSymbol(mrf_block::g_clk_tile, &tile, sizeof(tile));
  return cudaMemcpyFromSymbol(host, mrf_block::g_clk, 128 * 8);
}
"""
    for name, tag in (("fused_mrf.cu", "k3"), ("mrf_branch.cu", "k2")):
        (SRC / name).write_text((SRC / name).read_text() + reader % tag)

    def nvcc(*args):
        done = subprocess.run([B._nvcc(), *B.NVCC_FLAGS, *args], capture_output=True, text=True)
        if done.returncode != 0:
            raise SystemExit(f"mrf_block_clocks: nvcc failed:\n{done.stdout}{done.stderr}")

    objs = []
    for name in ("fused_mrf.cu", "mrf_branch.cu", "runtime.cu"):
        objs.append(str(SRC / (name + ".o")))
        nvcc("-c", str(SRC / name), "-o", objs[-1])
    lib_path = SRC / "libclocks.so"
    nvcc("-shared", *objs, "-o", str(lib_path))
    lib = ctypes.CDLL(str(lib_path))
    lib.srt_mrf_stage.argtypes = B.SIGNATURES["srt_mrf_stage"]
    lib.srt_mrf_branch.argtypes = B.SIGNATURES["srt_mrf_branch"]
    lib.srt_mrf_stage_scratch_floats.argtypes = B.SIGNATURES["srt_mrf_stage_scratch_floats"]
    for tag in ("k3", "k2"):
        getattr(lib, f"clocks_{tag}").argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("mrf_block_clocks: CUDA is not available", file=sys.stderr)
        return 2
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    n = ctypes.c_longlong()
    if lib.srt_mrf_stage_scratch_floats(ctypes.byref(n)) != 0:
        raise SystemExit("mrf_block_clocks: no scratch size")
    scratch = torch.empty(n.value, device="cuda")
    shapes = [(K, DILATIONS) for K in (3, 7, 11)]
    for C, T in SHAPES:
        x = (torch.randn(16, C, T, generator=gen, device="cuda") * 0.5).bfloat16()
        branches = []
        for K in (3, 7, 11):
            std = 1 / math.sqrt(C * K)
            w1, w2 = ((torch.randn(3, C, C, K, generator=gen, device="cuda") * std).bfloat16() for _ in range(2))
            b1, b2 = ((torch.randn(3, C, generator=gen, device="cuda") * 0.01).bfloat16() for _ in range(2))
            branches.append((w1, b1, w2, b2, DILATIONS))
        ops = M.stage_operands(branches)
        out = torch.empty_like(x)
        k2 = M.stage_operands(branches[2:])  # the K = 11 branch, laid out as K2 takes it
        runs = [
            ("K3", "k3", M.kernel_stage_plan(16, C, T, shapes, 2)[0], lambda: lib.srt_mrf_stage(
                x.data_ptr(), ops.w1.data_ptr(), ops.b1.data_ptr(), ops.w2.data_ptr(), ops.b2.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), scratch.numel(), 16, C, T, 3, M._stage_spec(shapes), 1, M.LRELU_SLOPE, stream)),
            ("K2 K=11", "k2", M.kernel_branch_plan(16, C, T, 11, DILATIONS, 2)[0], lambda: lib.srt_mrf_branch(
                x.data_ptr(), k2.w1.data_ptr(), k2.b1.data_ptr(), k2.w2.data_ptr(), k2.b2.data_ptr(), out.data_ptr(),
                16, C, T, 11, 3, *DILATIONS, 1, M.LRELU_SLOPE, stream)),
        ]
        for label, tag, t_tile, run in runs:
            clocks = getattr(lib, f"clocks_{tag}")
            clocks(None, STAMPED[1] * -(-T // t_tile) + STAMPED[0], 1)
            for _ in range(3):
                if run() != 0:
                    raise SystemExit(f"mrf_block_clocks: {label} failed to launch")
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                run()
            end.record()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 128)()
            clocks(buf, 0, 0)
            n_stamps = 1 + (3 if tag == "k3" else 1) * 13
            stamps = [buf[i] for i in range(n_stamps)] + [buf[127]]
            phases = [round((b - a) / 1000, 3) for a, b in zip(stamps, stamps[1:])][:-1]
            per_branch = [phases[i : i + 13] for i in range(0, len(phases), 13)]
            print(json.dumps({
                "launch": label, "C": C, "T": T, "batch": 16, "t_tile": t_tile, "ms": start.elapsed_time(end) / 10,
                "block_us": round((stamps[-1] - stamps[0]) / 1000, 3),
                "branches": [{"load_us": b[0], "products_us": b[1::2], "epilogues_us": b[2::2]} for b in per_branch],
            }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
