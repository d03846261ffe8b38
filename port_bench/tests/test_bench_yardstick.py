"""The yardstick's arithmetic: frozen FLOP counts, the latency tail, the
device's idle share, the length draw."""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest

from port_bench.yardstick import flops, kernels, timeline, traffic

HERE = Path(__file__).resolve().parents[1]
EXPRESSO = json.loads((HERE / "configs" / "expresso.json").read_text())


def test_frozen_cfm_and_vocoder_flops_match_the_program_at_the_yaml_widths():
    from speech_resynth_torch.core import metrics
    from speech_resynth_torch.models.cfm import CFMConfig
    from speech_resynth_torch.models.hifigan import HifiGanConfig

    fm, hg = EXPRESSO["flow_matching"], EXPRESSO["hifigan"]
    cfm = CFMConfig(**{k: fm[k] for k in (f.name for f in dataclasses.fields(CFMConfig)) if k in fm})
    voc = HifiGanConfig()
    for b, n in ((1, 250), (32, 1024), (2700, 100)):
        assert flops.cfm_forward_flops(fm, b, n) == metrics.cfm_forward_flops(cfm, b, n)
        assert flops.cfm_step_flops(fm, b, n) == metrics.cfm_step_flops(cfm, b, n)
        assert flops.hifigan_generator_flops(hg, b, n) == metrics.hifigan_generator_flops(voc, b, n)
    assert flops.waveform_length(hg, 250) == int(voc.waveform_lengths(250)) == 249 * 320 + 400


def test_mrf_stage_count_is_twelve_k_c2_t_b_and_the_stages_are_the_narrow_ones():
    hg = EXPRESSO["hifigan"]
    stages = flops.mrf_stages(hg, 100)
    assert [c for c, _ in stages] == [64, 32, 16]
    c, t = stages[0]
    ops, nbytes = kernels.mrf_stage_cost(2, c, t, hg["resblock_kernel_sizes"], hg["resblock_dilation_sizes"])
    assert ops == 12.0 * sum(hg["resblock_kernel_sizes"]) * c * c * t * 2
    assert nbytes > 2 * 2 * c * t * 2


def test_k1_cost_counts_every_query_against_its_rows_valid_keys():
    ops, nbytes = kernels.k1_cost(2, 2, 128, 128, [100, 28])
    assert ops == 4.0 * 2 * 128 * 128 * 128
    assert nbytes == 2 * 2 * 2 * 128 * 128 * 2 + 2 * 2 * 128 * 2 * 128 + 2 * 128


def test_kernel_names_fall_in_their_groups():
    assert kernels.kernel_group("void flash_fwd_bf16<128>(...)") == kernels.K1
    assert kernels.kernel_group("void mrf_block_bf16_kernel<64, false>(...)") == kernels.K2
    assert kernels.kernel_group("_Z21mrf_block_bf16_kernelILi64ELb1EEvv") == kernels.K3
    assert kernels.kernel_group("sm90_xmma_fprop_implicit_gemm_bf16") == "conv (cuDNN)"
    assert kernels.kernel_group("nvjet_hsh_128x256") == "matmul (cuBLAS)"
    assert kernels.kernel_group("vectorized_elementwise_kernel<4, ...>") == kernels.ELEMENTWISE


def test_p95_is_taken_over_every_request_not_over_chunks():
    serve = pytest.importorskip("port_bench.runners.serve")
    latencies = np.concatenate([np.full(950, 100.0), np.full(50, 1000.0)])
    assert serve.tail_ms(latencies, 95) == pytest.approx(float(np.percentile(latencies, 95)))
    # medians of chunks of 100 would read 100 everywhere; the tail over all requests sees the slow 5%
    assert serve.tail_ms(np.concatenate([latencies, [5000.0] * 10]), 95) > 100.0


def test_idle_share_is_a_union_of_overlapping_intervals():
    ops = [(0.0, 0.4), (0.1, 0.5), (0.45, 0.6), (0.8, 0.9)]
    assert timeline.busy(ops, 0.0, 1.0) == pytest.approx(0.7)
    assert sum(b - a for a, b in ops) == pytest.approx(1.05)  # a sum of kernel times reads busier than the card was
    assert timeline.gaps(ops, 0.0, 1.0) == [(0.6, 0.8), (0.9, 1.0)]
    assert timeline.busy(ops, 0.2, 0.85) == pytest.approx(0.45)


def test_idle_gaps_are_named_by_the_innermost_covering_span():
    ops = [(0.0, 0.1), (0.5, 0.6)]
    spans = [("drain", 0.0, 1.0), ("dispatch", 0.08, 0.52), ("collate", 0.2, 0.25)]
    assert timeline.idle_gaps(ops, spans, 0.0, 0.6) == [["dispatch", pytest.approx(0.4)]]


def test_lengths_follow_the_stratified_lognormal_with_its_median_and_clip():
    tr = json.loads((HERE / "traffic" / "serve.json").read_text())
    seconds = traffic.block_lengths_s(tr["length_s"], tr["block"])
    assert np.median(seconds) == pytest.approx(tr["length_s"]["median"], rel=0.01)
    assert seconds.min() >= tr["length_s"]["min"] and seconds.max() == tr["length_s"]["max"]
    units = traffic.block_units(tr)
    assert units.min() == 50 and units.max() == 1000
    dedup = json.loads((HERE / "traffic" / "serve_dedup.json").read_text())
    assert traffic.block_units(dedup).max() == 500


def test_every_seed_draws_the_same_lengths_in_another_order():
    tr = json.loads((HERE / "traffic" / "serve.json").read_text())
    a = [len(u) for _, (_, u) in zip(range(256), traffic.request_stream(tr, 2000, 2**31 + 7))]
    b = [len(u) for _, (_, u) in zip(range(256), traffic.request_stream(tr, 2000, 12))]
    assert a != b and sorted(a) == sorted(b)
    # batch for batch the same work: each seed's batches of 32 are the block's fixed groups
    groups = sorted(sorted(g.tolist()) for g in traffic.block_groups(tr))
    assert sorted(sorted(a[i : i + 32]) for i in range(0, 256, 32)) == groups
    assert sorted(sorted(b[i : i + 32]) for i in range(0, 256, 32)) == groups
    first = traffic.first_longest(tr, 2000, 2**31 + 7)
    assert a[first] == max(a) and max(a[:first], default=0) < max(a)


def test_deduplicated_units_never_repeat_their_predecessor():
    ids = traffic.unit_ids(np.random.default_rng(0), 5000, 2000, runs=False)
    assert ids.min() >= 1 and ids.max() <= 2000 and not np.any(ids[1:] == ids[:-1])


def test_hubert_frames_follow_the_conv_stack():
    enc = {"conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2]}
    assert flops.hubert_frames(enc, 16000) == 49
    assert math.isclose(flops.kmeans_flops(10, 768, 2000), 2 * 10 * 768 * 2000)
