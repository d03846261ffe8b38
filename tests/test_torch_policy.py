"""The port against the JAX package under the policies its entry points run:
BF16_INFERENCE (bf16 weights and compute) for the CFM decoder, the vocoder,
the composite, the speech encoder, the LM and the scorers. The trainers'
DEFAULT is in tests/test_torch_policy_train.py.

Both sides take the same weights (drawn with numpy from a seed into the JAX
package's parameter tree, which ``jax.eval_shape`` of its init gives; cast by
``Policy.cast_params`` on the JAX side and carried by ``models/convert.py``
into the port's bf16 parameters; buffers stay f32 on both) and the same
inputs, made with numpy from the seed (the ODE noise as ``x0``). Two sound
bf16 runs part once one rounding flips, so no elementwise tolerance holds
them. Each case has two measures instead:

(a) one block (one transformer block, one MRF branch, one HuBERT layer, one
    Llama layer, one Whisper encoder layer) on identical bf16 inputs: the
    share of output elements more than one bf16 ulp of the JAX value from it;
(b) the whole model: the distance port-vs-JAX, ||a - b|| / ||b||, as a
    multiple of the distance of JAX's bf16 run from the f32 run on the same
    case. The f32 run is the port's under FLOAT32, which the f32 parity tests
    (tests/test_torch_models.py, test_torch_composite.py, ...) hold to the
    JAX package's within 1e-5: one JAX compile a case instead of two.

Each limit (LIMITS) sits between what sound runs read and what faults planted
in the port read, over several seeds (PERF.md §6): a weight that skips
its cast (its product in f32), a norm that JAX takes in f32 taken in bf16,
the ODE state rounded to bf16 each step, a dropped bias. Each case's test
reads the sound port, then plants each fault and holds that it crosses a
limit. To print every case's measures and each fault's, seed by seed, and
the largest sound and smallest fault reading of each measure:

    JAX_PLATFORMS=cpu python tests/test_torch_policy.py [case ...] [--seeds 0 1 2]
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speech_resynth_tpu.core.precision import BF16_INFERENCE as JAX_BF16
from speech_resynth_tpu.core.precision import FLOAT32 as JAX_FLOAT32
from speech_resynth_tpu.dsp.mulaw import mulaw_encode as jax_mulaw_encode
from speech_resynth_tpu.models import cfm as jax_cfm
from speech_resynth_tpu.models import hifigan as jax_hifigan
from speech_resynth_tpu.models import hubert as jax_hubert
from speech_resynth_tpu.models import llama as JL
from speech_resynth_tpu.models import transformer as jax_tr
from speech_resynth_tpu.models import utmos as JU
from speech_resynth_tpu.models import whisper as JW
from speech_resynth_tpu.models.kmeans import KMeansQuantizer as JaxQuantizer
from speech_resynth_tpu.ops import dedup as jax_dedup
from speech_resynth_tpu.ops import fused_mrf as JFM
from speech_resynth_torch.core.precision import BF16_INFERENCE, FLOAT32
from speech_resynth_torch.models import cfm as torch_cfm
from speech_resynth_torch.models import hifigan as torch_hifigan
from speech_resynth_torch.models import hubert as torch_hubert
from speech_resynth_torch.models import llama as TL
from speech_resynth_torch.models import transformer as torch_tr
from speech_resynth_torch.models import utmos as TU
from speech_resynth_torch.models import whisper as TW
from speech_resynth_torch.models.composite import ConditionalFlowMatchingWithHifiGan
from speech_resynth_torch.models.convert import (
    cfm_state_dict,
    hifigan_generator_state_dict,
    hubert_state_dict,
    llama_state_dict,
    utmos_state_dict,
    whisper_state_dict,
)
from speech_resynth_torch.models.kmeans import KMeansQuantizer
from speech_resynth_torch.models.speech_encoder import SpeechEncoder
from speech_resynth_torch.ops import fused_mrf as TFM
from test_utmos import tiny_ssl_cfg

BF16 = torch.bfloat16

# Limits of the measures, per case: "block" for (a) ("cfm_block" and
# "vocoder_block" in the composite), "model" for (b) (the scorers' per model;
# "ode" the CFM's ODE measure). Each sits between the sound runs and the
# planted faults that cross it (PERF.md §6: each measure's largest sound
# reading and each fault's smallest, over seeds 0-4).
LIMITS = {
    "cfm": {"block": 0.435, "model": 2.0, "ode": 3.0},
    "vocoder": {"block": 0.05, "model": 2.0, "model_stage": 2.0},
    "composite": {"cfm_block": 0.435, "vocoder_block": 0.05, "model": 1.5},
    "encoder": {"block": 0.34, "model": 1.05},
    "llama": {"block": 0.318, "model": 1.12},
    "scorers": {"block": 0.345, "encoder": 1.16, "logits": 1.13, "utmos": 1.2},
}
# planted faults that no measure tells from the sound runs over the seeds
# (PERF.md): a weight that skips its cast in HuBERT's and Whisper's layers (one
# rounding among a block's); the composite's ODE-state fault, held by the CFM
# case's "ode"; the UTMOS tower's LayerNorm in bf16, the function of the
# encoder's norm fault, held by the encoder case's "block"
NOT_SEEN = {("encoder", "skip_cast"), ("scorers", "skip_cast"), ("composite", "ode_state_in_bf16"),
            ("scorers", "utmos_norm_in_bf16")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch (the suite runs six workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the measures
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def ulp_share(got, want, valid=None) -> float:
    """The share of elements of ``got`` more than one bf16 ulp of ``want``
    (2^(e - 7) for |want| in [2^e, 2^(e+1))) from ``want``; ``valid`` keeps
    a boolean mask's elements."""
    got, want = _np(got), _np(want)
    _, e = np.frexp(np.abs(want))
    ulp = np.where(want == 0, 2.0**-133, np.ldexp(1.0, e - 8))
    over = np.abs(got - want) > ulp
    return float(over[valid].mean() if valid is not None else over.mean())


def dist(got, want) -> float:
    """||got - want|| / ||want||."""
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def model_ratio(port_bf16, jax_bf16, f32) -> float:
    """(b): the port's distance from JAX's bf16 run over that run's distance from f32."""
    return dist(port_bf16, jax_bf16) / dist(jax_bf16, f32)


# ---------------------------------------------------------------------------
# faults planted in the port
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


@contextlib.contextmanager
def skip_cast(module: torch.nn.Module, name: str, f32_value: torch.Tensor):
    """Fault: the weight ``name`` of ``module`` enters its product (a
    linear, a conv or a transposed conv) as its f32 value, the product in
    f32, where JAX casts it to the compute dtype; the output is rounded back
    to the input's dtype. The fault must hit at least once."""
    p = module.get_parameter(name)
    w32 = f32_value.float()
    hits = []

    def wrap(real):
        def call(x, weight, bias=None, *args, **kwargs):
            if weight is p or (weight.shape == p.shape and torch.equal(weight, p.detach().to(weight.dtype))):
                hits.append(1)
                return real(x.float(), w32, None if bias is None else bias.float(), *args, **kwargs).to(x.dtype)
            return real(x, weight, bias, *args, **kwargs)

        return call

    with contextlib.ExitStack() as stack:
        for fn in ("linear", "conv1d", "conv_transpose1d"):
            stack.enter_context(patched(F, fn, wrap(getattr(F, fn))))
        yield
    assert hits, f"the planted cast fault never met {name}"


@contextlib.contextmanager
def drop_bias(module: torch.nn.Module, name: str):
    """Fault: the bias ``name`` of ``module`` left out (zero)."""
    p = module.get_parameter(name)
    saved = p.detach().clone()
    with torch.no_grad():
        p.zero_()
    try:
        yield
    finally:
        with torch.no_grad():
            p.copy_(saved)


def _adaptive_rmsnorm_bf16(self, x, condition):
    xb = x.to(BF16)
    normed = xb * torch.rsqrt(torch.sum(xb * xb, dim=-1, keepdim=True) + 1e-24)
    gamma = F.linear(condition.to(BF16), self.to_weight.weight.to(BF16))
    return (normed * self.hidden_size**0.5 * (gamma[:, None, :] + 1.0)).to(self.policy.compute_dtype)


def _llama_rmsnorm_bf16(self, x):
    xb = x.to(BF16)
    normed = xb * torch.rsqrt(torch.mean(xb * xb, dim=-1, keepdim=True) + self.eps)
    return (self.weight.to(BF16) * normed).to(self.policy.compute_dtype)


def _layer_norm_bf16(x, ln):
    """LayerNorm with its statistics in bf16 (torch's own bf16 layer_norm
    keeps them in f32)."""
    xb = x.to(BF16)
    mu = xb.mean(dim=-1, keepdim=True)
    var = ((xb - mu) * (xb - mu)).mean(dim=-1, keepdim=True)
    return (xb - mu) * torch.rsqrt(var + ln.eps) * ln.weight.to(BF16) + ln.bias.to(BF16)


def norm_in_bf16(case: str):
    """Fault: the case's f32 norm (the CFM's adaptive RMSNorm, Llama's
    RMSNorm, HuBERT's, UTMOS's and Whisper's LayerNorms) computed in bf16."""
    return {
        "cfm": lambda: patched(torch_tr.AdaptiveRMSNorm, "forward", _adaptive_rmsnorm_bf16),
        "llama": lambda: patched(TL.LlamaRMSNorm, "forward", _llama_rmsnorm_bf16),
        "encoder": lambda: patched(torch_hubert, "_layer_norm", _layer_norm_bf16),
        "whisper": lambda: patched(TW, "_ln", _layer_norm_bf16),
    }[case]()


def ode_state_in_bf16(dt: float):
    """Fault: the ODE state rounded to bf16 after each Euler step (the port
    keeps it in f32, as the JAX package's scan carry does)."""
    real = torch_cfm.ConditionalFlowMatchingModel._velocity

    def velocity(self, xt, *args, **kwargs):
        v = real(self, xt, *args, **kwargs)
        return ((xt + v * dt).to(BF16).float() - xt) / dt

    return patched(torch_cfm.ConditionalFlowMatchingModel, "_velocity", velocity)


# ---------------------------------------------------------------------------
# weights and the two sides
# ---------------------------------------------------------------------------


def draw(shapes, seed: int):
    """Weights for a JAX variable tree (its shapes, from ``jax.eval_shape``
    of the model's init), drawn with numpy from ``seed``: kernels N(0,
    1/fan-in), embeddings and random-feature weights N(0, 1), norm gains 1 +
    N(0, 0.01), biases N(0, 0.01). Every weight matters; activations and a
    vocoder's waveform are O(1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(s.shape).astype(np.float32)
        if len(s.shape) > 1:
            return z if name in ("embedding", "embed_positions") else z / np.sqrt(np.prod(s.shape[:-1]))
        if name in ("scale", "weight", "norm_scale"):
            return 1.0 + 0.1 * z
        return z if name == "weights" else 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _cast(params):
    return JAX_BF16.cast_params(params)


def _ports(cls, cfg, sd):
    """The port's model under BF16_INFERENCE and under FLOAT32, from one state dict."""
    out = []
    for policy in (BF16_INFERENCE, FLOAT32):
        model = cls(cfg, policy)
        model.load_state_dict(sd)
        out.append(model.eval())
    return out


def _jitted(fn, *args) -> dict:
    """A JAX block's output compiled as one program ("jit", the form the
    package runs), and the block itself ("fn", "args"): op by op, XLA's
    fusions round in other places (the script below prints the distance)."""
    return {"jit": np.asarray(jax.jit(fn)(*args), np.float32), "fn": fn, "args": args}


def _bf16_input(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------------------
# 1. the CFM velocity net and its ODE
# ---------------------------------------------------------------------------

CFM_KW = dict(vocab_size=50, dim_in=16, dim_cond_emb=24, hidden_size=64, depth=2, heads=2, intermediate_size=96,
              conv_pos_embed_kernel_size=7, conv_pos_embed_groups=16)
DT, TRUNC = 0.25, 1.0
# the ODE measure's velocity scale: the output projection times 2^-8 (exact in
# bf16), so each step moves the state by less than the state's own bf16 ulp
SLOW = 2.0**-8


def _cfm_inputs(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFM_KW["vocab_size"] + 1, (3, 24))
    ids[1, 17:] = 0
    ids[2, 9:] = 0
    x0 = rng.standard_normal((3, 24, CFM_KW["dim_in"])).astype(np.float32) * 1.2
    return ids, x0


def _cfm_block_inputs(seed):
    x = _bf16_input((2, 20, CFM_KW["hidden_size"]), seed + 1)
    t = np.random.default_rng(seed + 2).standard_normal((2, CFM_KW["hidden_size"])).astype(np.float32)
    return x, t, np.arange(20)[None, :] < np.array([[20], [13]])


def _port_sample(port, seed, scale=1.0):
    ids, x0 = _cfm_inputs(seed)
    w = port.to_pred.weight
    with torch.no_grad():
        w.mul_(scale)
        try:
            return port.sample(torch.from_numpy(ids), DT, TRUNC, x0=torch.from_numpy(x0))
        finally:
            w.div_(scale)


def _displacement(mel, mask, x0):
    """The state's change over the ODE, (x1 - clip(x0)) on valid frames."""
    cfg = torch_cfm.CFMConfig()
    return ((_np(mel) - cfg.mean) / cfg.std - np.clip(x0, -TRUNC, TRUNC))[np.asarray(mask)]


def _port_cfm_block(port, seed):
    x, t, mask = _cfm_block_inputs(seed)
    _, an, at, fn, ff = port.transformer.layers[0]
    xb, tt, mt = torch.from_numpy(x).to(BF16), torch.from_numpy(t), torch.from_numpy(mask)
    pos = torch_tr.rotary_frequencies(x.shape[1], CFM_KW["hidden_size"] // CFM_KW["heads"])
    with torch.no_grad():
        xb = at(an(xb, tt), mt, pos) + xb
        return ff(fn(xb, tt), mt) + xb


def build_cfm(seed):
    """The weights; the port under both policies; JAX's ``sample`` under
    BF16_INFERENCE (one compile, run with the output projection as drawn and
    × SLOW); the port's f32 runs; layer 0 of the JAX transformer (attention
    and feed-forward, each after its adaptive norm, each with its residual)."""
    cfg = jax_cfm.CFMConfig(**CFM_KW)
    ids8 = jnp.ones((1, 8), jnp.int32)
    init = jax_cfm.ConditionalFlowMatchingModel(cfg, policy=JAX_FLOAT32).init
    variables = draw(jax.eval_shape(lambda: init({"params": jax.random.key(0)}, ids8, jnp.zeros((1, 8, cfg.dim_in)), ids8,
                                                 rng=jax.random.key(1))), seed)
    f32_sd = cfm_state_dict(variables)
    port, port32 = _ports(torch_cfm.ConditionalFlowMatchingModel, torch_cfm.CFMConfig(**CFM_KW), f32_sd)
    ids, x0 = _cfm_inputs(seed)
    model = jax_cfm.ConditionalFlowMatchingModel(cfg, policy=JAX_BF16)
    sample = jax.jit(lambda v, i, x: model.apply(v, i, dt=DT, truncation_value=TRUNC, x0=x, method="sample"))
    runs = {}
    for name, scale in (("bf16", 1.0), ("slow_bf16", SLOW)):
        params = dict(variables["params"], to_pred={"kernel": variables["params"]["to_pred"]["kernel"] * scale})
        mel, mask = sample({"params": _cast(params), "buffers": variables["buffers"]}, jnp.asarray(ids), jnp.asarray(x0))
        runs[name] = (np.asarray(mel), np.asarray(mask))
    runs["f32"] = _port_sample(port32, seed)
    runs["slow_f32"] = _port_sample(port32, seed, SLOW)

    x, t, mask = _cfm_block_inputs(seed)
    h, heads = cfg.hidden_size, cfg.heads
    pos = jax_tr.rotary_frequencies(x.shape[1], h // heads)

    def block(p, xb, tj, mj):
        a = jax_tr.AdaptiveRMSNorm(h, JAX_BF16).apply({"params": p["layers_0_attn_norm"]}, xb, tj)
        xb = jax_tr.Attention(h, heads, 0.0, JAX_BF16, "xla").apply({"params": p["layers_0_attn"]}, a, mj, pos) + xb
        f = jax_tr.AdaptiveRMSNorm(h, JAX_BF16).apply({"params": p["layers_0_ff_norm"]}, xb, tj)
        ff = jax_tr.ConvFeedForward(h, cfg.intermediate_size, 0.0, policy=JAX_BF16)
        return (ff.apply({"params": p["layers_0_ff"]}, f, mj) + xb).astype(jnp.float32)

    jax_block = _jitted(block, _cast(variables["params"])["transformer"], jnp.asarray(x, jnp.bfloat16), jnp.asarray(t),
                        jnp.asarray(mask))
    return {"seed": seed, "port": port, "f32_sd": f32_sd, "runs": runs, "block": jax_block}


def cfm_measures(cfm) -> dict:
    seed, port, runs = cfm["seed"], cfm["port"], cfm["runs"]
    _, x0 = _cfm_inputs(seed)
    mel, mask = _port_sample(port, seed)
    slow, _ = _port_sample(port, seed, SLOW)
    np.testing.assert_array_equal(mask.numpy(), runs["bf16"][1])
    mask = mask.numpy()
    return {"block": ulp_share(_port_cfm_block(port, seed), cfm["block"]["jit"]),
            "model": model_ratio(mel, runs["bf16"][0], runs["f32"][0]),
            "ode": model_ratio(*(_displacement(m, mask, x0) for m in (slow, runs["slow_bf16"][0], runs["slow_f32"][0])))}


def cfm_faults(cfm):
    port, f32_sd = cfm["port"], cfm["f32_sd"]
    name = "transformer.layers.0.2.to_qkv.weight"
    return {
        "skip_cast": lambda: skip_cast(port, name, f32_sd[name]),
        "norm_in_bf16": lambda: norm_in_bf16("cfm"),
        "ode_state_in_bf16": lambda: ode_state_in_bf16(DT),
        "drop_bias": lambda: drop_bias(port, "transformer.layers.0.4.conv1.bias"),
    }


# ---------------------------------------------------------------------------
# 2. the HiFi-GAN generator, one stage at C = 32: the MRF route
# ---------------------------------------------------------------------------

VOC_KW = dict(model_in_dim=16, upsample_initial_channel=64, upsample_rates=(5,), upsample_kernel_sizes=(10,),
              resblock_kernel_sizes=(3, 7, 11), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)))
BRANCH_SHAPE = (2, 32, 120)  # one MRF branch's input, (B, C, T)


def _mel(seed):
    """The vocoder's input, the shape of case 1's mel (one compile serves both)."""
    return np.random.default_rng(seed + 4).standard_normal((3, 24, VOC_KW["model_in_dim"])).astype(np.float32) - 1.0


def build_vocoder(seed):
    """The weights; the port under both policies (its branches on K2's plain
    version); the JAX generator under BF16_INFERENCE on the same mel:
    ``generator_apply_fused`` with the Pallas MRF kernels in interpret mode
    (branches, and with stage fusion the stage kernel), and
    ``HifiGanGenerator.apply`` (the JAX composite's path off the TPU), each
    one compile; the port's f32 run; the first branch (K = 3) through the
    JAX branch kernel."""
    cfg = jax_hifigan.HifiGanConfig(**VOC_KW)
    init = jax_hifigan.HifiGanGenerator(cfg, policy=JAX_FLOAT32).init
    params = draw(jax.eval_shape(lambda: init(jax.random.key(2), jnp.zeros((1, 6, cfg.model_in_dim)))), seed + 3)["params"]
    f32_sd = hifigan_generator_state_dict(params)
    port, port32 = _ports(torch_hifigan.HifiGanGenerator, torch_hifigan.HifiGanConfig(**VOC_KW), f32_sd)
    with torch.no_grad():
        assert all(blk.route(torch.zeros(1, 1, 1)) == "reference" for blk in port.resblocks)  # K2's plain version
    mel, cast = jnp.asarray(_mel(seed)), _cast(params)
    kw = dict(compute_dtype=jnp.bfloat16, force_fused=True, interpret=True, mrf_fold=1)
    runs = {"fused": jax.jit(lambda p, m: jax_hifigan.generator_apply_fused(p, cfg, m, **kw))(cast, mel)}
    with JFM.mrf_stage_fusion(True):
        runs["stage"] = jax.jit(lambda p, m: jax_hifigan.generator_apply_fused(p, cfg, m, **kw))(cast, mel)
    apply = jax.jit(lambda p, m: jax_hifigan.HifiGanGenerator(cfg, policy=JAX_BF16).apply({"params": p}, m))
    runs["apply"] = apply(cast, mel)
    runs = {k: np.asarray(v, np.float32) for k, v in runs.items()}
    with torch.no_grad():
        runs["f32"] = port32(torch.from_numpy(_mel(seed)))

    bp = cast["resblocks_0"]
    stack = [jnp.stack([bp[f"{w}_{j}"][k] for j in range(3)]) for w, k in
             (("convs1", "kernel"), ("convs1", "bias"), ("convs2", "kernel"), ("convs2", "bias"))]
    x = jnp.asarray(_bf16_input(BRANCH_SHAPE, seed + 5), jnp.bfloat16).transpose(0, 2, 1)  # NWC
    out = JFM.mrf_branch_pallas(x, *stack, (1, 3, 5), interpret=True)
    block = {"jit": np.asarray(out.astype(jnp.float32)).transpose(0, 2, 1)}  # a kernel: one program either way
    return {"seed": seed, "port": port, "port32": port32, "f32_sd": f32_sd, "params": cast, "apply": apply, "runs": runs,
            "block": block}


def _port_branch(vocoder):
    with torch.no_grad():
        return vocoder["port"].resblocks[0](torch.from_numpy(_bf16_input(BRANCH_SHAPE, vocoder["seed"] + 5)).to(BF16))


def vocoder_measures(vocoder) -> dict:
    port, runs = vocoder["port"], vocoder["runs"]
    mel = torch.from_numpy(_mel(vocoder["seed"]))
    with torch.no_grad():
        wav = port(mel)
        with TFM.mrf_stage_fusion(True):
            staged = port(mel)
    return {"block": ulp_share(_port_branch(vocoder), vocoder["block"]["jit"]),
            "model": model_ratio(wav, runs["fused"], runs["f32"]),
            "model_vs_apply": model_ratio(wav, runs["apply"], runs["f32"]),
            "model_stage": model_ratio(staged, runs["stage"], runs["f32"])}


def vocoder_faults(vocoder):
    port, f32_sd = vocoder["port"], vocoder["f32_sd"]
    return {
        "skip_cast": lambda: skip_cast(port, "resblocks.0.convs1.0.weight", f32_sd["resblocks.0.convs1.0.weight"]),
        "drop_bias": lambda: drop_bias(port, "resblocks.0.convs1.0.bias"),
    }


# ---------------------------------------------------------------------------
# 3. the composite's synthesize: f32 waveforms, PCM16, mu-law
# ---------------------------------------------------------------------------


def build_composite(seed):
    """The port's composite of cases 1 and 2; the JAX composite's path off
    the TPU: case 1's ``sample`` then ``HifiGanGenerator.apply`` (case 2's
    compile), under BF16_INFERENCE; the port's f32 pair on the f32 mel."""
    cfm, vocoder = build("cfm", seed), build("vocoder", seed)
    want = np.asarray(vocoder["apply"](vocoder["params"], jnp.asarray(cfm["runs"]["bf16"][0])), np.float32)
    with torch.no_grad():
        f32 = vocoder["port32"](cfm["runs"]["f32"][0])
    return {"seed": seed, "cfm": cfm, "vocoder": vocoder, "want": want, "f32": f32,
            "port": ConditionalFlowMatchingWithHifiGan(cfm["port"], vocoder["port"], device="cpu")}


def composite_measures(composite) -> dict:
    """(a) for each of its two blocks: the CFM block's and the MRF branch's shares."""
    seed, cfm, vocoder, want = composite["seed"], composite["cfm"], composite["vocoder"], composite["want"]
    ids, x0 = _cfm_inputs(seed)

    def synthesize(**kw):
        return composite["port"].synthesize(ids, DT, TRUNC, x0=torch.from_numpy(x0), **kw)[0]

    wav, pcm, mu = synthesize(), synthesize(pcm16=True), synthesize(mulaw=True)
    want_pcm = np.asarray(jnp.round(jnp.clip(jnp.asarray(want), -1.0, 1.0) * 32767.0).astype(jnp.int16), np.int64)
    want_mu = np.asarray(jax_mulaw_encode(jnp.asarray(want)), np.int64)
    return {"cfm_block": ulp_share(_port_cfm_block(cfm["port"], seed), cfm["block"]["jit"]),
            "vocoder_block": ulp_share(_port_branch(vocoder), vocoder["block"]["jit"]),
            "model": model_ratio(wav, want, composite["f32"]),
            "pcm16_within_one_code": float(np.mean(np.abs(pcm.numpy().astype(np.int64) - want_pcm) <= 1)),
            "mulaw_within_one_code": float(np.mean(np.abs(mu.numpy().astype(np.int64) - want_mu) <= 1))}


def composite_faults(composite):
    return {**cfm_faults(composite["cfm"]), **{f"vocoder_{k}": v for k, v in vocoder_faults(composite["vocoder"]).items()}}


# ---------------------------------------------------------------------------
# 4. the speech encoder: HuBERT, K4's plain assignment, dedup
# ---------------------------------------------------------------------------

HUBERT_KW = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128, conv_dim=(32, 32, 32),
                 conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
ENC_LENGTHS = np.array([3200, 2500, 1400])
N_CENTERS = 50


def _wavs(seed):
    return np.random.default_rng(seed + 9).standard_normal((3, int(ENC_LENGTHS.max()))).astype(np.float32) * 0.1


def _frames(lengths):
    return np.array([torch_hubert.HubertConfig(**HUBERT_KW).num_frames(int(n)) for n in lengths])


def _hubert_block_input(seed):
    return _bf16_input((3, 30, HUBERT_KW["hidden_size"]), seed + 10), np.arange(30)[None, :] < np.array([[30], [22], [9]])


def build_encoder(seed):
    """The weights and centers; the port under both policies; JAX's
    features (layer 2) under BF16_INFERENCE and their units and dedup counts
    as the JAX ``SpeechEncoder`` makes them; the port's f32 features; JAX's
    layer 0."""
    cfg = jax_hubert.HubertConfig(**HUBERT_KW)
    init = jax_hubert.HubertEncoder(cfg, policy=JAX_FLOAT32).init
    params = draw(jax.eval_shape(lambda: init(jax.random.key(6), jnp.zeros((1, 800)))), seed + 7)["params"]
    f32_sd = hubert_state_dict(params)
    port, port32 = _ports(torch_hubert.HubertEncoder, torch_hubert.HubertConfig(**HUBERT_KW), f32_sd)
    centers = np.random.default_rng(seed + 8).standard_normal((N_CENTERS, cfg.hidden_size)).astype(np.float32)
    enc = jax_hubert.HubertEncoder(cfg, policy=JAX_BF16)
    feats = jax.jit(lambda p, w, n: enc.apply({"params": p}, w, output_layer=2, num_samples=n))(
        _cast(params), jnp.asarray(_wavs(seed)), jnp.asarray(ENC_LENGTHS))
    units = JaxQuantizer(jnp.asarray(centers))(feats)  # the JAX SpeechEncoder's steps after its tower
    runs = {"bf16": np.asarray(feats, np.float32), "units": np.asarray(units),
            "num_units": np.asarray(jax_dedup.deduplicate_batch(units, jnp.asarray(_frames(ENC_LENGTHS)))[2])}
    with torch.no_grad():
        runs["f32"] = port32(torch.from_numpy(_wavs(seed)), output_layer=2, num_samples=torch.from_numpy(ENC_LENGTHS))
    x, mask = _hubert_block_input(seed)
    layer = jax_hubert.HubertLayer(cfg, JAX_BF16, "xla")
    block = _jitted(lambda p, x, m: layer.apply({"params": p}, x, mask=m).astype(jnp.float32), _cast(params)["layers_0"],
                    jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask))
    return {"seed": seed, "port": port, "f32_sd": f32_sd, "centers": centers, "runs": runs, "block": block}


def encoder_measures(encoder) -> dict:
    seed, port, runs = encoder["seed"], encoder["port"], encoder["runs"]
    x, mask = _hubert_block_input(seed)
    with torch.no_grad():
        block = port.encoder.layers[0](torch.from_numpy(x).to(BF16), torch.from_numpy(mask))
        feats = port(torch.from_numpy(_wavs(seed)), output_layer=2, num_samples=torch.from_numpy(ENC_LENGTHS))
    n = _frames(ENC_LENGTHS)
    valid = np.arange(feats.shape[1])[None, :] < n[:, None]
    out = {"block": ulp_share(block, encoder["block"]["jit"], mask[..., None].repeat(x.shape[-1], -1)),
           "model": model_ratio(_np(feats)[valid], _np(runs["bf16"])[valid], _np(runs["f32"])[valid])}
    for dedup in (False, True):
        se = SpeechEncoder(encoder=port, quantizer=KMeansQuantizer(torch.from_numpy(encoder["centers"])), output_layer=2,
                           deduplicate=dedup)
        ours = se(_wavs(seed), lengths=ENC_LENGTHS)
        if not dedup:
            out["units_equal"] = float(np.mean((ours["units"].numpy() == runs["units"])[valid]))
        else:
            out["dedup_num_units_diff"] = int(np.abs(ours["num_units"].numpy() - runs["num_units"]).max())
    return out


def encoder_faults(encoder):
    port, f32_sd = encoder["port"], encoder["f32_sd"]
    name = "encoder.layers.0.feed_forward.intermediate_dense.weight"
    return {
        "skip_cast": lambda: skip_cast(port, name, f32_sd[name]),
        "norm_in_bf16": lambda: norm_in_bf16("encoder"),
        "drop_bias": lambda: drop_bias(port, "encoder.layers.0.attention.q_proj.bias"),
    }


# ---------------------------------------------------------------------------
# 5. Llama: logits, the sLM21 sequence log-probability, greedy tokens
# ---------------------------------------------------------------------------

LM_KW = dict(vocab_size=200, hidden_size=128, intermediate_size=256, num_hidden_layers=4, num_attention_heads=2)
LM_NEW_TOKENS = 12


def _lm_ids(seed):
    ids = np.random.default_rng(seed + 13).integers(2, LM_KW["vocab_size"], (4, 32))
    ids[1, 25:] = 0
    ids[3, 12:] = 0
    return ids


def _llama_block_input(seed):
    return _bf16_input((2, 24, LM_KW["hidden_size"]), seed + 14), np.arange(24)[None, :] < np.array([[24], [17]])


def _port_logits(model, ids):
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(ids != 0))
    return logits, TL.sequence_pseudo_log_prob(logits, torch.from_numpy(ids)).numpy()


def build_llama(seed):
    """The weights; the port under both policies; JAX's logits, sLM21
    log-probabilities and greedy tokens under BF16_INFERENCE; the port's f32
    logits; JAX's layer 0."""
    cfg = JL.LlamaConfig(**LM_KW)
    model = JL.LlamaLM(cfg, policy=JAX_BF16, attn_implementation="xla")
    params = draw(jax.eval_shape(lambda: model.init(jax.random.key(11), jnp.zeros((1, 4), jnp.int32))), seed + 12)["params"]
    f32_sd = llama_state_dict(params)
    port, port32 = _ports(TL.LlamaLM, TL.LlamaConfig(**LM_KW), f32_sd)
    ids, cast = _lm_ids(seed), _cast(params)
    logits = jax.jit(lambda p, i: model.apply({"params": p}, i, attention_mask=i != 0)[0])(cast, jnp.asarray(ids))
    runs = {"bf16": np.asarray(logits, np.float32), "logprob_bf16": np.asarray(JL.sequence_pseudo_log_prob(logits, jnp.asarray(ids))),
            "greedy": np.asarray(JL.greedy_decode(model, {"params": cast}, jnp.asarray(ids[:, :8]), LM_NEW_TOKENS, 1))}
    runs["f32"], runs["logprob_f32"] = _port_logits(port32, ids)
    x, mask = _llama_block_input(seed)
    rope = JL._rope_tables(jnp.arange(x.shape[1]), cfg.head_dim, cfg.rope_theta)
    layer = JL.LlamaLayer(cfg, JAX_BF16, "xla")
    block = _jitted(lambda p, x, m: layer.apply({"params": p}, x, rope, m)[0].astype(jnp.float32), cast["layers_0"],
                    jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask))
    return {"seed": seed, "config": cfg, "port": port, "f32_sd": f32_sd, "runs": runs, "block": block}


def llama_measures(llama) -> dict:
    seed, port, runs, cfg = llama["seed"], llama["port"], llama["runs"], llama["config"]
    ids = _lm_ids(seed)
    x, mask = _llama_block_input(seed)
    with torch.no_grad():
        rope = TL._rope_tables(torch.arange(x.shape[1]), cfg.head_dim, cfg.rope_theta)
        block = port.model.layers[0](torch.from_numpy(x).to(BF16), rope, torch.from_numpy(mask))
        greedy = TL.greedy_decode(port, torch.from_numpy(ids[:, :8]), LM_NEW_TOKENS, 1)
    logits, logprob = _port_logits(port, ids)
    valid = ids != 0
    top = logits.argmax(-1).numpy() == runs["bf16"].argmax(-1)
    return {"block": ulp_share(block, llama["block"]["jit"]),
            "model": model_ratio(_np(logits)[valid], _np(runs["bf16"])[valid], _np(runs["f32"])[valid]),
            "logprob_ratio": model_ratio(logprob, runs["logprob_bf16"], runs["logprob_f32"]),
            "argmax_equal": float(top[valid].mean()),
            "greedy_equal": float(np.mean(greedy.numpy()[:, 8:] == runs["greedy"][:, 8:]))}


def llama_faults(llama):
    port, f32_sd = llama["port"], llama["f32_sd"]
    name = "model.layers.0.self_attn.q_proj.weight"
    return {
        "skip_cast": lambda: skip_cast(port, name, f32_sd[name]),
        "norm_in_bf16": lambda: norm_in_bf16("llama"),
    }


# ---------------------------------------------------------------------------
# 6. the scorers: Whisper (encoder states, decoder logits) and UTMOS (the MOS)
# ---------------------------------------------------------------------------

WHISPER_KW = dict(vocab_size=96, num_mel_bins=16, d_model=128, encoder_layers=2, encoder_attention_heads=2, decoder_layers=2,
                  decoder_attention_heads=2, encoder_ffn_dim=256, decoder_ffn_dim=256, max_source_positions=50,
                  max_target_positions=40, decoder_start_token_id=90, eos_token_id=91)
UTMOS_LENGTHS = [16000, 12000, 8000]


def _whisper_inputs(seed):
    rng = np.random.default_rng(seed + 15)
    mel = rng.standard_normal((2, 2 * WHISPER_KW["max_source_positions"], WHISPER_KW["num_mel_bins"])).astype(np.float32)
    return mel, rng.integers(0, WHISPER_KW["vocab_size"], (2, 9))


def _utmos_inputs(seed):
    rng = np.random.default_rng(seed + 18)
    wav = np.zeros((3, max(UTMOS_LENGTHS)), np.float32)
    for i, n in enumerate(UTMOS_LENGTHS):
        wav[i, :n] = rng.standard_normal(n).astype(np.float32) * 0.1
    return wav, np.array([0, 1, 2]), np.array([3, 0, 9])  # domain and judge ids


def _port_scores(whisper, utmos, seed):
    mel, ids = _whisper_inputs(seed)
    wav, dom, judge = _utmos_inputs(seed)
    with torch.no_grad():
        frames = utmos(torch.from_numpy(wav), torch.from_numpy(dom), torch.from_numpy(judge), torch.tensor(UTMOS_LENGTHS))
        return {"enc": whisper.encode(torch.from_numpy(mel)), "logits": whisper(torch.from_numpy(mel), torch.from_numpy(ids)),
                "frames": frames, "mos": utmos.score_from_frames(frames, utmos.config.ssl.num_frames(torch.tensor(UTMOS_LENGTHS)))}


def build_scorers(seed):
    """The weights of a JAX Whisper and of UTMOS (``tests/test_utmos.py``'s
    tiny tower); the port's copies under both policies; JAX's encoder
    states, decoder logits, UTMOS frame scores and MOS under BF16_INFERENCE;
    the port's f32 ones; JAX's Whisper encoder layer 0."""
    wcfg = JW.WhisperConfig(**WHISPER_KW)
    mel, ids = _whisper_inputs(seed)
    jw = JW.WhisperForASR(wcfg, policy=JAX_BF16, attn_implementation="xla")
    wp = draw(jax.eval_shape(lambda: jw.init(jax.random.key(16), jnp.asarray(mel[:1]), jnp.zeros((1, 3), jnp.int32))),
              seed + 17)["params"]
    whisper_sd = whisper_state_dict(wp)
    whisper, whisper32 = _ports(TW.WhisperForASR, TW.WhisperConfig(**WHISPER_KW), whisper_sd)
    ucfg = JU.UTMOSConfig(ssl=tiny_ssl_cfg(), num_judges=16, domain_dim=16, judge_dim=16, lstm_hidden=16, projection_hidden=32,
                          default_judge_id=3)
    wav, dom, judge = _utmos_inputs(seed)
    ju = JU.UTMOSPredictor(ucfg, policy=JAX_BF16, attn_implementation="xla")
    up = draw(jax.eval_shape(lambda: ju.init(jax.random.key(20), jnp.asarray(wav[:1, :1600]), jnp.asarray(dom[:1]),
                                             jnp.asarray(judge[:1]))), seed + 21)["params"]
    utmos_sd = utmos_state_dict(up)
    utmos, utmos32 = _ports(TU.UTMOSPredictor, TU.config_from_state_dict(utmos_sd), utmos_sd)

    def jax_scores(pw, pu, m, i, w, d, j):
        return (jw.apply({"params": pw}, m, method="encode"), jw.apply({"params": pw}, m, i),
                ju.apply({"params": pu}, w, d, j, num_samples=jnp.asarray(UTMOS_LENGTHS)))

    enc, logits, frames = jax.jit(jax_scores)(_cast(wp), _cast(up), jnp.asarray(mel), jnp.asarray(ids, jnp.int32),
                                              jnp.asarray(wav), jnp.asarray(dom), jnp.asarray(judge))
    n_frames = jnp.asarray([JU.config_from_params(up).ssl.num_frames(n) for n in UTMOS_LENGTHS])
    runs = {"enc_bf16": np.asarray(enc, np.float32), "logits_bf16": np.asarray(logits, np.float32),
            "frames_bf16": np.asarray(frames, np.float32),
            "mos_bf16": np.asarray(JU.UTMOSPredictor.score_from_frames(frames, n_frames), np.float32),
            "valid": np.arange(frames.shape[1])[None, :] < np.asarray(n_frames)[:, None]}
    runs.update({f"{k}_f32": v for k, v in _port_scores(whisper32, utmos32, seed).items()})
    x = _bf16_input((2, 50, WHISPER_KW["d_model"]), seed + 19)
    layer = JW.WhisperEncoderLayer(wcfg, JAX_BF16, "xla")
    block = _jitted(lambda p, x: layer.apply({"params": p}, x).astype(jnp.float32), _cast(wp)["encoder"]["layers_0"],
                    jnp.asarray(x, jnp.bfloat16))
    return {"seed": seed, "whisper": whisper, "whisper_sd": whisper_sd, "utmos": utmos, "runs": runs, "block": block,
            "block_input": x}


def scorers_measures(scorers) -> dict:
    runs, valid = scorers["runs"], scorers["runs"]["valid"]
    with torch.no_grad():
        block = scorers["whisper"].model.encoder.layers[0](torch.from_numpy(scorers["block_input"]).to(BF16))
    port = _port_scores(scorers["whisper"], scorers["utmos"], scorers["seed"])
    return {"block": ulp_share(block, scorers["block"]["jit"]),
            "encoder": model_ratio(port["enc"], runs["enc_bf16"], runs["enc_f32"]),
            "logits": model_ratio(port["logits"], runs["logits_bf16"], runs["logits_f32"]),
            "utmos": model_ratio(_np(port["frames"])[valid], runs["frames_bf16"][valid], _np(runs["frames_f32"])[valid]),
            "mos_abs_diff": float(np.abs(_np(port["mos"]) - runs["mos_bf16"]).max())}


def scorers_faults(scorers):
    whisper, whisper_sd = scorers["whisper"], scorers["whisper_sd"]
    name = "model.encoder.layers.0.fc1.weight"
    return {
        "skip_cast": lambda: skip_cast(whisper, name, whisper_sd[name]),
        "norm_in_bf16": lambda: norm_in_bf16("whisper"),
        "drop_bias": lambda: drop_bias(whisper, "model.encoder.layers.0.self_attn.q_proj.bias"),
        "utmos_norm_in_bf16": lambda: norm_in_bf16("encoder"),
    }


# ---------------------------------------------------------------------------
# the cases, their sound measures and their planted faults
# ---------------------------------------------------------------------------

BUILDERS = {"cfm": build_cfm, "vocoder": build_vocoder, "composite": build_composite, "encoder": build_encoder,
            "llama": build_llama, "scorers": build_scorers}
CASES = {
    "cfm": (cfm_measures, cfm_faults),
    "vocoder": (vocoder_measures, vocoder_faults),
    "composite": (composite_measures, composite_faults),
    "encoder": (encoder_measures, encoder_faults),
    "llama": (llama_measures, llama_faults),
    "scorers": (scorers_measures, scorers_faults),
}


@functools.lru_cache(maxsize=None)
def build(case: str, seed: int = 0) -> dict:
    """A case's weights, ports and JAX runs for ``seed``, built once."""
    return BUILDERS[case](seed)


def case_parts(case: str, seed: int = 0):
    """(the case's measures as a function of no argument, its faults by name)."""
    measures, faults = CASES[case]
    built = build(case, seed)
    return lambda: measures(built), faults(built)


def crossed(case: str, m: dict) -> list:
    return [k for k, limit in LIMITS[case].items() if m[k] > limit]


@pytest.mark.parametrize("case", list(CASES))
def test_sound_port_within_the_limits_and_each_planted_fault_crosses_one(case):
    measure, faults = case_parts(case)
    m = measure()
    assert not crossed(case, m), m
    for fault, plant in faults.items():
        if (case, fault) in NOT_SEEN:
            continue
        with plant():
            f = measure()
        assert crossed(case, f), (fault, f)


if __name__ == "__main__":
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("cases", nargs="*", default=list(CASES))
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = parser.parse_args()
    torch.set_num_threads(1)
    for case in args.cases:  # JAX against itself: its block compiled and op by op
        block = build(case, args.seeds[0])["block"] if case != "composite" else None
        if block and "fn" in block:
            eager = np.asarray(block["fn"](*block["args"]), np.float32)
            print(json.dumps({"case": case, "jax_block_eager_vs_jit": ulp_share(eager, block["jit"])}), flush=True)
    for case in args.cases:
        sound, faulty = {}, {}
        for seed in args.seeds:
            measure, faults = case_parts(case, seed)
            m = measure()
            print(json.dumps({"case": case, "seed": seed, "limits": LIMITS[case], "sound": m}), flush=True)
            for k, v in m.items():
                sound[k] = max(sound.get(k, -np.inf), v)
            for fault, plant in faults.items():
                with plant():
                    f = measure()
                print(json.dumps({"case": case, "seed": seed, "fault": fault, **f}), flush=True)
                for k in LIMITS[case]:
                    faulty.setdefault(fault, {})[k] = min(faulty.get(fault, {}).get(k, np.inf), f[k])
        print(json.dumps({"case": case, "seeds": args.seeds, "sound_max": sound, "fault_min": faulty}), flush=True)
