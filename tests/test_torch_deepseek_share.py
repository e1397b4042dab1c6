"""DeepSeek-V2 at one device's share of an expert-parallel layer, on the
CPU at small sizes with seeded weights, against the benchmark's plain
reference (``cardbench/reference/mla_moe.py``): group-limited routing
over every routed expert, the held experts' shares adding up to the uncut
layer, prefill then the absorbed MLA decode through the latent cache
against the reference's full forward, YaRN's frequencies and softmax
scale, and the flash-attention kernel's plain version at MLA's widths
(q·k at depth 192, v of width 128).
"""
import dataclasses
import math
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from cardbench import spec, weights  # noqa: E402
from cardbench.reference import mla_moe as ref  # noqa: E402
from cardbench.reference.precision import Precision  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402

FP32 = Precision("fp32")

# DeepSeek-V2's kinds at CPU widths: 8 groups of 4 routed experts, 6 a
# token from the 3 best groups, scores x 16, 2 shared experts, MLA with a
# q-LoRA and YaRN (factor 40, mscale 0.707), one leading dense layer
ARCH = {"name": "ds-small", "family": "moe", "n_layers": 3, "d_model": 64,
        "n_heads": 4, "n_kv_heads": 4, "d_ff": 96, "vocab": 256,
        "d_head": 32, "rope_theta": 10000.0, "norm_eps": 1e-6,
        "tie_embeddings": False, "moe": True, "n_experts": 32,
        "experts_per_tok": 6, "n_shared_experts": 2, "moe_d_ff": 48,
        "mla": True, "kv_lora_rank": 64, "q_lora_rank": 48,
        "rope_head_dim": 16, "dtype": "float32", "first_dense": 1,
        "router_experts": 32, "expert_offset": 0, "n_group": 8,
        "topk_group": 3, "routed_scaling": 16.0,
        "yarn_factor": 40.0, "yarn_original_max": 4096,
        "yarn_beta_fast": 32.0, "yarn_beta_slow": 1.0, "yarn_mscale": 0.707,
        "yarn_mscale_all_dim": 0.707}
LAYOUT = spec.layout({"layout": "mla_moe"})


def params_of(arch: dict, seed: int):
    return weights.make(arch, seed, "cpu", None, LAYOUT)


def share_of(p: dict, offset: int, n: int) -> dict:
    """The MoE parameters a device holding experts ``[offset, offset +
    n)`` has: the whole router and shared experts, its experts' slices."""
    return dict(p, experts={k: w[offset:offset + n]
                            for k, w in p["experts"].items()})


def test_routing_is_the_references_group_limited_greedy():
    """The experts and weights of the port's routing are the reference's,
    every chosen expert lies in one of the 3 best groups (by each group's
    best score), and each weight is its softmax score times 16."""
    cfg = ArchConfig(**ARCH)
    p = params_of(ARCH, 5)["layers"][1]["moe"]
    x = torch.randn(96, ARCH["d_model"], generator=torch.Generator()
                    .manual_seed(1))
    scores, idx, w = L.group_limited_route(p, cfg, x)
    ref_idx, ref_w = ref.route(p["router"], x, ARCH, FP32)
    assert torch.equal(idx, ref_idx)
    torch.testing.assert_close(w, ref_w, rtol=1e-6, atol=0)
    torch.testing.assert_close(w, torch.gather(scores, 1, idx) * 16.0,
                               rtol=0, atol=0)
    best_groups = torch.topk(scores.view(96, 8, 4).amax(-1), 3).indices
    assert all(set((idx[t] // 4).tolist()) <= set(best_groups[t].tolist())
               for t in range(96))
    # the group mask bites: some token's 6 best experts overall are not
    # the 6 it is routed to
    assert not torch.equal(torch.topk(scores, 6).indices.sort(-1).values,
                           idx.sort(-1).values)


def test_held_shares_add_up_to_the_uncut_layer():
    """Eight devices' shares of 4 experts each (``expert_offset`` 0, 4, ..,
    28), the shared experts counted once, add up to the reference's whole
    layer over all 32; a share's tokens are routed over all 32 and no
    pair is dropped."""
    p = params_of(ARCH, 7)["layers"][1]["moe"]
    x = torch.randn(2, 40, ARCH["d_model"], generator=torch.Generator()
                    .manual_seed(2))
    whole = ref.moe(p, x, ARCH, FP32)
    shared = ref.mlp(p["shared"], x.reshape(80, -1), FP32).view(2, 40, -1)
    total = shared.clone()
    for offset in range(0, 32, 4):
        cfg = ArchConfig(**dict(ARCH, n_experts=4, expert_offset=offset))
        with torch.no_grad():
            total += L.moe_held_apply(share_of(p, offset, 4), cfg, x) - shared
    torch.testing.assert_close(total, whole, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("index", ["int", "tensor"])
@pytest.mark.parametrize("widths", [(32, 16), (128, 64)],
                         ids=["reduced", "published_heads"])
def test_prefill_then_absorbed_decode_gives_the_references_logits(widths,
                                                                  index):
    """The port's serving path (prefill of 10 tokens, then 6 decode steps
    through the whole latent cache in the absorbed form, at an int
    position or at a 0-d tensor one, as a CUDA graph steps) gives, in
    fp32, the logits of the reference's full forward at every served
    position; at the published head widths (q·k 192, v 128) the prefill
    goes through the flash-attention kernel's plain version."""
    dh, rd = widths
    arch = dict(ARCH, d_head=dh, rope_head_dim=rd)
    cfg = ArchConfig(**arch)
    params = params_of(arch, 11)
    tokens = torch.randint(0, arch["vocab"], (2, 16),
                           generator=torch.Generator().manual_seed(3))
    prompt, steps = 10, 6
    launched = ops.launch_counts()["flash_attention"]
    with torch.no_grad():
        caches = M.init_cache(cfg, 2, prompt + steps, "cpu")
        logits, caches = M.prefill(cfg, params, tokens[:, :prompt], caches)
        got = [logits[:, 0]]
        for i in range(steps - 1):
            at = prompt + i if index == "int" else torch.tensor(prompt + i)
            logits, caches = M.decode_step(cfg, params, tokens[:, prompt + i],
                                           at, caches)
            got.append(logits)
        want = ref.position_logits(params, tokens,
                                   torch.arange(prompt - 1, prompt + steps - 1),
                                   arch, FP32)
    torch.testing.assert_close(torch.stack(got, 1), want, rtol=1e-4,
                               atol=1e-4)
    assert ops.launch_counts()["flash_attention"] == launched   # the CPU


def test_the_decode_step_reads_only_the_latent_cache():
    """A decode step's MLA counts the latent and rope cache it reads, all
    of its slots at any index (the absorbed form attends over the whole
    cache under the mask, so that it reads no index on the host), and
    makes no key or value of the cache's length; a prefill counts the keys
    and values it makes of the prompt."""
    from repro_torch import spans
    arch = dict(ARCH, d_head=128, rope_head_dim=64)
    cfg = ArchConfig(**arch)
    params = params_of(arch, 13)
    tokens = torch.randint(0, arch["vocab"], (2, 9))
    with torch.no_grad(), spans.recording() as rec:
        caches = M.init_cache(cfg, 2, 12, "cpu")
        with spans.span("serve.prefill"):
            _, caches = M.prefill(cfg, params, tokens[:, :8], caches)
        with spans.span("serve.decode_step"):
            M.decode_step(cfg, params, tokens[:, 8], 8, caches)
    got = {(c["span"], c["name"]): c["value"] for c in rec.counters()}
    by_name = {s["id"]: s["name"] for s in rec.spans()}
    counts = {(by_name[sid], name): v for (sid, name), v in got.items()}
    layers, item = 3, 4
    assert counts[("serve.decode_step", "mla.cache_bytes")] == \
        layers * 2 * 12 * (64 + 64) * item
    assert counts[("serve.prefill", "mla.cache_bytes")] == \
        layers * 2 * 8 * 4 * (2 * 128 + 64) * item
    assert {"moe", "moe.route", "moe.experts", "moe.shared", "mla",
            "mla.prefill_attn", "mla.decode_attn"} <= set(by_name.values())


def test_absorbed_decode_sums_its_scores_in_fp32():
    """In bf16 the absorbed decode keeps its scores in fp32, as the
    flash-attention kernel and the up-projecting path do: with rope keys
    that share a large part (scores of some 70 that differ by about 1,
    where bf16 would round each by up to 0.25) it gives what the same
    step gives on the same values in fp32, to bf16's rounding of the
    output."""
    g = torch.Generator().manual_seed(5)
    b, h, dh, r, rd, n = 2, 4, 32, 64, 16, 40
    p = {"w_uk": torch.randn(r, h * dh, generator=g) / dh ** 0.5,
         "w_uv": torch.randn(r, h * dh, generator=g) / r ** 0.5}
    q_nope = torch.randn(b, 1, h, dh, generator=g)
    q_rope = torch.randn(b, 1, h, rd, generator=g)
    cl = torch.randn(b, n, r, generator=g)
    cr = (torch.randn(1, 1, rd, generator=g) * 30
          + torch.randn(b, n, rd, generator=g) * 0.3)
    args = (q_nope, q_rope, cl, cr)
    got = L._mla_absorbed({k: w.bfloat16() for k, w in p.items()},
                          *(t.bfloat16() for t in args), n - 1, 1.0)
    want = L._mla_absorbed({k: w.bfloat16().float() for k, w in p.items()},
                           *(t.bfloat16().float() for t in args), n - 1,
                           1.0)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=3e-2)


def test_yarn_frequencies_and_softmax_scale_follow_the_formulas():
    """``inv_freq = f_e m + f_e / 40 (1 - m)`` with ``m`` 1 less the ramp
    from floor(c(32)) to ceil(c(1)), ``c(n) = 64 ln(4096 / (2 pi n)) / (2
    ln 10000)``; the softmax scale ``192^-1/2 g(40, 0.707)^2``, ``g(s, m)
    = 0.1 m ln s + 1``, about 1.5896 / sqrt(192); cos and sin unscaled."""
    cfg = ArchConfig(**dict(ARCH, d_head=128, rope_head_dim=64))
    i = np.arange(32)
    f_e = 1.0 / 10000 ** (2 * i / 64)

    def c(n):
        return 64 * math.log(4096 / (2 * math.pi * n)) / (2 * math.log(10000))
    lo, hi = math.floor(c(32)), math.ceil(c(1))
    assert (lo, hi) == (10, 23)
    m = 1 - np.clip((i - lo) / (hi - lo), 0, 1)
    want = f_e * m + f_e / 40 * (1 - m)
    freqs, mscale = L.mla_rope(cfg)
    np.testing.assert_allclose(freqs.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(ref.rope_frequencies(dataclasses.asdict(cfg))
                               .numpy(), want, rtol=1e-12)
    assert mscale == 1.0
    g = 0.1 * 0.707 * math.log(40) + 1
    assert L.mla_softmax_scale(cfg) == pytest.approx(g * g / math.sqrt(192))
    assert g * g == pytest.approx(1.5896, abs=1e-4)
    plain = ArchConfig(**dict(ARCH, yarn_factor=0.0))
    assert L.mla_softmax_scale(plain) == 1 / math.sqrt(48)
    assert torch.equal(L.mla_rope(plain)[0], L.rope_freqs(16, 10000.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_at_mla_widths_is_an_einsum(dtype, causal):
    """q and k at depth 192, v at width 128: the plain version of the
    kernel is a masked softmax over q·kᵀ·scale times v, [H, Sq, 128]."""
    g = torch.Generator().manual_seed(4)
    q, k = (torch.randn(3, 20, 192, generator=g).to(dtype) for _ in "qk")
    v = torch.randn(3, 20, 128, generator=g).to(dtype)
    got = ops.flash_attention(q, k, v, causal=causal, scale=0.11)
    lg = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * 0.11
    if causal:
        lg = lg.masked_fill(torch.ones(20, 20).tril() == 0, -math.inf)
    want = torch.einsum("hqk,hkd->hqd", lg.softmax(-1), v.float())
    assert got.shape == (3, 20, 128) and got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert ops.flash_attention_takes(192, 128, dtype, "cpu")
    assert ops.flash_attention_takes(192, 128, torch.bfloat16, "cuda")
    assert not ops.flash_attention_takes(192, 128, torch.float32, "cuda")
    assert not ops.flash_attention_takes(48, 32, dtype, "cpu")
