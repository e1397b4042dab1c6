"""``chip_smoke.py`` on the CPU: its pinned reference constants against the
JAX package, and its kernel replays rehearsed at "tiny" scale, where
``ops`` takes the kernels' plain versions (the card runs them at "paper"
through the CUDA kernels)."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro.sim import simulate as repro_simulate  # noqa: E402
from repro.workloads import get_trace as repro_get_trace  # noqa: E402
from repro.workloads import run_numeric as repro_run_numeric  # noqa: E402
from repro import workloads as repro_workloads  # noqa: E402
from repro_torch import workloads  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

LABELS = [label for label, _, _ in chip_smoke.replay_plan({}, "tiny", "cpu")]


def test_reference_covers_every_ported_workload():
    assert set(chip_smoke.REFERENCE) == set(workloads.WORKLOADS)


@pytest.mark.parametrize("name", sorted(chip_smoke.REFERENCE))
def test_reference_constants_are_the_jax_packages(name):
    want = chip_smoke.REFERENCE[name]
    trace = repro_get_trace.__wrapped__(name, "paper")      # a fresh trace
    assert trace.characterize().as_row() == want["row"]
    assert (repro_simulate(trace, "conduit").makespan_ns
            == want["conduit_makespan_ns"])
    out = repro_run_numeric(name, "paper")
    if name == "llm_train":               # a tolerance, not a digest
        loss, new = out
        params = repro_workloads.WORKLOADS[name].make_inputs("paper")[0]
        l1 = sum(float(np.abs(np.asarray(a, np.float64)
                              - np.asarray(b, np.float64)).sum())
                 for a, b in zip(jax.tree_util.tree_leaves(new),
                                 jax.tree_util.tree_leaves(params)))
        tol = chip_smoke.TRAIN_TOL
        assert abs(float(loss) - want["loss"]) <= tol["loss"]
        assert abs(l1 - want["step_l1"]) <= tol["step_l1_rtol"] * l1
        return
    outs = out if isinstance(out, tuple) else (out,)
    assert (chip_smoke.output_digest([np.asarray(o) for o in outs])
            == want["numeric_sha256"])


def test_llm_train_step_on_the_cpu_is_within_the_smoke_tolerance():
    """Phase 4's check of llm_train, made on the port's CPU run."""
    inputs = workloads.make_inputs("llm_train", "paper", device="cpu")
    loss, new = workloads.run_numeric("llm_train", "paper", device="cpu")
    want, tol = chip_smoke.REFERENCE["llm_train"], chip_smoke.TRAIN_TOL
    assert abs(float(loss) - want["loss"]) <= tol["loss"]
    l1 = chip_smoke.step_l1(new, inputs[0])
    assert abs(l1 - want["step_l1"]) <= tol["step_l1_rtol"] * want["step_l1"]


def test_llm_train_pipeline_on_the_cpu():
    """Phase 4's trace checks of llm_train, made on the port's own trace:
    the Table 3 row and the conduit makespan of the JAX package's."""
    want = chip_smoke.REFERENCE["llm_train"]
    trace = workloads.get_trace("llm_train", "paper", device="cpu")
    assert trace.characterize().as_row() == want["row"]
    assert (chip_smoke.simulate(trace, "conduit").makespan_ns
            == want["conduit_makespan_ns"])


def test_mix_reference_is_the_jax_packages():
    from repro import sim as repro_sim
    traces = [repro_get_trace(n, "paper") for n in chip_smoke.MIX_WORKLOADS]
    assert (chip_smoke.mix_counters(repro_sim, traces)
            == chip_smoke.MIX_REFERENCE)


def test_mix_phase_on_the_ports_traces():
    """As the smoke runs it: on the cached traces that phase 4 has already
    simulated (a run resets the page table it starts from)."""
    traces = [workloads.get_trace(n, "paper", device="cpu")
              for n in chip_smoke.MIX_WORKLOADS]
    for tr in traces:
        chip_smoke.simulate(tr, "bw")
    before = ops.launch_counts()
    got = chip_smoke.mix_counters(chip_smoke.torch_sim, traces)
    assert got == chip_smoke.MIX_REFERENCE
    assert ops.launch_counts() == before
    assert got["gc_invocations"] > 0 and got["blocks_erased"] > 0


# -- phase 8: open-loop serving, saturation, fleets, analysis -----------------

def _open_loop_steps(sim_module, port, **reduced):
    names = [name for name, _ in chip_smoke.OPEN_LOOP_CATALOG]
    scale = "tiny" if reduced else "paper"
    if port:
        traces = {n: workloads.get_trace(n, scale, device="cpu")
                  for n in names}
    else:
        traces = {n: repro_get_trace(n, scale) for n in names}
    return chip_smoke.open_loop_steps(sim_module, traces, **reduced)


@pytest.fixture(scope="module")
def open_loop_reference():
    """The JAX package's digests for every pinned open-loop result (the
    batched search is held to the scalar ones on the card, not pinned)."""
    from repro import sim as repro_sim
    got = {}
    for label, run in _open_loop_steps(repro_sim, port=False):
        if label != "batched_find_saturation":
            got.update(run()[1])
    return got


def test_open_loop_reference_is_the_jax_packages(open_loop_reference):
    assert open_loop_reference == chip_smoke.OPEN_LOOP_REFERENCE


def test_open_loop_phase_rehearsed_on_the_cpu():
    """Phase 8 at a reduced size (tiny traces, 16 sessions, a shorter
    churn): every result the port makes on its own traces has the digest
    the JAX package's run has on its own, the batched search equals the
    scalar ones, and no kernel is called."""
    from repro import sim as repro_sim
    reduced = dict(n_sessions=16, fleet_churn=300)
    before = ops.launch_counts()
    got, want = {}, {}
    for label, run in _open_loop_steps(chip_smoke.torch_sim, True,
                                       **reduced):
        got.update(run()[1])
    for label, run in _open_loop_steps(repro_sim, False, **reduced):
        if label != "batched_find_saturation":
            want.update(run()[1])
    assert got == want
    assert set(got) == set(chip_smoke.OPEN_LOOP_REFERENCE)
    assert ops.launch_counts() == before


def test_plain_tells_results_apart_by_every_field():
    from repro_torch import sim
    a = sim.SaturationResult("conduit", 1.0, 2.0, (2.0, 3.0), [])
    b = sim.SaturationResult("conduit", 1.0, 2.0, (2.0, 3.0000000000000004),
                             [])
    assert chip_smoke.plain(a) != chip_smoke.plain(b)
    assert chip_smoke.result_digest(a) != chip_smoke.result_digest(b)
    assert chip_smoke.plain(sim.SessionState.COMPLETED) == "completed"
    with pytest.raises(TypeError, match="no plain form"):
        chip_smoke.plain(object())


@pytest.fixture(scope="module")
def tiny_numeric():
    return {name: workloads.run_numeric(name, "tiny", device="cpu")
            for name in workloads.WORKLOADS}


@pytest.mark.parametrize("label", LABELS)
def test_replay_equals_the_numeric_run_on_the_cpu(label, tiny_numeric):
    (replay, want_counts), = [(r, c) for lab, r, c in chip_smoke.replay_plan(
        tiny_numeric, "tiny", "cpu") if lab == label]
    before = ops.launch_counts()
    got, want = replay()
    assert got.device.type == "cpu"
    assert torch.equal(got, want)
    assert ops.launch_counts() == before           # plain versions only
    assert any(want_counts.values())


def test_llm_train_replay_makes_three_gemms_a_product(tiny_numeric,
                                                      monkeypatch):
    """On the CPU the wrapper takes the plain version and counts nothing;
    the calls themselves are counted here: one forward and two backward
    GEMMs for each of the 7 n_layers + 1 products, at their shapes."""
    (replay, want_counts), = [
        (r, c) for lab, r, c in chip_smoke.replay_plan(
            tiny_numeric, "tiny", "cpu") if lab == "llm_train int8 GEMMs"]
    shapes = []
    gemm = ops.int8_matmul

    def counting(a, b):
        shapes.append((tuple(a.shape), tuple(b.shape)))
        return gemm(a, b)

    monkeypatch.setattr(ops, "int8_matmul", counting)
    got, want = replay()
    assert torch.equal(got, want)
    p = workloads.WORKLOADS["llm_train"].SCALES["tiny"]
    assert len(shapes) == want_counts["int8_matmul"] == 3 * (
        7 * p["n_layers"] + 1)
    s, d, f, v = p["seq"], p["d"], p["d_ff"], p["vocab"]
    # (M, K, N): the forward and dX shapes, dY emb, and the X^T dY of each
    # weight, the logits' as emb^T's gradient (phase 3 times these)
    assert {(a[0], a[1], b[1]) for a, b in shapes} == {
        (s, d, d), (s, d, f), (s, f, d), (s, d, v), (s, v, d),
        (d, s, d), (d, s, f), (f, s, d), (d, s, v)}


# -- phase 6: the LM serving path ---------------------------------------------

def test_serve_reference_is_the_jax_packages():
    """The pinned digests are those of the JAX package's prefill and serve
    steps, in its serving loop, on the smoke's numpy weights and the
    prompts of its ``serve(seed=0)``."""
    from _lm_reference import as_port_fields, jax_config, serve_tokens
    cfg = chip_smoke.pinned_config()
    cfg_j = jax_config(chip_smoke.SERVE_ARCH)
    assert dataclasses.asdict(cfg) == as_port_fields(cfg_j)
    p = chip_smoke.SERVE_PINNED
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=p["prompt_len"],
                            dtype=np.int32) for _ in range(p["n_requests"])]
    tokens = serve_tokens(cfg_j, chip_smoke.jax_layout_params(cfg, seed=0),
                          prompts, p["batch"], p["prompt_len"],
                          p["max_new"])
    assert (chip_smoke.token_digests(tokens)
            == chip_smoke.SERVE_REFERENCE["tokens_sha256"])


def test_pinned_serve_equals_the_reference_on_the_cpu():
    before = ops.launch_counts()
    tokens = chip_smoke.serve_pinned("cpu")
    assert ops.launch_counts() == before            # plain versions only
    assert (chip_smoke.token_digests(tokens)
            == chip_smoke.SERVE_REFERENCE["tokens_sha256"])


def test_serve_phase_rehearsed_on_the_cpu():
    """The full-width phase's plumbing at the reduced size: one recorded
    attention call per layer and batch, each equal to the plain version
    on the CPU, and the plain path serving the same tokens."""
    from repro_torch.models import model as M
    cfg = chip_smoke.pinned_config()
    p = dict(chip_smoke.SERVE_FULL, prompt_len=16, max_new=3)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    tokens, calls = chip_smoke.serve_recorded(cfg, params, p, "cpu")
    assert len(calls) == cfg.n_layers * -(-p["n_requests"] // p["batch"])
    q, k, v, causal, out = calls[0]
    assert q.shape == (p["batch"] * cfg.n_heads, p["prompt_len"],
                       cfg.head_dim) and causal
    assert torch.equal(out, chip_smoke.ref.flash_attention_plain(q, k, v))
    assert chip_smoke.ops.flash_attention is ops.flash_attention
    assert chip_smoke.serve_plain(cfg, params, p, "cpu") == tokens
    assert all(len(t) == p["max_new"] for t in tokens)


# -- phase 10: the LM families ------------------------------------------------

@pytest.mark.parametrize("arch", chip_smoke.FAMILY_ARCHS)
def test_families_reference_is_the_jax_packages(arch):
    """The pinned digests are those of the JAX package's steps on the
    smoke's numpy weights: its serving loop on the prompts of
    ``serve(seed=0)``, and for the stubbed configs its prefill and serve
    steps (decode cross-attending to ``encode``) on the smoke's prompts
    and stubs."""
    from _lm_reference import (as_port_fields, extras_tokens, jax_config,
                               serve_tokens)
    cfg = chip_smoke.family_config(arch)
    pattern = (chip_smoke.ZAMBA2_PERIOD if arch == "zamba2-1.2b" else None)
    cfg_j = jax_config(arch, pattern=pattern)
    assert dataclasses.asdict(cfg) == as_port_fields(cfg_j)
    tree = chip_smoke.jax_layout_params(cfg, seed=0)
    p = chip_smoke.SERVE_PINNED
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=p["prompt_len"],
                            dtype=np.int32) for _ in range(p["n_requests"])]
    want = chip_smoke.FAMILIES_REFERENCE[arch]
    tokens = serve_tokens(cfg_j, tree, prompts, p["batch"], p["prompt_len"],
                          p["max_new"])
    assert chip_smoke.token_digests(tokens) == want["serve"]
    assert set(want) == ({"serve", "extras"}
                         if arch in chip_smoke.FAMILIES_EXTRAS else {"serve"})
    if "extras" in want:
        e = chip_smoke.FAMILIES_PINNED_EXTRAS
        tokens = extras_tokens(
            cfg_j, tree, chip_smoke.family_prompts(cfg, e["batch"],
                                                   e["prompt_len"], 0),
            chip_smoke.family_extras(cfg, e["batch"], e["prompt_len"], 0),
            e["max_new"])
        assert chip_smoke.token_digests(tokens) == want["extras"]


@pytest.mark.parametrize("arch", chip_smoke.FAMILY_ARCHS)
def test_pinned_families_equal_the_reference_on_the_cpu(arch):
    before = ops.launch_counts()
    runs = chip_smoke.families_pinned(arch, "cpu")
    assert ops.launch_counts() == before            # plain versions only
    assert set(runs) == set(chip_smoke.FAMILIES_REFERENCE[arch])
    for run, (tokens, routing) in runs.items():
        assert (chip_smoke.token_digests(tokens)
                == chip_smoke.FAMILIES_REFERENCE[arch][run])
        assert routing["logit_margin"] > 0
        assert (routing["pairs"] > 0) == (arch in ("dbrx-132b",
                                                   "deepseek-v2-236b"))


@pytest.mark.parametrize("arch", chip_smoke.FAMILY_ARCHS)
def test_jax_layout_params_has_the_jax_packages_tree(arch):
    """The smoke's numpy weights have the leaves, paths and shapes of the
    JAX package's init of the same config (and the dense draws are
    phase 6's, pinned by SERVE_REFERENCE)."""
    from repro.models import model as RM
    cfg = chip_smoke.family_config(arch)
    tree = chip_smoke.jax_layout_params(cfg, seed=0)
    shapes = jax.eval_shape(lambda k: RM.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    got = jax.tree_util.tree_map(lambda a: a.shape, tree)
    want = jax.tree_util.tree_map(lambda a: a.shape, shapes)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    assert got == want


def test_k6_calls_of_the_full_configs_are_the_table():
    """The launches phase 10 holds the card to, and the config's count of
    them, without building a model."""
    s = chip_smoke.FAMILIES_FULL
    for arch, want in chip_smoke.FAMILIES_K6.items():
        cfg = chip_smoke.family_config(arch, full=True)
        extras = chip_smoke.family_extras(cfg, 1, s["prompt_len"], 0)
        assert chip_smoke.k6_calls(cfg, extras, s["max_new"]) == want, arch
    assert chip_smoke.family_config("dbrx-132b", full=True).n_layers == 4
    assert set(chip_smoke.FAMILIES_K6) == set(chip_smoke.FAMILY_ARCHS)


def test_scan_calls_of_the_families_are_the_table():
    """The selective-scan launches phase 10 holds the card to, and the
    configs' count of them, without building a model."""
    s = chip_smoke.FAMILIES_FULL
    for arch, (pinned, full) in chip_smoke.FAMILIES_SCAN.items():
        cfg = chip_smoke.family_config(arch)
        assert chip_smoke.pinned_scan_calls(cfg, arch) == pinned, arch
        cfg = chip_smoke.family_config(arch, full=True)
        assert (chip_smoke.scan_calls(cfg, 2, s["max_new"])
                + chip_smoke.scan_calls(cfg, 1, 1)) == full, arch
    assert set(chip_smoke.FAMILIES_SCAN) == set(chip_smoke.FAMILY_ARCHS)
    assert chip_smoke.FAMILIES_SCAN["zamba2-1.2b"] == (48, 646)


@pytest.mark.parametrize("run", ["pinned", "full"])
def test_scan_calls_count_the_kernel_path_on_the_cpu(run, monkeypatch):
    """zamba2's phase 10 runs at the reduced size: the calls that take
    ``ops.selective_scan`` (a launch each on the card) are the count
    phase 10 holds the card's launches to."""
    calls = []
    kernel = ops.selective_scan

    def counted(*operands, **kwargs):
        calls.append(operands[0].shape)
        return kernel(*operands, **kwargs)

    monkeypatch.setattr(ops, "selective_scan", counted)
    arch = "zamba2-1.2b"
    cfg = chip_smoke.family_config(arch)
    if run == "pinned":
        chip_smoke.families_pinned(arch, "cpu")
        want = chip_smoke.pinned_scan_calls(cfg, arch)
        assert want == chip_smoke.FAMILIES_SCAN[arch][0]
    else:
        params = chip_smoke.M.init_params(cfg,
                                          torch.Generator().manual_seed(0))
        sizes = dict(chip_smoke.FAMILIES_FULL, batch=2, prompt_len=32)
        res = chip_smoke.families_full(arch, "cpu", sizes,
                                       model=(cfg, params))
        want = res["scan_calls"]
        assert want == 6 * (2 * sizes["max_new"] + 1)
    assert len(calls) == want
    assert sorted({shape[1] for shape in calls}) == (
        [1, 8] if run == "pinned" else [1, 32])


def test_attention_pairs_under_each_mask():
    assert chip_smoke.attn_pairs(1024, 1024, True) == 1024 * 1025 // 2
    assert chip_smoke.attn_pairs(1, 256, True) == 1
    assert chip_smoke.attn_pairs(1, 256, False) == 256
    assert chip_smoke.attn_pairs(4, 2, True) == 1 + 2 + 2 + 2


@pytest.mark.parametrize("arch", chip_smoke.FAMILY_ARCHS)
def test_families_phase_rehearsed_on_the_cpu(arch):
    """Phase 10's full-width plumbing at the reduced size in fp32: the
    recorded run makes the config's flash-attention calls, each equal to
    the plain version on the CPU, the logits are finite and the einsum
    path's, and nothing is launched."""
    cfg = chip_smoke.family_config(arch)
    params = chip_smoke.M.init_params(cfg, torch.Generator().manual_seed(0))
    sizes = dict(chip_smoke.FAMILIES_FULL, batch=2, prompt_len=32)
    res = chip_smoke.families_full(arch, "cpu", sizes, model=(cfg, params))
    assert res["launches"] == (0, 0)
    assert len(res["calls"]) == sum(res["k6_calls"])
    assert (res["k6_calls"][1] > 0) == (arch == "seamless-m4t-medium")
    for q, k, v, causal, out in res["calls"]:
        assert torch.equal(out, chip_smoke.ref.flash_attention_plain(
            q, k, v, causal=causal))
    assert torch.isfinite(res["logits"]).all()
    torch.testing.assert_close(res["logits"], res["einsum_logits"],
                               atol=1e-4, rtol=1e-4)
    assert res["again_tokens"] == res["tokens"]
    assert [len(t) for t in res["tokens"]] == [sizes["max_new"]] * 2
    assert chip_smoke.ops.flash_attention is ops.flash_attention
    assert chip_smoke.layers.moe_route is chip_smoke.M.L.moe_route


# -- phase 9: the LM training path --------------------------------------------

@pytest.mark.parametrize("microbatches", sorted(chip_smoke.TRAIN_LM_REFERENCE))
def test_train_reference_is_the_jax_packages(microbatches):
    """The pinned metrics are those of the JAX package's train step on the
    smoke's numpy weights with zero AdamW state and its SyntheticLM
    batches, within TRAIN_TOL (XLA's CPU sums may differ in the last bit
    between machines)."""
    import jax.numpy as jnp
    from _lm_reference import as_port_fields, jax_config
    from repro.data import SyntheticLM
    from repro.launch.steps import build_train_step
    from repro.optim import adamw_init
    cfg = jax_config(chip_smoke.SERVE_ARCH)
    assert as_port_fields(cfg) == dataclasses.asdict(
        chip_smoke.pinned_config())
    p = chip_smoke.TRAIN_PINNED
    step_fn = jax.jit(build_train_step(cfg, total_steps=p["steps"],
                                       base_lr=p["base_lr"],
                                       microbatches=microbatches))
    params = jax.tree_util.tree_map(
        jnp.asarray, chip_smoke.jax_layout_params(cfg, seed=0))
    opt = adamw_init(params)
    data = SyntheticLM(cfg.vocab, p["seq"], p["batch"], seed=0)
    want = chip_smoke.TRAIN_LM_REFERENCE[microbatches]
    # chip_smoke.pinned_batches() are these batches (tested below)
    assert len(want) == p["steps"]
    for step in range(p["steps"]):
        new, opt, m = step_fn(params, opt, {
            k: jnp.asarray(v) for k, v in data.batch(step).items()})
        l1 = sum(float(np.abs(np.asarray(a, np.float64)
                              - np.asarray(b, np.float64)).sum())
                 for a, b in zip(jax.tree_util.tree_leaves(new),
                                 jax.tree_util.tree_leaves(params)))
        got = {"loss": float(m["loss"]), "lr": float(m["lr"]),
               "grad_norm": float(m["grad_norm"]), "step_l1": l1}
        assert chip_smoke.train_metrics_within(got, want[step]), got
        params = new


def test_pinned_batches_are_both_packages_synthetic_batches():
    from repro.data import SyntheticLM as RefSyntheticLM
    from repro_torch.data import SyntheticLM
    p = chip_smoke.TRAIN_PINNED
    cfg = chip_smoke.pinned_config()
    batches = chip_smoke.pinned_batches()
    assert len(batches) == p["steps"]
    for step, got in enumerate(batches):
        for data in (SyntheticLM, RefSyntheticLM):
            want = data(cfg.vocab, p["seq"], p["batch"], seed=0).batch(step)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k])


def test_train_metrics_within_holds_each_bound():
    want = chip_smoke.TRAIN_LM_REFERENCE[1][0]
    assert chip_smoke.train_metrics_within(dict(want), want)
    tol = chip_smoke.TRAIN_TOL
    for key, off in (("loss", 2 * tol["loss"]),
                     ("lr", 2 * tol["lr_rtol"] * want["lr"]),
                     ("grad_norm", 2 * tol["grad_norm_rtol"]
                      * want["grad_norm"]),
                     ("step_l1", 2 * tol["step_l1_rtol"] * want["step_l1"])):
        assert not chip_smoke.train_metrics_within(
            dict(want, **{key: want[key] + off}), want), key


@pytest.mark.parametrize("mangled,label", [
    ("_ZN12_GLOBAL__N_120bitserial_add_kernelIjLb1EEEvPKT_S3_PS1_x",
     "bitserial_add_kernel<u32, 16-byte I/O>"),
    ("_ZN12_GLOBAL__N_120bitserial_add_kernelIhLb0EEEvPKT_S3_PS1_x",
     "bitserial_add_kernel<u8, unaligned>"),
    ("_ZN12_GLOBAL__N_110mws_kernelIjLi2ELi3EjEEvPKT_PS1_iT2_i",
     "mws_kernel<u32, xor, 3 pages, 32-bit index>"),
    ("_ZN12_GLOBAL__N_110mws_kernelIhLi4ELi0ExEEvPKT_PS1_iT2_i",
     "mws_kernel<u8, nor, any pages, 64-bit index>"),
    ("_ZN12_GLOBAL__N_121flash_attn_mma_kernelILi64EEEvPK13__nv_bfloat16S3_"
     "S3_PS1_xxxif", "flash_attn_mma_kernel<bf16, dh 64>"),
    ("_ZN12_GLOBAL__N_113search_kernelEPKjS1_Phxi", "search_kernel"),
    ("_ZN12_GLOBAL__N_120shift_add_mul_kernelILi8ELb1EEEvPKjS2_Pjxi",
     "shift_add_mul_kernel<8 rounds, 16-byte I/O>"),
    ("_ZN12_GLOBAL__N_120shift_add_mul_kernelILi0ELb0EEEvPKjS2_Pjxi",
     "shift_add_mul_kernel<any rounds, unaligned>"),
    ("_ZN12_GLOBAL__N_119search_chunk_kernelEPK5uint4PKjPhx",
     "search_chunk_kernel<wpr 4, 16-byte loads>"),
    ("_ZN38_GLOBAL__N__b0ad16ce_6_ndp_cu_719fb58a22int8_matmul_mma_kernel"
     "ILi3ELb1EEEvPKaS2_Pixxxxi",
     "int8_matmul_mma_kernel<48 rows, 16-byte loads>"),
    ("_ZN38_GLOBAL__N__b0ad16ce_6_ndp_cu_719fb58a22int8_matmul_mma_kernel"
     "ILi1ELb0EEEvPKaS2_Pixxxxi",
     "int8_matmul_mma_kernel<16 rows, byte loads>"),
])
def test_sass_report_labels_each_template_instance(mangled, label):
    assert chip_smoke.kernel_label(mangled) == label


# a cuobjdump -sass excerpt: predicated and unpredicated instructions,
# addresses past 0xffff, and opcodes that only share a prefix with a
# counted one (IMAD.MOV counts as IMAD; IDP.4A as IDP)
SASS_EXCERPT = """
        /*0c40*/                   IMMA.16832.S8.S8 R24, R4.ROW, R20.COL, R24 ;
        /*0c50*/              @!P0 IMMA.16832.S8.S8 R28, R4.ROW, R22.COL, R28 ;
        /*0c60*/                   IDP.4A.S8.S8 R3, R8, R9, R3 ;
        /*0c70*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*10c80*/                  IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
        /*10c90*/                  LOP3.LUT R5, R6, R7, R8, 0x96, !PT ;
        /*10ca0*/                  PRMT R9, R10, 0x5140, R11 ;
"""


def test_sass_report_counts_tensor_core_and_dp4a_opcodes():
    instrs = chip_smoke.sass_instructions(SASS_EXCERPT)
    assert len(instrs) == 7 and instrs[4][0] == 0x10c80
    assert chip_smoke.opcode_counts(instrs) == {
        "LOP3": 1, "IMAD": 1, "SHF": 0, "HMMA": 1, "IMMA": 2, "IDP": 1}


def test_ptxas_usage_reads_registers_and_spills():
    log = """ptxas info    : Compiling entry function '_Zk1' for 'sm_90a'
ptxas info    : Function properties for _Zk1
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 36864 bytes smem
ptxas info    : Compiling entry function '_Zk2' for 'sm_90a'
ptxas info    : Function properties for _Zk2
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 400 bytes cmem[0]
"""
    assert chip_smoke.ptxas_usage(log) == {
        "_Zk1": {"registers": 96, "stack": 0, "spill_stores": 0,
                 "spill_loads": 0},
        "_Zk2": {"registers": 255, "stack": 16, "spill_stores": 12,
                 "spill_loads": 8}}


def test_prefix_add_ops_counts_the_int32_circuit():
    """p and g, five generate levels and four propagate levels of a shift
    and a LOP3 each, the sum's shift and XOR3: 22 (the ripple's 3W + 1 was
    97)."""
    assert chip_smoke.prefix_add_ops(32) == 22


# a grid-stride loop as cuobjdump -sass prints it: the body runs from the
# backward branch's target (0x0100) to the branch
LOOP_WITH_VECTOR_LOAD = """
        /*0100*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0110*/                   LDG.E.128.CONSTANT R8, desc[UR4][R12.64] ;
        /*0120*/                   LOP3.LUT R4, R4, R8, RZ, 0xc3, !PT ;
        /*0130*/                   STG.E.128 desc[UR4][R14.64], R4 ;
        /*0140*/              @P0 BRA 0x100 ;
        /*0150*/                   EXIT ;
"""


def test_vector_loop_report_reads_the_16_byte_loop():
    instrs = chip_smoke.sass_instructions(LOOP_WITH_VECTOR_LOAD)
    assert chip_smoke.loop_ranges(instrs) == [(0x100, 0x140)]
    lines = chip_smoke.vector_loop_report(
        "shift_add_mul_kernel<8 rounds, 16-byte I/O>", instrs,
        {"spill_stores": 0, "spill_loads": 0})
    assert len(lines) == 1 and "5 instructions for 4 elements" in lines[0]
    assert "1.25 an element" in lines[0]
    assert "'LDG.E.128.CONSTANT': 2" in lines[0]
    lines = chip_smoke.vector_loop_report(
        "search_chunk_kernel<wpr 4, 16-byte loads>", instrs, {})
    # two 16-byte loads: a body unrolled over two records
    assert "for 2 records a thread, 2.5 a record" in lines[0]
    # only the 16-byte instances of the adder, K3 and K4 are read
    assert chip_smoke.vector_loop_report(
        "shift_add_mul_kernel<any rounds, unaligned>", instrs, {}) == []
    assert chip_smoke.vector_loop_report(
        "int8_matmul_mma_kernel<48 rows, 16-byte loads>", instrs, {}) == []


@pytest.mark.parametrize("label", [
    "shift_add_mul_kernel<8 rounds, 16-byte I/O>",
    "search_chunk_kernel<wpr 4, 16-byte loads>",
    "bitserial_add_kernel<u32, 16-byte I/O>"])
def test_vector_loop_report_fails_without_a_16_byte_loop_or_with_spills(
        label):
    scalar = chip_smoke.sass_instructions(
        LOOP_WITH_VECTOR_LOAD.replace(".128", ""))
    with pytest.raises(AssertionError, match="no loop with a 16-byte load"):
        chip_smoke.vector_loop_report(label, scalar, {})
    # a 16-byte load outside every loop does not count
    straight = chip_smoke.sass_instructions(
        LOOP_WITH_VECTOR_LOAD.replace("@P0 BRA 0x100", "@P0 BRA 0x150"))
    with pytest.raises(AssertionError, match="no loop with a 16-byte load"):
        chip_smoke.vector_loop_report(label, straight, {})
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.vector_loop_report(
            label, chip_smoke.sass_instructions(LOOP_WITH_VECTOR_LOAD),
            {"spill_stores": 8, "spill_loads": 8})


def test_sass_report_runs_the_vector_check_on_each_function(tmp_path,
                                                            capsys):
    """``sass_report`` end to end on a stand-in ``cuobjdump`` beside a
    stand-in ``nvcc``: it prints each function's counts and the 16-byte
    loop of a K3 vector instance, and fails on one that spills."""
    name = "_ZN12_GLOBAL__N_120shift_add_mul_kernelILi8ELb1EEEvPKjS2_Pjxi"
    tool = tmp_path / "cuobjdump"
    tool.write_text("#!/bin/sh\n"
                    "if [ \"$1\" = -res-usage ]; then\n"
                    f"  printf ' Function {name}:\\n  REG:36 STACK:0 "
                    "SHARED:0 LOCAL:0\\n'\n"
                    "else\n"
                    f"  printf '\\t\\tFunction : {name}\\n'\n"
                    f"  cat <<'SASS'\n{LOOP_WITH_VECTOR_LOAD}SASS\n"
                    "fi\n")
    tool.chmod(0o755)
    nvcc = str(tmp_path / "nvcc")
    clean = {name: {"registers": 36, "stack": 0, "spill_stores": 0,
                    "spill_loads": 0}}
    counts = chip_smoke.sass_report("lib.so", nvcc, clean)
    label = "shift_add_mul_kernel<8 rounds, 16-byte I/O>"
    assert counts == {label: {"LOP3": 1, "IMAD": 0, "SHF": 0, "HMMA": 0,
                              "IMMA": 0, "IDP": 0}}
    out = capsys.readouterr().out
    assert f"sass {label}: 6 instructions" in out and "REG:36" in out
    assert "16-byte loop body: 5 instructions for 4 elements" in out
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.sass_report("lib.so", nvcc, {name: dict(
            clean[name], spill_stores=4)})


# -- phase 11, planning --------------------------------------------------------

def _jax_argument_bytes(arch, shape, multi):
    """The JAX package's per-device argument bytes of a cell: its
    input_specs on the production mesh (an AbstractMesh with Auto axes,
    R9), each leaf's shard under its PartitionSpec."""
    from jax.sharding import AbstractMesh, AxisType
    from repro.launch.specs import input_specs
    dims, names = (((2, 16, 16), ("pod", "data", "model")) if multi
                   else ((16, 16), ("data", "model")))
    mesh = AbstractMesh(dims, names, axis_types=(AxisType.Auto,) * len(dims))
    _, args, _ = input_specs(arch, shape, mesh)
    return sum(int(np.prod(leaf.sharding.shard_shape(leaf.shape)))
               * np.dtype(leaf.dtype).itemsize
               for leaf in jax.tree_util.tree_leaves(args))


def test_planning_reference_is_the_jax_packages():
    got = {}
    for arch, shape, multi in chip_smoke.PLANNING_CELLS:
        mesh = "2x16x16" if multi else "16x16"
        got[(arch, shape, mesh)] = _jax_argument_bytes(arch, shape, multi)
    assert got == chip_smoke.PLANNING_REFERENCE


def test_planning_moe_bounds_both_paths_alike():
    """At 4 x 1024 tokens both MoE paths of phase 11 give each of
    deepseek-v2-236b's experts int(1.25 * 24576 / 160) = 192 slots: the
    single-device path past its drop-free range (t * k > 1024), the
    expert-parallel body on its one rank's tokens."""
    from repro_torch.models import layers
    cfg = chip_smoke.configs.get(chip_smoke.PLANNING_MOE["arch"])
    t = chip_smoke.PLANNING_MOE["batch"] * chip_smoke.PLANNING_MOE["seq"]
    k, e = cfg.experts_per_tok, cfg.n_experts
    assert t * k > 1024
    assert layers.moe_capacity(t, k, e) == max(8, int(1.25 * t * k / e)) \
        == 192
