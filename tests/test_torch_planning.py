"""The port's distributed planning against the JAX package: the shape sets,
the Conduit scheduler's estimates, the sharding plan of every cell's
arguments and their per-device bytes; and the dry-run itself (a DTensor
program on a fake process group, counted by ``launch.costing``).

The JAX package's specs are taken on a ``jax.sharding.AbstractMesh`` with
Auto axes: under jax 0.9 ``jax.make_mesh`` gives Explicit axes, on which
the reference's own dry-run no longer lowers (R9, pinned below).  Every
fake process group is destroyed by the ``fake_world`` context it lives in.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, AxisType  # noqa: E402
from repro import configs as repro_configs  # noqa: E402
from repro.configs import shapes as repro_shapes  # noqa: E402
from repro.distributed import scheduler as repro_scheduler  # noqa: E402
from repro.hw.tpu_spec import TPU_V5E  # noqa: E402
from repro.launch import specs as repro_specs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.distributed import scheduler  # noqa: E402
from repro_torch.hw.gpu_spec import H100, GPUSpec  # noqa: E402
from repro_torch.launch import costing, dryrun, mesh as MS  # noqa: E402
from repro_torch.launch import sharding as SH, specs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial,  # noqa: E402
                                      Replicate, Shard)
from torch.distributed.tensor.experimental import (  # noqa: E402
    implicit_replication)

ARCHS = configs.ARCHS + configs.PAPER_ARCHS
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the port's planning with the JAX package's TPU constants, so that every
# estimate can be held equal to the reference's
TPU_AS_GPU = GPUSpec(name="tpu_v5e", peak_bf16_flops=TPU_V5E.peak_bf16_flops,
                     hbm_bw=TPU_V5E.hbm_bw, hbm_bytes=TPU_V5E.hbm_bytes,
                     nic_bw=TPU_V5E.ici_bw)


# -- shapes, the GPU spec, the scheduler -------------------------------------

def test_shapes_are_the_jax_packages():
    assert shapes.SHAPE_ORDER == repro_shapes.SHAPE_ORDER
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in repro_shapes.SHAPES.items()}
    for arch in ARCHS:
        for shape in shapes.SHAPE_ORDER:
            assert shapes.applicable(configs.get(arch), shape) == \
                repro_shapes.applicable(repro_configs.get(arch), shape)


def test_h100_figures_and_the_roofline_under_tpu_constants():
    assert (H100.peak_bf16_flops, H100.hbm_bw, H100.hbm_bytes,
            H100.nvlink_bw, H100.nic_bw) == (989e12, 3.35e12, 80e9, 450e9,
                                             50e9)
    assert H100.collective_bw == H100.nic_bw
    for args in [(1e15, 2e12, 3e10, 1), (7e12, 9e11, 4e11, 256),
                 (1.0, 1e13, 0.0, 512)]:
        assert TPU_AS_GPU.roofline_terms(*args) == \
            TPU_V5E.roofline_terms(*args)


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_estimates_are_the_jax_packages(arch):
    """Every field of every estimate, for train, prefill and decode at
    their shapes' sizes, the seven candidates, on the 256- and 512-chip
    meshes; and the plan each package chooses."""
    cfg, ref_cfg = configs.get(arch), repro_configs.get(arch)
    port = scheduler.ConduitScheduler(TPU_AS_GPU)
    ref = repro_scheduler.ConduitScheduler(TPU_V5E)
    cands = scheduler.default_candidates()
    ref_cands = repro_scheduler.default_candidates()
    assert [dataclasses.asdict(c) for c in cands] == \
        [dataclasses.asdict(c) for c in ref_cands]
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        spec = shapes.SHAPES[shape]
        for chips, pods in ((256, 1), (512, 2)):
            args = (spec.kind, spec.global_batch, spec.seq_len, chips, 16,
                    16, pods)
            for c, rc in zip(cands, ref_cands):
                got = dataclasses.asdict(port.estimate(cfg, *args, c))
                want = dataclasses.asdict(ref.estimate(ref_cfg, *args, rc))
                assert got == want, (shape, chips, c.name)
            best, _ = port.choose(cfg, *args[:-1], pods=pods)
            ref_best, _ = ref.choose(ref_cfg, *args[:-1], pods=pods)
            assert best.plan.name == ref_best.plan.name


def test_scheduler_defaults_to_the_h100():
    assert scheduler.ConduitScheduler().spec is H100


# -- the sharding plan of every cell ------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _ref_key(path) -> tuple:
    out = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                out.append(getattr(k, attr))
                break
    return tuple(out)


def _ref_layers(cfg):
    """For each segment of the JAX package's stacked layout, the port's
    layer indices it holds."""
    out, i = [], 0
    for _, count in repro_model_segments(cfg):
        out.append(list(range(i, i + count)))
        i += count
    return out


def repro_model_segments(cfg):
    from repro.models import model as RM
    return RM.segments_of(cfg)


def ref_plan(arch: str, shape: str, mesh_name: str):
    """{port path: (global shape, dtype name, per-dim axes)} of the JAX
    package's cell arguments, its stacked segments unstacked onto the
    port's one-entry-per-layer lists, and its per-device argument bytes."""
    dims, names = MESHES[mesh_name]
    mesh = AbstractMesh(dims, names, axis_types=(AxisType.Auto,) * len(dims))
    cfg = repro_configs.get(arch)
    _, args, kind = repro_specs.input_specs(arch, shape, mesh)
    seg_layers = _ref_layers(cfg)
    plan, nbytes = {}, 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(args)[0]:
        spec = tuple(leaf.sharding.spec) + (None,) * (
            len(leaf.shape) - len(leaf.sharding.spec))
        axes = [_axes(e) for e in spec]
        nbytes += int(np.prod(leaf.sharding.shard_shape(leaf.shape))) * \
            np.dtype(leaf.dtype).itemsize
        key = _ref_key(path)
        dtype = np.dtype(leaf.dtype).name
        if kind == "decode" and key == (3,):
            continue          # the position: a host int in the port
        if "segments" in key:                       # params, moments
            at = key.index("segments")
            for j, layer in enumerate(seg_layers[key[at + 1]]):
                plan[key[:at] + ("layers", layer) + key[at + 2:]] = (
                    tuple(leaf.shape[1:]), dtype, axes[1:])
        elif "encoder" in key:
            at = key.index("encoder")
            for j in range(leaf.shape[0]):
                plan[key[:at + 1] + (j,) + key[at + 1:]] = (
                    tuple(leaf.shape[1:]), dtype, axes[1:])
        elif kind != "train" and key[0] == 1:       # caches, per segment
            for j, layer in enumerate(seg_layers[key[1]]):
                plan[(1, layer) + key[2:]] = (tuple(leaf.shape[1:]), dtype,
                                              axes[1:])
        else:
            plan[key] = (tuple(leaf.shape), dtype, axes)
    return plan, nbytes, kind


def port_plan(args, mesh):
    """The same map of the port's DTensor arguments."""
    plan = {}

    def record(path, leaf):
        if not isinstance(leaf, DTensor):
            return
        axes = [()] * leaf.ndim
        for name, pl in zip(mesh.mesh_dim_names, leaf.placements):
            if isinstance(pl, Shard):
                axes[pl.dim] = axes[pl.dim] + (name,)
            else:
                assert isinstance(pl, Replicate), pl
        plan[path] = (tuple(leaf.shape), str(leaf.dtype).split(".")[1], axes)
        # the local shard is the plan's, and nothing was allocated
        assert leaf.to_local().shape == SH.local_shape(
            leaf.shape, tuple(ax or None for ax in axes), mesh)
        assert type(leaf.to_local()).__name__ == "FakeTensor"

    SH.map_with_path(record, args)
    return plan


# the cells whose argument trees take over ~2 s to build and compare
HEAVY = {("deepseek-v2-236b", "train_4k"), ("dbrx-132b", "train_4k"),
         ("minicpm-2b", "train_4k")}
CELLS = [pytest.param(arch, shape, m, marks=[pytest.mark.slow] * (
            (arch, shape) in HEAVY))
         for arch in configs.ARCHS for shape in shapes.SHAPE_ORDER
         for m in MESHES if shapes.applicable(configs.get(arch), shape)[0]]


@pytest.mark.parametrize("arch,shape,mesh_name", CELLS)
def test_cell_arguments_are_sharded_as_the_jax_packages(arch, shape,
                                                        mesh_name):
    """Every leaf of params, AdamW state, caches, tokens and stubs: its
    global shape, dtype and the mesh axes of each dim; and the per-device
    argument bytes (the decode position an int32 scalar in both)."""
    want, want_bytes, kind = ref_plan(arch, shape, mesh_name)
    dims, names = MESHES[mesh_name]
    with MS.fake_world(int(np.prod(dims))):
        mesh = MS.make_mesh(dims, names)
        _, args, got_kind = specs.input_specs(arch, shape, mesh)
        got = port_plan(args, mesh)
        got_bytes = costing.argument_bytes(args)
    assert got_kind == kind
    assert set(got) == set(want)
    for path in want:
        g, w = got[path], want[path]
        assert g[:2] == w[:2], path
        # tokens: int32 in both; trailing unsharded dims may be omitted
        assert g[2] == [tuple(a) for a in w[2]], path
    assert got_bytes == want_bytes


def test_placements_of_a_tuple_entry_shard_one_dim_on_each_axis():
    with MS.fake_world(512):
        mesh = MS.make_production_mesh(multi_pod=True)
        assert SH.placements((("pod", "data"), None, "model"), mesh) == (
            Shard(0), Shard(0), Shard(2))
        assert SH.placements((None, ("data", "model")), mesh) == (
            Replicate(), Shard(1), Shard(1))
        assert SH.fit_spec(mesh, (8, 48), (("pod", "data"), "model")) == (
            None, "model")


def test_params_shapes_are_init_params_shapes():
    """The per-kind shortcut builds the tree ``init_params`` builds."""
    for arch in ("zamba2-1.2b", "seamless-m4t-medium", "deepseek-v2-236b"):
        cfg = configs.get(arch).reduced()
        from repro_torch.models import model as M
        want = M.init_params(cfg, torch.Generator().manual_seed(0))
        got = specs.params_shapes(cfg)
        flat_w, flat_g = [], []
        SH.map_with_path(lambda p, t: flat_w.append((p, t.shape, t.dtype)),
                         want)
        SH.map_with_path(lambda p, t: flat_g.append((p, t.shape, t.dtype)),
                         got)
        assert flat_g == flat_w
        assert all(t.device.type == "meta" for _, t in [
            (None, x) for x in torch.utils._pytree.tree_leaves(got)])


@pytest.mark.slow
def test_importing_the_mesh_module_touches_no_process_group():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
            "assert not dist.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr


def test_fake_world_is_destroyed_on_exit_and_on_error():
    import torch.distributed as dist
    with MS.fake_world(4):
        assert dist.get_world_size() == 4
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        with MS.fake_world(4):
            MS.make_mesh((2, 4), ("data", "model"))
    assert not dist.is_initialized()


# -- the counters -------------------------------------------------------------

def test_collective_counter_reads_a_hand_built_program():
    """An all-gather, an all-reduce and a reduce-scatter of known sizes,
    each one functional collective of one rank's result bytes."""
    with MS.fake_world(4):
        mesh = MS.make_mesh((2, 2), ("data", "model"))
        local = torch.ones(4, 8)                            # fp32, 128 B
        x = DTensor.from_local(local, mesh, (Shard(0), Replicate()),
                               run_check=False)
        part = DTensor.from_local(local, mesh, (Replicate(), Partial()),
                                  run_check=False)

        def program(x, part):
            x.redistribute(mesh, (Replicate(), Replicate()))  # gather
            part.redistribute(mesh, (Replicate(), Replicate()))  # reduce
            part.redistribute(mesh, (Replicate(), Shard(0)))  # scatter

        rec = costing.count(program, (x, part))
    assert rec["collectives"] == {
        "all-reduce": 128, "all-gather": 256, "reduce-scatter": 64,
        "all-to-all": 0, "collective-permute": 0, "ops": 3, "total": 448}
    assert rec["flops"] == 0


def test_flops_of_a_sharded_product_are_one_ranks():
    with MS.fake_world(4):
        mesh = MS.make_mesh((2, 2), ("data", "model"))
        a = DTensor.from_local(torch.ones(8, 16), mesh,
                               (Shard(0), Replicate()), run_check=False)
        w = DTensor.from_local(torch.ones(16, 4), mesh,
                               (Replicate(), Shard(1)), run_check=False)
        rec = costing.count(lambda a, w: a @ w, (a, w))
    assert rec["flops"] == 2 * 8 * 16 * 4          # [8,16] @ [16,4] local
    assert rec["collectives"]["total"] == 0


SMALL = {"train": (4, 16), "prefill": (4, 16), "decode": (4, 16)}


def small_spec(shape: str) -> shapes.ShapeSpec:
    kind = shapes.SHAPES[shape].kind
    b, s = SMALL[kind]
    return dataclasses.replace(shapes.SHAPES[shape], global_batch=b,
                               seq_len=s)


def reduced(arch: str, **kw):
    return dataclasses.replace(configs.get(arch).reduced(), **kw)


def test_dry_run_of_a_small_cell():
    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", device="cpu",
                          mesh=((2, 2), ("data", "model")),
                          cfg=reduced("tinyllama-1.1b"),
                          spec=small_spec("decode_32k"))
    assert rec["kind"] == "decode" and rec["mesh"] == "2x2"
    assert rec["chips"] == 4 and "error" not in rec
    for key in ("params", "active_params", "argument_size_in_bytes",
                "per_device_bytes", "flops", "op_bytes", "collectives",
                "roofline", "model_flops", "useful_flop_ratio"):
        assert key in rec, key
    assert rec["flops"] > 0 and rec["per_device_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert not L.model_axis() and not L.data_axes()


@pytest.mark.slow
def test_scan_counts_are_linear_in_the_steps_and_extrapolate_exactly():
    """A shortened Mamba2/xLSTM scan counts the same ops a step; counts at
    2 and 4 steps, scaled to 6, equal the whole 6-step count."""
    for arch in ("zamba2-1.2b", "xlstm-125m"):
        cfg = reduced(arch)
        spec = dataclasses.replace(shapes.SHAPES["prefill_32k"],
                                   global_batch=4, seq_len=6)
        with MS.fake_world(4):
            mesh = MS.make_mesh((2, 2), ("data", "model"))
            L.set_mesh_axes(("data",), "model")
            try:
                fn, args, _ = specs.input_specs(arch, "prefill_32k", mesh,
                                                cfg, spec)
                counts = {}
                for n in (2, 3, 4, None):
                    with S.scan_steps(n):
                        counts[n] = costing.count(fn, args)
            finally:
                L.set_mesh_axes((), None)
        flat = {n: (c["flops"], c["op_bytes"], c["collectives"]["total"])
                for n, c in counts.items()}
        step = [b - a for a, b in zip(flat[2], flat[3])]
        assert step == [b - a for a, b in zip(flat[3], flat[4])], arch
        assert costing._extrapolate(counts[2], counts[4], 2, 4, 6) == \
            counts[None], arch


@pytest.mark.slow
def test_per_layer_counts_are_linear_in_depth():
    """Every layer is counted (no scan body counted once): the counts of
    1, 2 and 3 layers step by the same amount."""
    recs = []
    for n in (1, 2, 3):
        cfg = reduced("tinyllama-1.1b", n_layers=n,
                      block_pattern=("attn",) * n)
        recs.append(dryrun.run_cell(
            "tinyllama-1.1b", "train_4k", device="cpu",
            mesh=((2, 2), ("data", "model")), cfg=cfg,
            spec=small_spec("train_4k")))
    d1 = recs[1]["flops"] - recs[0]["flops"]
    assert d1 > 0 and recs[2]["flops"] - recs[1]["flops"] == d1
    c1 = recs[1]["collectives"]["total"] - recs[0]["collectives"]["total"]
    assert recs[2]["collectives"]["total"] - \
        recs[1]["collectives"]["total"] == c1


@pytest.mark.slow
@pytest.mark.parametrize("mesh", [((2, 2), ("data", "model")),
                                  ((2, 2, 2), ("pod", "data", "model"))],
                         ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_dry_run_of_every_reduced_cell(arch, mesh):
    """Each applicable shape of the reduced config at small sizes: a
    record, and on the 2 x 2 mesh the flops of all ranks at least the
    unsharded count (a 1 x 1 mesh runs the whole program on its one
    rank)."""
    cfg = reduced(arch)
    for shape in shapes.SHAPE_ORDER:
        if not shapes.applicable(cfg, shape)[0]:
            continue
        spec = small_spec(shape)
        rec = dryrun.run_cell(arch, shape, device="cpu", mesh=mesh,
                              cfg=cfg, spec=spec)
        assert rec["flops"] > 0, shape
        if len(mesh[0]) == 3:
            continue
        whole = dryrun.run_cell(arch, shape, device="cpu",
                                mesh=((1, 1), ("data", "model")), cfg=cfg,
                                spec=spec)
        assert rec["flops"] * rec["chips"] >= whole["flops"], shape
        assert whole["collectives"]["total"] == 0


@pytest.mark.slow
def test_dry_run_cli_on_the_cpu(tmp_path):
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "train_4k", "--mesh", "single",
         "--device", "cpu", "--out", str(out)], env=env, capture_output=True,
        text=True, timeout=1200,
        cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json
    (rec,) = json.loads(out.read_text())
    assert "error" not in rec and rec["chips"] == 256
    assert rec["argument_size_in_bytes"] == 44412932


# -- R9: the reference's explicit-axis mesh ----------------------------------

@pytest.mark.slow
def test_r9_explicit_axes_break_the_references_lowering():
    """Under jax 0.9 ``jax.make_mesh`` gives Explicit axes, on which the
    JAX package's tinyllama-1.1b decode_32k cell fails to lower; with Auto
    axes it lowers.  Four forced host devices, in a subprocess."""
    code = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        from jax.sharding import AxisType
        from repro.launch.specs import input_specs
        def lower(mesh):
            fn, args, _ = input_specs("tinyllama-1.1b", "decode_32k", mesh)
            with jax.set_mesh(mesh):
                jax.jit(fn).lower(*args)
        try:
            lower(jax.make_mesh((2, 2), ("data", "model")))
            print("EXPLICIT LOWERED")
        except Exception as e:
            print("EXPLICIT FAILED", type(e).__name__)
        lower(jax.make_mesh((2, 2), ("data", "model"),
                            axis_types=(AxisType.Auto,) * 2))
        print("AUTO LOWERED")
        """)
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "EXPLICIT FAILED ShardingTypeError" in proc.stdout
    assert "AUTO LOWERED" in proc.stdout
