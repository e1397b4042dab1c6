"""The JAX package's LM serving path, run on numpy inputs, for the tests
that hold the PyTorch port against it (``tests/test_torch_*.py``).

Both packages get their inputs as numpy arrays: a JAX parameter tree goes
to the port through ``repro_torch.models.model.params_from_numpy``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as repro_configs
from repro.launch.steps import build_prefill_step, build_serve_step
from repro.models import model as RM

# the dense configs the port's model runs, each reduced for the CPU:
# tinyllama-1.1b (GQA), qwen3-4b (qk-norm, tied embeddings), llama2-7b
# (MHA), minicpm-2b (MHA, tied embeddings, the WSD schedule),
# stablelm-1.6b (MHA)
DENSE_ARCHS = ("tinyllama-1.1b", "qwen3-4b", "llama2-7b", "minicpm-2b",
               "stablelm-1.6b")


def as_port_fields(cfg_j) -> dict:
    """``dataclasses.asdict`` of the JAX config ``cfg_j`` with the port's
    own ``ArchConfig`` fields (none in the JAX schema) at their defaults:
    what the port's config of the same model holds."""
    from repro_torch.models.config import ArchConfig
    jax_names = {f.name for f in dataclasses.fields(cfg_j)}
    return dict(dataclasses.asdict(cfg_j),
                **{f.name: f.default for f in dataclasses.fields(ArchConfig)
                   if f.name not in jax_names})


def jax_config(arch: str, dtype: str = "float32", pattern=None):
    """Reduced ``arch`` in ``dtype``; ``pattern`` replaces its block
    pattern (and depth)."""
    cfg = dataclasses.replace(repro_configs.get(arch).reduced(), dtype=dtype)
    if pattern is not None:
        cfg = dataclasses.replace(cfg, block_pattern=tuple(pattern),
                                  n_layers=len(pattern))
    return cfg


@functools.lru_cache(maxsize=None)
def jax_params(arch: str, seed: int = 1, pattern=None):
    """The JAX package's initial parameters of reduced ``arch`` (with
    ``pattern``, if given) in fp32, as a tree of numpy arrays."""
    cfg = jax_config(arch, pattern=pattern)
    params = jax.jit(RM.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def serve_tokens(cfg, tree, prompts, batch: int, prompt_len: int,
                 max_new: int):
    """The greedy tokens of every request, in order, from the loop of
    ``repro/launch/serve.py`` (its ``serve``, lines 57-78) with the JAX
    package's prefill and serve steps on the parameter tree ``tree``."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prefill_fn = jax.jit(build_prefill_step(cfg))
    serve_fn = jax.jit(build_serve_step(cfg))
    out = []
    queue = list(prompts)
    while queue:
        active = [queue.pop(0) for _ in range(min(batch, len(queue)))]
        generated = [[] for _ in active]
        tokens = jnp.asarray(np.stack(active))
        caches = RM.init_cache(cfg, len(active), prompt_len + max_new)
        logits, caches = prefill_fn(params, caches, {"tokens": tokens})
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        for step in range(max_new):
            for gen, tok in zip(generated, np.asarray(nxt)):
                if len(gen) < max_new:
                    gen.append(int(tok))
            if all(len(gen) >= max_new for gen in generated):
                break
            logits, caches = serve_fn(params, caches, nxt,
                                      jnp.int32(prompt_len + step))
            nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out += generated
    return out


def extras_tokens(cfg, tree, tokens, extras, max_new: int):
    """The greedy tokens of each row of ``tokens`` from the JAX package's
    prefill step on the prompts with their stubs ``extras`` (numpy), then
    ``max_new - 1`` of its serve steps, cross-attending to ``encode`` of
    the frames when there are any: the JAX counterpart of
    ``chip_smoke.generate``."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prefill_fn = jax.jit(build_prefill_step(cfg))
    serve_fn = jax.jit(build_serve_step(cfg))
    b, seq = tokens.shape
    if "extra_embeds" in extras:
        seq += extras["extra_embeds"].shape[1]
    batch = {"tokens": jnp.asarray(tokens)}
    batch.update({k: jnp.asarray(v) for k, v in extras.items()})
    caches = RM.init_cache(cfg, b, seq + max_new)
    logits, caches = prefill_fn(params, caches, batch)
    nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    enc_out = None
    if "enc_feats" in extras:
        feats = batch["enc_feats"].astype(jnp.dtype(cfg.dtype))
        enc_out = jax.jit(RM.encode, static_argnums=0)(
            cfg, params, feats, jnp.broadcast_to(
                jnp.arange(feats.shape[1]), feats.shape[:2]))
    out = [np.asarray(nxt)]
    for step in range(max_new - 1):
        logits, caches = serve_fn(params, caches, nxt,
                                  jnp.int32(seq + step), enc_out)
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(np.asarray(nxt))
    return np.stack(out, axis=1).tolist()


def train_rows(cfg, tree, batches, total_steps: int, base_lr: float):
    """The JAX package's train step (``repro/launch/steps.py``
    ``build_train_step``) from zero AdamW moments on the parameter tree
    ``tree``, one step a numpy batch of ``batches``: each step's loss,
    learning rate, gradient norm and the L1 norm of its update (float64
    sums), the counterpart of ``chip_smoke.families_train_pinned``."""
    from repro.launch.steps import build_train_step
    from repro.optim import adamw_init
    step_fn = jax.jit(build_train_step(cfg, total_steps=total_steps,
                                       base_lr=base_lr))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = adamw_init(params)
    rows = []
    for batch in batches:
        new, opt, m = step_fn(params, opt, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        l1 = sum(float(np.abs(np.asarray(a, np.float64)
                              - np.asarray(b, np.float64)).sum())
                 for a, b in zip(jax.tree_util.tree_leaves(new),
                                 jax.tree_util.tree_leaves(params)))
        rows.append({"loss": float(m["loss"]), "lr": float(m["lr"]),
                     "grad_norm": float(m["grad_norm"]), "step_l1": l1})
        params = new
    return rows
