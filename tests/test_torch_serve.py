"""The port's batched serving driver against the JAX package's: the loop
of ``repro/launch/serve.py`` on the same weights (the JAX init, carried
across) and the same prompts gives the same greedy tokens, in fp32 on the
CPU; ``serve()`` reports what the JAX ``serve()`` reports."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import dataclasses  # noqa: E402

from _lm_reference import (DENSE_ARCHS, jax_config,  # noqa: E402
                           jax_params, serve_tokens)
from repro.launch import serve as repro_serve  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

# three requests in batches of two: a full batch, then a ragged one
N_REQUESTS, BATCH, PROMPT, MAX_NEW = 3, 2, 8, 4


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_serving_loop_tokens_equal_jax(arch):
    cfg_t = dataclasses.replace(configs.get(arch).reduced(), dtype="float32")
    cfg_j = jax_config(arch)
    tree = jax_params(arch)
    requests = serve.make_requests(cfg_t, N_REQUESTS, PROMPT, MAX_NEW,
                                   seed=3)
    # the JAX serve()'s draws, in its order
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg_j.vocab, size=PROMPT, dtype=np.int32)
               for _ in range(N_REQUESTS)]
    assert all(np.array_equal(r.prompt, p) for r, p in zip(requests,
                                                           prompts))
    want = serve_tokens(cfg_j, tree, prompts, BATCH, PROMPT, MAX_NEW)
    before = ops.launch_counts()
    done = serve.serve_requests(cfg_t, M.params_from_numpy(cfg_t, tree,
                                                           "cpu"),
                                requests, BATCH, PROMPT, MAX_NEW, "cpu")
    assert ops.launch_counts() == before
    assert [r.rid for r in done] == list(range(N_REQUESTS))
    assert [r.generated for r in done] == want
    assert all(len(g) == MAX_NEW for g in want)
    assert all(r.t_arrive <= r.t_start <= r.t_first <= r.t_done
               for r in done)


def test_serve_reports_what_the_jax_serve_reports():
    args = ("tinyllama-1.1b", 3, 2, 6, 2)
    want = repro_serve.serve(*args, seed=1)
    got = serve.serve(*args, seed=1, device="cpu")
    assert set(want) <= set(got)
    assert (got["requests"], got["tokens"]) == (want["requests"],
                                                want["tokens"]) == (3, 6)
    assert got["device"] == "cpu"
    assert got["latency_ms_p50"] <= got["latency_ms_p99"]
    assert 0 < got["prefill_s"] + got["decode_s"] <= got["wall_s"]


def test_serving_loop_rejects_an_empty_budget():
    cfg = configs.get("tinyllama-1.1b").reduced()
    with pytest.raises(ValueError, match="max_new"):
        serve.serve_requests(cfg, {}, [], 2, 4, 0, "cpu")


def test_serve_cli_runs_on_the_cpu_when_asked(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "tinyllama-1.1b",
        "--requests", "2", "--batch", "2", "--prompt-len", "4",
        "--max-new", "2", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "requests: 2" in out and "tokens: 4" in out
    assert "device: cpu" in out
