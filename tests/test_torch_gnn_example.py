"""The twin of ``examples/gnn_cached_sampling.py``
(``examples/gnn_cached_sampling_torch.py``) against the JAX example itself,
on the CPU.

The JAX example runs whole (``runpy``), its loop reporting each epoch's
loss, sampler hits and misses and the gRW-Tx's invalidated keys; the twin's
``run(device="cpu")`` must report the same hits, misses and invalidated
keys epoch by epoch, and, started from the JAX example's parameters
(``init_params`` at ``PRNGKey(0)``, carried across by ``interop``), losses
within 1e-4 (four PNA train steps of fp32 sums in another order).

The reference sampler calls ``cache_lookup`` and ``gather_out`` eagerly
(~0.5 s a lookup on the CPU); the test hands it the same two functions
under ``jax.jit``, which compute the same arrays. The example's jitted train
step is wrapped so that its losses are read off, exactly, outside the jit.
"""

import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import torch
from test_torch_fixtures import _torch_test_env  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-4


def _jax_example(monkeypatch, capsys):
    import repro.core.cache as j_cache
    import repro.gnn.models as j_models
    import repro.graphstore.store as j_store

    monkeypatch.setattr(j_cache, "cache_lookup", jax.jit(j_cache.cache_lookup, static_argnums=0))
    monkeypatch.setattr(j_store, "gather_out", jax.jit(j_store.gather_out, static_argnums=(0, 3)))
    losses = []
    real_jit, real_step = jax.jit, j_models.train_step

    def train_step(cfg, opt):
        step = real_step(cfg, opt)
        step.read_losses = True
        return step

    def jit(fn, *a, **kw):
        if not getattr(fn, "read_losses", False):
            return real_jit(fn, *a, **kw)
        jitted = real_jit(fn, *a, **kw)

        def step(*args):
            out = jitted(*args)
            losses.append(float(out[2]["loss"]))
            return out

        return step

    monkeypatch.setattr(j_models, "train_step", train_step)
    monkeypatch.setattr(jax, "jit", jit)
    g = runpy.run_path(str(ROOT / "examples" / "gnn_cached_sampling.py"))
    monkeypatch.setattr(jax, "jit", real_jit)
    lines = re.findall(r"epoch (\d+): loss=\S+ sampler hits=(\d+) misses=(\d+) invalidated=(\d+)",
                       capsys.readouterr().out)
    epochs = [dict(hits=int(h), misses=int(m), impacted_keys=int(i)) for _, h, m, i in lines]
    return epochs, losses, g


def test_twin_matches_the_jax_example(monkeypatch, capsys):
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    import gnn_cached_sampling_torch as twin
    from repro.gnn.models import init_params as j_init
    from repro_torch import interop

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        epochs, losses, g = _jax_example(monkeypatch, capsys)
        assert len(epochs) == len(losses) == 4 and g["sampler"].hits > 0
        params = interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, j_init(g["cfg"], jax.random.PRNGKey(0))), "cpu")
        assert twin.CFG.__dict__ == g["cfg"].__dict__
        got, sampler = twin.run(device="cpu", params=params, log=lambda *_: None)
    finally:
        torch.set_num_threads(n)
        sys.modules.pop("gnn_cached_sampling_torch", None)
    for e, (mine, ref) in enumerate(zip(got, epochs)):
        assert {k: mine[k] for k in ref} == ref, e
    np.testing.assert_allclose([r["loss"] for r in got], losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert sampler.hits > 0 and any(r["impacted_keys"] for r in got)
