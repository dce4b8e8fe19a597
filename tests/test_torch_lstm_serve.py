"""The Big LSTM's Model API and serving against the JAX package's.

Reduced Big LSTM (2 layers, 256 hidden, 64 projection, vocab 512) with the
JAX package's initial weights carried across by ``repro_torch.convert``;
the JAX side is jitted.

Tolerances, and why:
  * float32: rtol 1e-4, atol 1e-5, as the dense family's (measured: ~1e-6).
    The same products and sums in other orders over up to 24 recurrent
    steps.
  * Greedy tokens of ``serve_session`` exactly, in float32.
  * Dropout draws from a ``torch.Generator``, so its masks are not JAX's:
    the keep share is held within 0.03 of 0.9 (about six standard errors
    over the 4,096 embedding values) and the kept values to exactly
    x / f32(0.9).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import ShapeConfig as JaxShapeConfig
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.launch import serving as jax_serving
from repro.launch.serve import serve_session as jax_serve_session
from repro.models import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.data import SyntheticLM
from repro_torch.launch import serving
from repro_torch.launch.serve import serve_session
from repro_torch.launch.steps import worker_grads
from repro_torch.models import build_model, lstm
from repro_torch.tree import leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch("biglstm")),
                               param_dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch("biglstm")),
                               param_dtype="float32")
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(7))
    return jcfg, tcfg, jm, tm, jp, convert.to_torch(_np(jp))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seq=16, batch=4, seed=3):
    return SyntheticLM(vocab_size=512, seq_len=seq, seed=seed).worker_batch(
        0, 5, batch)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _pos(b, p):
    return np.full((b,), p, dtype=np.int32)


def test_build_model_builds_the_lstm():
    _, tcfg, _, tm, _, tp = _setup()
    fresh = tm.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in leaves(fresh)] == [
        tuple(t.shape) for t in leaves(tp)]


def test_logits_and_loss_without_rng_match_jax_and_the_training_path():
    jcfg, tcfg, jm, tm, jp, tp = _setup()
    b = _batch()
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want = jax.jit(jm.logits_fn)(jp, jb)
    jloss, _ = jax.jit(jm.loss_fn)(jp, jb)
    # the training path's: one stacked worker through worker_grads
    train_loss = worker_grads(tree_map(lambda t: t[None], tp),
                              {k: v[None] for k, v in tb.items()}, tm)[0][0]
    with torch.no_grad():
        got = tm.logits_fn(tp, tb)
        loss, metrics = tm.loss_fn(tp, tb)
    _close(got, want)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(loss) == float(train_loss)
    assert float(metrics["aux"]) == 0.0


def test_prefill_matches_jax_and_the_forward():
    jcfg, tcfg, jm, tm, jp, tp = _setup()
    tokens = _batch()["tokens"]
    want, jstate = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, state = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)})
        fwd = tm.logits_fn(tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (4, 1, 512)
    _close(got, want)
    _close(got[:, 0], fwd[:, -1])            # the head once, at the end
    assert isinstance(state, list) and len(state) == tcfg.n_layers
    for t, j in zip(leaves(state), jax.tree_util.tree_leaves(jstate)):
        assert tuple(t.shape) == j.shape
        _close(t, j)


def test_init_cache_matches_jax_and_ignores_the_length():
    jcfg, tcfg, jm, tm, _, _ = _setup()
    want = jm.init_cache(3, 24)
    for L in (24, 1000):
        got = tm.init_cache(3, L)
        assert [type(x) for x in got] == [tuple] * tcfg.n_layers
        assert [(tuple(t.shape), str(t.dtype)) for t in leaves(got)] == [
            (x.shape, f"torch.{x.dtype}") for x in
            jax.tree_util.tree_leaves(want)]
        assert not any(t.any() for t in leaves(got))
    meta = tm.init_cache(3, 24, device="meta")
    assert all(t.device.type == "meta" for t in leaves(meta))


def test_decode_steps_match_jax_and_the_forward():
    jcfg, tcfg, jm, tm, jp, tp = _setup()
    tokens = _batch(seq=12)["tokens"]
    B = tokens.shape[0]
    jcache, tcache = jm.init_cache(B, 12), tm.init_cache(B, 12)
    jstep = jax.jit(jm.decode_step)
    got, want = [], []
    with torch.no_grad():
        for p in range(tokens.shape[1]):
            tok = tokens[:, p:p + 1]
            jl, jcache = jstep(jp, jcache, jnp.asarray(tok),
                               jnp.asarray(_pos(B, p)))
            tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                        torch.from_numpy(_pos(B, p)))
            assert tl.shape == (B, 1, 512)
            got.append(tl[:, 0])
            want.append(np.asarray(jl)[:, 0])
        fwd = tm.logits_fn(tp, {"tokens": torch.from_numpy(tokens)})
    _close(torch.stack(got, 1), np.stack(want, 1))
    _close(torch.stack(got, 1), fwd)
    for t, j in zip(leaves(tcache), jax.tree_util.tree_leaves(jcache)):
        _close(t, j)


def test_dropout_masks_and_scaling(monkeypatch):
    """With a generator: one mask on the embeddings, then one on each
    layer's outputs, in that order; keep share near 0.9; kept values
    x / f32(0.9) exactly; the same seed gives the same logits."""
    _, tcfg, _, tm, _, tp = _setup()
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    calls = []
    real = lstm.dropout

    def spy(gen, x, rate, deterministic):
        out = real(gen, x, rate, deterministic)
        calls.append((x, out, rate, deterministic))
        return out

    monkeypatch.setattr(lstm, "dropout", spy)
    with torch.no_grad():
        loss, _ = tm.loss_fn(tp, b, rng=torch.Generator().manual_seed(1))
    B, S = b["tokens"].shape
    assert [tuple(x.shape) for x, *_ in calls] == \
        [(B, S, tcfg.lstm_proj)] + [(S, B, tcfg.lstm_proj)] * tcfg.n_layers
    for x, out, rate, deterministic in calls:
        assert rate == 0.1 and not deterministic
        kept = out != 0
        assert abs(float(kept.float().mean()) - 0.9) < 0.03
        assert torch.equal(out[kept], (x / torch.tensor(0.9))[kept])
    monkeypatch.setattr(lstm, "dropout", real)
    with torch.no_grad():
        plain, _ = tm.loss_fn(tp, b)
        again, _ = tm.loss_fn(tp, b, rng=torch.Generator().manual_seed(1))
        other, _ = tm.loss_fn(tp, b, rng=torch.Generator().manual_seed(2))
    assert float(again) == float(loss) != float(plain)
    assert float(other) != float(loss)


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def test_serve_session_generates_the_reference_tokens():
    jcfg, tcfg, *_ = _setup()
    batch, prompt_len, new_tokens, seed = 2, 12, 8, 0
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    shape = JaxShapeConfig(name="decode_32k", seq_len=prompt_len + new_tokens,
                           global_batch=batch, kind="decode")
    with mesh:
        jparams = jax_serving.build_serve_programs(jcfg, shape, mesh).init_fn(
            jax.random.PRNGKey(seed))
        want, _ = jax_serve_session(jcfg, batch=batch, prompt_len=prompt_len,
                                    new_tokens=new_tokens, seed=seed,
                                    mesh=mesh, verbose=False)
    stats = {}
    got, tps = serve_session(tcfg, batch=batch, prompt_len=prompt_len,
                             new_tokens=new_tokens, seed=seed, device="cpu",
                             params=convert.to_torch(_np(jparams)),
                             verbose=False, stats=stats)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert tps > 0 and stats["logits_finite"]
    _close(stats["replay_logits"], stats["prefill_logits"])


def test_cache_specs_match_reference():
    for full in (True, False):
        jcfg, tcfg = jax_get_arch("biglstm"), get_arch("biglstm")
        if not full:
            jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
        shape = ShapeConfig("d", seq_len=544, global_batch=8, kind="decode")
        jshape = JaxShapeConfig("d", seq_len=544, global_batch=8,
                                kind="decode")
        assert (serving.cache_geometry(tcfg, shape)
                == jax_serving.cache_geometry(jcfg, jshape))
        jspecs = jax_serving.decode_cache_specs(jcfg, jshape)
        tspecs = serving.decode_cache_specs(tcfg, shape)
        assert len(tspecs) == len(jspecs) == tcfg.n_layers
        assert [(s.shape, str(s.dtype).replace("torch.", ""))
                for s in leaves(tspecs)] == [
            (tuple(s.shape), str(s.dtype))
            for s in jax.tree_util.tree_leaves(jspecs)]


def test_serve_cli_runs_biglstm_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "biglstm", "--reduced", "--batch", "2", "--prompt-len",
         "8", "--new-tokens", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "generated (2, 4) tokens" in proc.stdout
    rows = [ln for ln in proc.stdout.splitlines() if ln.strip().startswith("[")]
    assert len(rows) == 2 and all(len(json.loads(r)) == 4 for r in rows)
