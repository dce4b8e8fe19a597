"""The port's dense decoder family against the JAX package's.

Reduced qwen2-7b (QKV bias, untied head) and phi4-mini-3.8b (tied head):
2 layers, 8 heads over 2 KV heads of 32, vocab 512, sliding window 64. The
JAX package's initial weights cross with ``repro_torch.convert``; batches
come from the synthetic stream; the JAX side is jitted.

Tolerances, and why:
  * float32: rtol 1e-4, atol 1e-5 (measured: 2.4e-6 on logits of magnitude
    ~1.7 over 2 x 2100 tokens). Both sides take the same float32 products
    and sums in other orders, and XLA contracts some into FMAs.
  * bfloat16 (the default dtype): logits and caches to rtol 2e-2 and atol
    3e-2, two bf16 ulps of values ~1-4 (measured: 1.6e-2 on logits, 3.1e-2
    on a few cache values of ~2): the compiled reference keeps some bf16
    intermediates in float32 (XLA's excess precision) where the port rounds
    them. The float32 loss to rtol 1e-3.
  * Greedy tokens of ``serve_session`` exactly, in float32: only a near-tie
    between the top two logits of a step could tell them apart.
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
from repro.configs import get_shape as jax_get_shape
from repro.configs import reduced as jax_reduced
from repro.launch import serving as jax_serving
from repro.launch.serve import serve_session as jax_serve_session
from repro.models import build_model as jax_build_model
from repro.models.counting import count_params as jax_count_params
from repro_torch import convert
from repro_torch.configs import ARCHS, NOT_PORTED, get_arch, get_shape, reduced
from repro_torch.data import SyntheticLM
from repro_torch.launch import serving
from repro_torch.launch.serve import serve_session
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm
from repro_torch.models.counting import count_params
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["qwen2-7b", "phi4-mini-3.8b", "minitron-4b"]
REDUCED = ["qwen2-7b", "phi4-mini-3.8b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=3e-2)}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype):
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(arch)),
                               param_dtype=dtype)
    tcfg = dataclasses.replace(reduced(get_arch(arch)), param_dtype=dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, tm, jp, convert.to_torch(_np(jp))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seq, batch=2, seed=1):
    return SyntheticLM(vocab_size=512, seq_len=seq, seed=seed).worker_batch(
        0, 0, batch)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **TOL[dtype])


def _pos(b, p):
    return np.full((b,), p, dtype=np.int32)


# --------------------------------------------------------------------------- #
# the Model API
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,dtype,batch,seq", [
    (arch, dtype, 2, 40) for arch in REDUCED for dtype in DTYPES] + [
    ("qwen2-7b", "float32", 1, 2100), ("qwen2-7b", "bfloat16", 1, 2100),
    ("phi4-mini-3.8b", "float32", 1, 2100)])
def test_logits_and_loss_match_jax(arch, dtype, batch, seq):
    """2100 tokens take the blockwise path (over 2 x 1024 keys): three
    blocks of 1024, the last padded with 972 keys."""
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, dtype)
    b = _batch(seq, batch)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want = jax.jit(jm.logits_fn)(jp, jb)
    (jloss, _) = jax.jit(jm.loss_fn)(jp, jb)
    with torch.inference_mode():
        got = tm.logits_fn(tp, tb)
        loss, metrics = tm.loss_fn(tp, tb)
    assert got.shape == (batch, seq, 512) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=LOSS_RTOL[dtype])
    assert float(metrics["aux"]) == 0.0


@pytest.mark.parametrize("arch", REDUCED)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 16])
def test_prefill_logits_and_kv_caches_match_jax(arch, dtype, window):
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, dtype)
    b = _batch(40)
    want, jcache = jax.jit(functools.partial(jm.prefill, window=window))(
        jp, {"tokens": jnp.asarray(b["tokens"])})
    with torch.inference_mode():
        got, cache = tm.prefill(tp, {"tokens": torch.from_numpy(b["tokens"])},
                                window=window)
    assert got.shape == (2, 1, 512)
    _close(got, want, dtype)
    jl, tl = jax.tree_util.tree_leaves(jcache), leaves(cache)
    assert [c.keys() for c in cache] == [{"kv": 0}.keys()]
    assert [tuple(t.shape) for t in tl] == [x.shape for x in jl] == [
        (tcfg.n_layers, 2, 40, tcfg.n_kv_heads, tcfg.head_dim)] * 2
    for t, j in zip(tl, jl):
        _close(t, j, dtype)


@pytest.mark.parametrize("arch", REDUCED)
@pytest.mark.parametrize("windowed", [False, True])
def test_init_cache_matches_jax(arch, windowed):
    jcfg, tcfg, jm, tm, _, _ = _setup(arch, "bfloat16")
    want = jm.init_cache(3, 24, windowed=windowed)
    got = tm.init_cache(3, 24, windowed=windowed)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, want)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda _: 0, got,
                                   is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for t, j in zip(leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}"
        assert not t.any()


def _decode(jm, tm, jp, tp, cfg, tokens, cache_len, window):
    """decode_step over every position of ``tokens`` from a zero cache, in
    both packages; returns the two stacks of logits (B, S, V)."""
    B, S = tokens.shape
    jcache = jm.init_cache(B, cache_len, windowed=bool(window))
    tcache = tm.init_cache(B, cache_len, windowed=bool(window))
    jstep = jax.jit(functools.partial(jm.decode_step, window=window))
    jout, tout = [], []
    with torch.inference_mode():
        for p in range(S):
            tok = tokens[:, p:p + 1]
            jl, jcache = jstep(jp, jcache, jnp.asarray(tok),
                               jnp.asarray(_pos(B, p)))
            tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                        torch.from_numpy(_pos(B, p)),
                                        window=window)
            jout.append(np.asarray(jl)[:, 0])
            tout.append(tl[:, 0])
    return torch.stack(tout, dim=1), np.stack(jout, axis=1)


@pytest.mark.parametrize("arch", REDUCED)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_over_a_prompt_matches_jax_and_the_forward(arch, dtype):
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, dtype)
    tokens = _batch(24)["tokens"]
    got, want = _decode(jm, tm, jp, tp, tcfg, tokens, 24, 0)
    _close(got, want, dtype)
    with torch.inference_mode():
        fwd = tm.logits_fn(tp, {"tokens": torch.from_numpy(tokens)})
    _close(got, fwd.float(), dtype)


@pytest.mark.parametrize("arch", REDUCED)
def test_windowed_decode_past_the_window_matches_jax(arch):
    """A ring of 64 slots (the reduced sliding window) over 80 positions:
    the first 64 see the whole prefix, as the unwindowed forward does; the
    last 16 reuse slots."""
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, "float32")
    window = tcfg.sliding_window
    assert window == 64
    tokens = _batch(80)["tokens"]
    got, want = _decode(jm, tm, jp, tp, tcfg, tokens, window, window)
    _close(got, want, "float32")
    with torch.inference_mode():
        fwd = tm.logits_fn(tp, {"tokens": torch.from_numpy(tokens)})
    _close(got[:, :window], fwd[:, :window], "float32")
    assert not np.allclose(got[:, window:].numpy(), fwd[:, window:].numpy(),
                           **TOL["float32"])


def test_other_families_and_kinds_still_raise():
    """Every architecture is registered (llama3-405b builds on the meta
    device; training it waits for several cards); an unknown layer kind
    raises; the hybrid kind on a dense config now builds."""
    assert NOT_PORTED == ()
    big = build_model(get_arch("llama3-405b")).init(None, "meta")
    assert sum(t.numel() for t in leaves(big)) == 405_853_388_800
    with pytest.raises(ValueError, match="unknown layer kind"):
        tfm._init_block(None, reduced(get_arch("qwen2-7b")), "no_such_kind",
                        torch.float32, "meta")
    hybrid = dataclasses.replace(reduced(get_arch("qwen2-7b")),
                                 family="hybrid", hybrid=True, ssm_state=16)
    params = build_model(hybrid).init(None, "meta")
    assert tfm.group_kinds(hybrid) == ["hybrid"]
    assert {"attn", "ssm", "norm_attn", "norm_ssm"} <= set(
        params["blocks"][0])


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", REDUCED)
def test_serve_session_generates_the_reference_tokens(arch):
    jcfg, tcfg, *_ = _setup(arch, "float32")
    batch, prompt_len, new_tokens, seed = 2, 12, 8, 0
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    shape = JaxShapeConfig(name="decode_32k", seq_len=prompt_len + new_tokens,
                           global_batch=batch, kind="decode")
    with mesh:
        # the weights jax serve_session draws: its programs' init at `seed`
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
    assert stats["decode_steps"] == prompt_len - 1 + new_tokens
    _close(stats["replay_logits"], stats["prefill_logits"].numpy(), "float32")


def test_serve_cli_defaults_to_qwen2_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--batch", "2", "--prompt-len", "8", "--new-tokens",
         "4"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "generated (2, 4) tokens" in proc.stdout
    rows = [ln for ln in proc.stdout.splitlines() if ln.strip().startswith("[")]
    assert len(rows) == 2 and all(len(json.loads(r)) == 4 for r in rows)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
def test_cache_geometry_and_specs_match_reference(arch, shape_name):
    for full in (True, False):
        jcfg, tcfg = jax_get_arch(arch), get_arch(arch)
        if not full:
            jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
        jshape, tshape = jax_get_shape(shape_name), get_shape(shape_name)
        assert (serving.cache_geometry(tcfg, tshape)
                == jax_serving.cache_geometry(jcfg, jshape))
        jspecs = jax_serving.serve_batch_specs(jcfg, jshape)
        tspecs = serving.serve_batch_specs(tcfg, tshape)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in
                {**jspecs["prefill"], "token": jspecs["token"],
                 "pos": jspecs["pos"]}.items()} == {
            k: (v.shape, str(v.dtype).replace("torch.", "")) for k, v in
            {**tspecs["prefill"], "token": tspecs["token"],
             "pos": tspecs["pos"]}.items()}
        jcache = jax.tree_util.tree_leaves(
            jax_serving.decode_cache_specs(jcfg, jshape))
        tcache = leaves(serving.decode_cache_specs(tcfg, tshape))
        assert [(tuple(s.shape), str(s.dtype)) for s in jcache] == [
            (s.shape, str(s.dtype).replace("torch.", "")) for s in tcache]


# --------------------------------------------------------------------------- #
# configurations and parameter counts
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", DENSE)
def test_config_is_the_reference_config(arch):
    assert arch in ARCHS
    for full in (True, False):
        jcfg, tcfg = jax_get_arch(arch), get_arch(arch)
        if not full:
            jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_reference_and_tree(arch):
    full = get_arch(arch)
    assert count_params(full) == jax_count_params(jax_get_arch(arch)) == \
        full.param_count()
    small = reduced(full)
    tree = build_model(small).init(torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in leaves(tree)) == count_params(small)
    if arch == "qwen2-7b":
        assert count_params(full) == 7_615_616_512


@pytest.mark.parametrize("arch", REDUCED)
def test_param_tree_has_the_reference_layout(arch):
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, "bfloat16")
    fresh = tm.init(torch.Generator().manual_seed(0))
    want = [(tuple(x.shape), str(x.dtype)) for x in
            jax.tree_util.tree_leaves(jp)]
    for tree in (tp, fresh):
        assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for t in leaves(tree)] == want
    assert ("lm_head" in fresh) == (not tcfg.tie_embeddings)
