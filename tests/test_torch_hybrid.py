"""The port's hybrid family (hymba-1.5b) against the JAX package's.

Reduced hymba: 2 layers, 8 attention heads over 2 KV heads of 32, 16 SSM
heads of 32, state 16, chunk 16, sliding window 64, vocab 512. Each layer
runs windowed self-attention and the SSM mixer on the same input, RMS-norms
both and adds their mean, then a SwiGLU MLP. The JAX package's initial
weights cross with ``repro_torch.convert``; batches come from the
synthetic stream; the JAX side is jitted, its Pallas SSD kernel in
interpret mode.

Tolerances, and why (those of ``tests/test_torch_dense.py``):
  * float32: rtol 1e-4, atol 1e-5 — the same float32 products and sums in
    other orders (XLA contracts some into FMAs);
  * bfloat16: rtol 2e-2, atol 3e-2, two bf16 ulps of values ~1-4: the
    compiled reference keeps some bf16 intermediates in float32 where the
    port rounds them. The float32 SSM state of a bf16 model to rtol 1e-3,
    atol 1e-4, the float32 loss to rtol 1e-3;
  * greedy tokens of ``serve_session`` exactly, in float32.
"""
import dataclasses
import functools
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
from repro.models import transformer as jax_tfm
from repro.models.counting import count_params as jax_count_params
from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch, get_shape, reduced
from repro_torch.data import SyntheticLM
from repro_torch.launch import serving
from repro_torch.launch.serve import serve_session
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm
from repro_torch.models.counting import count_params
from repro_torch.tree import leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
ARCH = "hymba-1.5b"
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=3e-2)}
STATE_TOL = {"float32": TOL["float32"],
             "bfloat16": dict(rtol=1e-3, atol=1e-4)}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
FULL_COUNT = 1_640_820_096      # the reference's count: 3 norms a layer
FULL_LEAVES = 1_640_871_296     # the tree: 4 norms a layer


@functools.lru_cache(maxsize=None)
def _setup(dtype, ssm_pallas=False):
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(ARCH)),
                               param_dtype=dtype, ssm_pallas=ssm_pallas)
    tcfg = dataclasses.replace(reduced(get_arch(ARCH)), param_dtype=dtype,
                               ssm_pallas=ssm_pallas)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, tm, jp, convert.to_torch(_np(jp))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seq, batch=2, seed=1):
    return SyntheticLM(vocab_size=512, seq_len=seq, seed=seed).worker_batch(
        0, 0, batch)


def _close(got, want, dtype, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **tol[dtype])


def _pos(b, p):
    return np.full((b,), p, dtype=np.int32)


def test_reduced_config_has_the_slice_geometry():
    cfg = reduced(get_arch(ARCH))
    assert (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (
        2, 8, 2, 32)
    assert (cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk, cfg.sliding_window) == (16, 32, 16, 16, 64)
    assert tfm.group_kinds(cfg) == ["hybrid"]


# --------------------------------------------------------------------------- #
# the hybrid block
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("collect_cache", [False, True])
def test_hybrid_block_matches_jax(dtype, collect_cache):
    """One hybrid block over 75 positions (past the 64-token window, not a
    multiple of the 16-token chunk): output and its kv / ssm cache."""
    jcfg, tcfg, _, _, jp, tp = _setup(dtype)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 75, tcfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(75), (2, 75)).astype(np.int32)
    jbp = jax.tree_util.tree_map(lambda t: t[0], jp["blocks"])[0]
    tbp = tree_map(lambda t: t[0], tp["blocks"])[0]
    jx = jnp.asarray(x).astype(jcfg.param_dtype)
    want, _, jcache = jax.jit(functools.partial(
        jax_tfm._apply_block, cfg=jcfg, kind="hybrid", ctx={}, window=0,
        collect_cache=collect_cache))(jbp, x=jx, positions=jnp.asarray(pos))
    with torch.inference_mode():
        got, aux, cache = tfm._apply_block(
            tbp, tcfg, "hybrid", torch.from_numpy(x).to(getattr(torch, dtype)),
            torch.from_numpy(pos), {}, window=0, collect_cache=collect_cache)
    assert aux is None and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    assert sorted(cache) == (["kv", "ssm"] if collect_cache else [])
    if collect_cache:
        jl = jax.tree_util.tree_leaves(jcache)
        tl = leaves(cache)
        assert [tuple(t.shape) for t in tl] == [x.shape for x in jl]
        _close(tl[0], jl[0], dtype)                          # k
        _close(tl[1], jl[1], dtype)                          # v
        _close(tl[2], jl[2], dtype, STATE_TOL)               # fp32 S
        _close(tl[3], jl[3], dtype)                          # conv tail


def test_hybrid_block_fuses_both_halves():
    """The block's update is 0.5 * (norm(attention) + norm(SSM)) before the
    MLP: with the MLP's output weights zeroed, dropping either half (its
    norm scale at 0) leaves exactly half of the other's contribution."""
    _, tcfg, _, _, _, tp = _setup("float32")
    bp = tree_map(lambda t: t[0].clone(), tp["blocks"])[0]
    bp["mlp"]["w2"].zero_()
    x = torch.randn((1, 20, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(20)[None]

    def delta(**scales):
        p = {**bp, **{k: bp[k] * v for k, v in scales.items()}}
        with torch.inference_mode():
            return tfm._apply_block(p, tcfg, "hybrid", x, pos, {}, window=0,
                                    collect_cache=False)[0] - x
    both = delta()
    attn_only, ssm_only = delta(norm_ssm=0.0), delta(norm_attn=0.0)
    torch.testing.assert_close(both, attn_only + ssm_only)
    for half in (attn_only, ssm_only):
        assert half.abs().max() > 1e-3


# --------------------------------------------------------------------------- #
# the Model API
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ssm_pallas", [False, True])
def test_logits_and_loss_match_jax(dtype, ssm_pallas):
    """75 positions: the window masks the first 11 keys of the last
    queries; the SSM pads the last chunk."""
    jcfg, tcfg, jm, tm, jp, tp = _setup(dtype, ssm_pallas)
    b = _batch(75)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want, (jloss, _) = jax.jit(
        lambda p, b: (jm.logits_fn(p, b), jm.loss_fn(p, b)))(jp, jb)
    with torch.inference_mode():
        got = tm.logits_fn(tp, tb)
        loss, metrics = tm.loss_fn(tp, tb)
    assert got.shape == (2, 75, 512) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=LOSS_RTOL[dtype])
    assert float(metrics["aux"]) == 0.0


def test_ssd_kernel_path_is_the_chunked_path():
    """With ssm_pallas the stateless forward goes through the SSD wrapper
    (its plain version on the CPU), once a layer; the prefill, which needs
    the last state, does not."""
    from repro_torch.kernels import ssd_scan as ssd
    _, tcfg, _, tm, _, tp = _setup("float32", True)
    _, _, _, plain, _, _ = _setup("float32", False)
    tokens = torch.from_numpy(_batch(40)["tokens"])
    calls = []
    real = ssd.ssd_ref

    def counted(*a):
        calls.append(1)
        return real(*a)
    ssd.ssd_ref = counted
    try:
        with torch.inference_mode():
            got = tm.logits_fn(tp, {"tokens": tokens})
            assert len(calls) == tcfg.n_layers
            tm.prefill(tp, {"tokens": tokens})
            assert len(calls) == tcfg.n_layers
    finally:
        ssd.ssd_ref = real
    with torch.inference_mode():
        want = plain.logits_fn(tp, {"tokens": tokens})
    _close(got, want.numpy(), "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_logits_and_caches_match_jax(dtype):
    jcfg, tcfg, jm, tm, jp, tp = _setup(dtype, True)
    b = _batch(75)
    want, jcache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(b["tokens"])})
    with torch.inference_mode():
        got, cache = tm.prefill(tp, {"tokens": torch.from_numpy(b["tokens"])})
    assert got.shape == (2, 1, 512)
    _close(got, want, dtype)
    assert [sorted(c) for c in cache] == [["kv", "ssm"]]
    jl, tl = jax.tree_util.tree_leaves(jcache), leaves(cache)
    g, kv, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    assert [tuple(t.shape) for t in tl] == [x.shape for x in jl] == [
        (g, 2, 75, kv, hd), (g, 2, 75, kv, hd),
        (g, 2, tcfg.n_ssm_heads, tcfg.ssm_state, tcfg.ssm_head_dim),
        (g, 2, tcfg.ssm_conv - 1, tcfg.d_inner + 2 * tcfg.ssm_state)]
    assert tl[2].dtype == torch.float32
    for i, (t, j) in enumerate(zip(tl, jl)):
        _close(t, j, dtype, STATE_TOL if i == 2 else TOL)


@pytest.mark.parametrize("windowed", [False, True])
def test_init_cache_matches_jax(windowed):
    jcfg, tcfg, jm, tm, _, _ = _setup("bfloat16")
    want = jm.init_cache(3, 24, windowed=windowed)
    got = tm.init_cache(3, 24, windowed=windowed)
    assert [sorted(c) for c in got] == [["kv", "ssm"]]
    is_tensor = lambda x: isinstance(x, torch.Tensor)       # noqa: E731
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, want)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda _: 0, got, is_leaf=is_tensor))
    for t, j in zip(leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}"
        assert not t.any()


def _decode(jm, tm, jp, tp, tokens, cache_len, window):
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


@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_decode_past_the_window_matches_jax_and_the_forward(dtype):
    """A ring of 64 slots (the window) over 80 positions, the last 16
    reusing slots. The forward is windowed at 64 too, so the decode equals
    it at every position, past the window included (float32)."""
    jcfg, tcfg, jm, tm, jp, tp = _setup(dtype, True)
    window = tcfg.sliding_window
    tokens = _batch(80)["tokens"]
    got, want = _decode(jm, tm, jp, tp, tokens, window, window)
    _close(got, want, dtype)
    if dtype == "float32":
        with torch.inference_mode():
            fwd = tm.logits_fn(tp, {"tokens": torch.from_numpy(tokens)})
        _close(got, fwd, "float32")


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def test_serve_session_generates_the_reference_tokens():
    """prompt + new = 80 > the 64-token window: the session's cache is the
    64-slot ring (cache_geometry's architectural sliding window)."""
    jcfg, tcfg, *_ = _setup("float32")
    batch, prompt_len, new_tokens, seed = 2, 60, 20, 0
    shape = JaxShapeConfig(name="decode_32k", seq_len=prompt_len + new_tokens,
                           global_batch=batch, kind="decode")
    assert jax_serving.cache_geometry(jcfg, shape)[:2] == (64, 64)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
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
    _close(stats["replay_logits"], stats["prefill_logits"].numpy(), "float32")


@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
def test_cache_geometry_and_specs_match_reference(shape_name):
    for full in (True, False):
        jcfg, tcfg = jax_get_arch(ARCH), get_arch(ARCH)
        if not full:
            jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
        jshape, tshape = jax_get_shape(shape_name), get_shape(shape_name)
        geometry = serving.cache_geometry(tcfg, tshape)
        assert geometry == jax_serving.cache_geometry(jcfg, jshape)
        assert geometry[1] == tcfg.sliding_window          # always windowed
        jcache = jax.tree_util.tree_leaves(
            jax_serving.decode_cache_specs(jcfg, jshape))
        tcache = leaves(serving.decode_cache_specs(tcfg, tshape))
        assert [(tuple(s.shape), str(s.dtype)) for s in jcache] == [
            (s.shape, str(s.dtype).replace("torch.", "")) for s in tcache]


def test_serve_cli_runs_hymba_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "4"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "generated (2, 4) tokens" in proc.stdout


# --------------------------------------------------------------------------- #
# configuration and parameter counts
# --------------------------------------------------------------------------- #
def test_config_is_the_reference_config():
    assert ARCH in ARCHS
    for full in (True, False):
        jcfg, tcfg = jax_get_arch(ARCH), get_arch(ARCH)
        if not full:
            jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_param_count_is_the_references_three_norm_count():
    """The reference counts 3 norms of d_model a hybrid layer; the layer
    holds 4 (ln1, ln2, norm_attn, norm_ssm). The port keeps the reference's
    count; its tree has n_layers * d_model parameters more."""
    full = get_arch(ARCH)
    assert count_params(full) == jax_count_params(jax_get_arch(ARCH)) == \
        full.param_count() == FULL_COUNT
    meta = build_model(full).init(None, "meta")
    assert sum(t.numel() for t in leaves(meta)) == FULL_LEAVES == \
        FULL_COUNT + full.n_layers * full.d_model
    small = reduced(full)
    tree = build_model(small).init(torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in leaves(tree)) == \
        count_params(small) + small.n_layers * small.d_model


def test_param_tree_has_the_reference_layout():
    jcfg, tcfg, jm, tm, jp, tp = _setup("bfloat16")
    fresh = tm.init(torch.Generator().manual_seed(0))
    want = [(tuple(x.shape), str(x.dtype)) for x in
            jax.tree_util.tree_leaves(jp)]
    assert len(want) == 21
    for tree in (tp, fresh):
        assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for t in leaves(tree)] == want
    assert sorted(fresh["blocks"][0]) == [
        "attn", "ln1", "ln2", "mlp", "norm_attn", "norm_ssm", "ssm"]
