"""The port's cross-attention, VLM and encoder-decoder families and fused
cross-entropy against the JAX package's.

``cross_attention_full`` / ``_cached`` (non-causal, position 0 on both
sides, no RoPE), including the blockwise path over 2,500 keys, whose last
block the reference pads with zero keys that non-causal attention does not
mask; the reduced llama-3.2-vision (a cross-attention layer every 2nd, 16
image tokens) and seamless-m4t (2 encoder + 2 decoder layers, GELU, MHA)
through the Model API with non-zero image embeddings / audio frames (the
reference's ``make_train_batch`` stubs, scale 0.02) and, for the VLM, a
non-zero tanh gate (the reference initialises it to 0, where the image
layers add nothing); their ``serve_session`` tokens; ``fused_softmax_xent``
value and gradient against ``jax.value_and_grad``. Weights come from the
reference's ``init`` via ``repro_torch.convert``; the JAX side is jitted.

Tolerances, and why:
  * float32: rtol 1e-4, atol 1e-5 (measured: ~2e-6 on logits of magnitude
    ~1.3; 5e-8 on the padded blockwise cross-attention). The same float32
    products and sums in other orders; XLA contracts some into FMAs.
  * bfloat16: rtol 2e-2, atol 3e-2 on values ~1-4, two bf16 ulps (measured:
    1.6e-2 on logits): the compiled reference keeps some bf16 intermediates
    in float32 where the port rounds them. Caches to atol 5e-2.
  * fused cross-entropy: the value rtol 1e-6, the gradient rtol 1e-5 and
    atol 1e-8 in float32 (one exp, one division and a product by 1/n per
    element); a bf16 gradient to one bf16 ulp (rtol 8e-3, atol 1e-6).
  * greedy tokens of ``serve_session`` exactly, in float32.
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
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import ShapeConfig as JaxShapeConfig
from repro.configs import get_arch as jax_get_arch
from repro.configs import get_shape as jax_get_shape
from repro.configs import reduced as jax_reduced
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.data.synthetic import make_train_batch
from repro.launch import serving as jax_serving
from repro.launch.serve import serve_session as jax_serve_session
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models.model import fused_softmax_xent as jax_fused_xent
from repro_torch import convert
from repro_torch.configs import get_arch, get_shape, reduced
from repro_torch.launch import serving
from repro_torch.launch.serve import serve_session
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.model import fused_softmax_xent, softmax_xent
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
BF16 = ml_dtypes.bfloat16
VLM, AUDIO = "llama-3.2-vision-11b", "seamless-m4t-large-v2"
CROSS = [VLM, AUDIO]
NEW = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b", VLM, AUDIO]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=3e-2)}
CACHE_TOL = {"float32": TOL["float32"], "bfloat16": dict(rtol=2e-2, atol=5e-2)}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
GATE = 0.7
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **tol)


# --------------------------------------------------------------------------- #
# cross-attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [np.float32, BF16])
@pytest.mark.parametrize("skv", [16, 2500])
def test_cross_attention_full_and_cached_match_jax(dtype, skv):
    """16 keys take the direct path; 2,500 the blockwise one (three blocks
    of 1,024, the last padded with 572 unmasked zero keys)."""
    name = "float32" if dtype == np.float32 else "bfloat16"
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(VLM)),
                               param_dtype=name)
    tcfg = dataclasses.replace(reduced(get_arch(VLM)), param_dtype=name)
    jp = jattn.init_attention(jax.random.PRNGKey(2), jcfg, jnp.dtype(name))
    tp = convert.to_torch(_np(jp))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, tcfg.d_model)).astype(dtype)
    src = rng.standard_normal((2, skv, tcfg.d_model)).astype(dtype)
    want, (jk, jv) = jax.jit(lambda p, a, b: jattn.cross_attention_full(
        p, a, b, jcfg))(jp, x, src)
    with torch.inference_mode():
        got, (k, v) = attn.cross_attention_full(
            tp, convert.to_torch(x), convert.to_torch(src), tcfg)
        cached = attn.cross_attention_cached(tp, convert.to_torch(x), k, v,
                                             tcfg)
    tol = TOL[name]
    _close(got, want, tol)
    _close(k, jk, tol)
    _close(v, jv, tol)
    want_cached = jax.jit(lambda p, a, k, v: jattn.cross_attention_cached(
        p, a, k, v, jcfg))(jp, x, jk, jv)
    _close(cached, want_cached, tol)
    if skv == 2500:
        # the padded keys enter the non-causal softmax: the blockwise output
        # is off the direct one, in both packages
        assert not np.allclose(got.float().numpy(),
                               cached.float().numpy(), **TOL["float32"])
    else:
        _close(got, cached.float(), tol)


# --------------------------------------------------------------------------- #
# the VLM and encoder-decoder Model API
# --------------------------------------------------------------------------- #
def _gated(params):
    """The params with every cross layer's tanh gate set to GATE."""
    blocks = [{**b, "gate": b["gate"] + GATE} if "gate" in b else b
              for b in params["blocks"]]
    return {**params, "blocks": blocks}


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype):
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(arch)),
                               param_dtype=dtype)
    tcfg = dataclasses.replace(reduced(get_arch(arch)), param_dtype=dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    if arch == VLM:
        jp = _gated(jp)
    return jcfg, tcfg, jm, tm, jp, convert.to_torch(_np(jp))


def _batch(jcfg, seq, batch=2, seed=1):
    """Tokens, labels and the reference's modality stubs (scale 0.02)."""
    shape = JaxShapeConfig("t", seq_len=seq, global_batch=batch, kind="train")
    return make_train_batch(jcfg, shape, JaxSyntheticLM(
        vocab_size=jcfg.vocab_size, seq_len=seq, seed=seed), 0)


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: convert.to_torch(v) for k, v in b.items()})


@pytest.mark.parametrize("arch", CROSS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_logits_and_loss_match_jax(arch, dtype):
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, dtype)
    b = _batch(jcfg, 40)
    assert {"image_embeds", "audio_frames"} & set(b)
    jb, tb = _both(b)
    want = jax.jit(jm.logits_fn)(jp, jb)
    jloss, jmet = jax.jit(jm.loss_fn)(jp, jb)
    with torch.inference_mode():
        got = tm.logits_fn(tp, tb)
        loss, met = tm.loss_fn(tp, tb)
    assert got.shape == (2, 40, 512)
    _close(got, want, TOL[dtype])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL[dtype])
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    # the image embeddings / audio frames reach the logits (by less than a
    # bf16 ulp through the VLM's gate: checked in float32)
    quiet = {**tb, **{k: torch.zeros_like(v) for k, v in tb.items()
                      if k in ("image_embeds", "audio_frames")}}
    if dtype == "float32":
        with torch.inference_mode():
            assert not torch.allclose(tm.logits_fn(tp, quiet), got,
                                      **TOL[dtype])


def test_vlm_gate_zero_at_init_adds_nothing():
    jcfg, tcfg, jm, tm, jp, tp = _setup(VLM, "float32")
    fresh = tm.init(torch.Generator().manual_seed(0))
    assert not fresh["blocks"][-1]["gate"].any()
    ungated = {**tp, "blocks": [{**b, "gate": torch.zeros_like(b["gate"])}
                                if "gate" in b else b for b in tp["blocks"]]}
    _, tb = _both(_batch(jcfg, 24))
    quiet = {**tb, "image_embeds": torch.zeros_like(tb["image_embeds"])}
    with torch.inference_mode():
        torch.testing.assert_close(tm.logits_fn(ungated, tb),
                                   tm.logits_fn(ungated, quiet), rtol=0,
                                   atol=0)


def test_encoder_is_not_causal():
    """The encoder output at frame 0 depends on the last frame."""
    jcfg, tcfg, jm, tm, jp, tp = _setup(AUDIO, "float32")
    _, tb = _both(_batch(jcfg, 24))
    moved = dict(tb)
    moved["audio_frames"] = tb["audio_frames"].clone()
    moved["audio_frames"][:, -1] += 1.0
    with torch.inference_mode():
        a = tm.prefill(tp, tb)[1][0]["xkv"][0]          # (g,B,F,KV,hd)
        b = tm.prefill(tp, moved)[1][0]["xkv"][0]
    assert not torch.allclose(a[:, :, 0], b[:, :, 0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", CROSS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_caches_match_jax(arch, dtype):
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, dtype)
    b = _batch(jcfg, 40)
    b.pop("labels")
    jb, tb = _both(b)
    want, jcache = jax.jit(jm.prefill)(jp, jb)
    with torch.inference_mode():
        got, cache = tm.prefill(tp, tb)
    _close(got, want, TOL[dtype])
    jl, tl = jax.tree_util.tree_leaves(jcache), leaves(cache)
    assert [tuple(t.shape) for t in tl] == [x.shape for x in jl]
    assert all("xkv" in c for c in cache) == (arch == AUDIO)
    for t, j in zip(tl, jl):
        _close(t, j, CACHE_TOL[dtype])


def _with_xkv(cache, pre):
    """The decode cache with the prefill's cross-attention (k, v) in it."""
    return [{**c, "xkv": p["xkv"]} if "xkv" in c else c
            for c, p in zip(cache, pre)]


@pytest.mark.parametrize("arch", CROSS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_with_the_prefill_cross_cache_matches_jax_and_the_forward(
        arch, dtype):
    """The prompt replayed through decode_step from a zero self-attention
    cache and the prefill's xkv, in both packages, and against logits_fn."""
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, dtype)
    S = 16
    b = _batch(jcfg, S)
    b.pop("labels")
    jb, tb = _both(b)
    cross_len = (tcfg.n_image_tokens if arch == VLM
                 else b["audio_frames"].shape[1])
    _, jpre = jax.jit(jm.prefill)(jp, jb)
    with torch.inference_mode():
        _, tpre = tm.prefill(tp, tb)
        fwd = tm.logits_fn(tp, tb)
    jcache = _with_xkv(jm.init_cache(2, S, cross_len=cross_len), jpre)
    tcache = _with_xkv(tm.init_cache(2, S, cross_len=cross_len), tpre)
    jstep = jax.jit(jm.decode_step)
    tokens = b["tokens"]
    out = []
    with torch.inference_mode():
        for p in range(S):
            pos = np.full((2,), p, np.int32)
            jl, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, p:p + 1]),
                               jnp.asarray(pos))
            tl, tcache = tm.decode_step(tp, tcache,
                                        torch.from_numpy(tokens[:, p:p + 1]),
                                        torch.from_numpy(pos))
            _close(tl, jl, TOL[dtype])
            out.append(tl[:, 0])
    _close(torch.stack(out, dim=1), fwd.float(), TOL[dtype])


@pytest.mark.parametrize("arch", CROSS)
def test_init_cache_matches_jax(arch):
    jcfg, tcfg, jm, tm, _, _ = _setup(arch, "bfloat16")
    want = jm.init_cache(3, 24, cross_len=10)
    got = tm.init_cache(3, 24, cross_len=10)
    assert [sorted(c) for c in got] == [sorted(c) for c in want]
    for t, j in zip(leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}"
        assert not t.any()


@pytest.mark.parametrize("arch", CROSS)
def test_serve_session_generates_the_reference_tokens(arch):
    """The reference's session: zero image embeds / audio frames in the
    prefill, and decode replays the prompt from a zero cache, its
    cross-attention (k, v) zero too."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(arch)),
                               param_dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch(arch)), param_dtype="float32")
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


@pytest.mark.parametrize("arch", NEW)
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
        assert {k: (tuple(v.shape), str(v.dtype))
                for k, v in jspecs["prefill"].items()} == {
            k: (v.shape, str(v.dtype).replace("torch.", ""))
            for k, v in tspecs["prefill"].items()}
        jcache = jax.tree_util.tree_leaves(
            jax_serving.decode_cache_specs(jcfg, jshape))
        tcache = leaves(serving.decode_cache_specs(tcfg, tshape))
        assert [(tuple(s.shape), str(s.dtype)) for s in jcache] == [
            (s.shape, str(s.dtype).replace("torch.", "")) for s in tcache]


@pytest.mark.parametrize("arch", CROSS)
def test_param_tree_has_the_reference_layout(arch):
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, "bfloat16")
    fresh = tm.init(torch.Generator().manual_seed(0))
    want = [(tuple(x.shape), str(x.dtype)) for x in
            jax.tree_util.tree_leaves(jp)]
    for tree in (tp, fresh):
        assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for t in leaves(tree)] == want
    assert ("encoder" in fresh) == ("enc_norm" in fresh) == (arch == AUDIO)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_serve_cli_runs_the_new_families_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "4"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "generated (2, 4) tokens" in proc.stdout
    rows = [ln for ln in proc.stdout.splitlines() if ln.strip().startswith("[")]
    assert len(rows) == 2 and all(len(json.loads(r)) == 4 for r in rows)


# --------------------------------------------------------------------------- #
# the fused cross-entropy
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_fused_softmax_xent_value_and_grad_match_jax(dtype):
    rng = np.random.default_rng(7)
    logits = (3.0 * rng.standard_normal((2, 24, 97))).astype(dtype)
    labels = rng.integers(0, 97, size=(2, 24)).astype(np.int32)
    want, jgrad = jax.jit(jax.value_and_grad(jax_fused_xent))(
        jnp.asarray(logits), jnp.asarray(labels))
    x = convert.to_torch(logits).requires_grad_(True)
    loss = fused_softmax_xent(x, torch.from_numpy(labels))
    loss.backward()
    assert x.grad.dtype == x.dtype
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    tol = (dict(rtol=1e-5, atol=1e-8) if dtype == np.float32
           else dict(rtol=8e-3, atol=1e-6))
    _close(x.grad, jgrad, tol)
    # the same value as the plain cross-entropy
    np.testing.assert_allclose(loss.item(), float(softmax_xent(
        x.detach(), torch.from_numpy(labels))), rtol=1e-6)


@pytest.mark.parametrize("arch", CROSS)
def test_loss_fn_takes_the_fused_xent_without_a_mask(arch, monkeypatch):
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, "float32")
    jcfg = dataclasses.replace(jcfg, fused_xent=True)
    tcfg = dataclasses.replace(tcfg, fused_xent=True)
    jb, tb = _both(_batch(jcfg, 24))
    jloss, _ = jax.jit(jax_build_model(jcfg).loss_fn)(jp, jb)
    from repro_torch.models import model as model_mod
    calls = []
    real = model_mod.fused_softmax_xent
    monkeypatch.setattr(model_mod, "fused_softmax_xent",
                        lambda *a: calls.append(1) or real(*a))
    fused = build_model(tcfg)
    loss, _ = fused.loss_fn(tp, tb)
    assert calls == [1]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    fused.loss_fn(tp, {**tb, "mask": torch.ones(tb["labels"].shape)})
    assert calls == [1]
