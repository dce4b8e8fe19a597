"""The port's serving driver against the JAX package's, on mamba2.

``serve_session`` in float32 on the CPU with the JAX package's initial
weights (carried by ``repro_torch.convert``) must generate the same greedy
tokens as the JAX ``serve_session`` on an Auto-axis (1, 1) mesh (the
installed JAX makes Explicit axes by default, which its serving programs
do not take). Logits agree to ~1e-6 (``tests/test_torch_ssm.py``), so the
greedy tokens are compared exactly: only a near-tie between the top two
logits of a step could tell them apart. The cache geometry and the
abstract specs are compared field for field.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
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
from repro_torch import convert
from repro_torch.configs import ShapeConfig, get_arch, get_shape, reduced
from repro_torch.launch import serving
from repro_torch.launch.serve import serve_session
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _cfgs(**kw):
    return (dataclasses.replace(jax_reduced(jax_get_arch("mamba2-370m")), **kw),
            dataclasses.replace(reduced(get_arch("mamba2-370m")), **kw))


@pytest.mark.parametrize("ssm_pallas", [False, True])
def test_serve_session_generates_the_reference_tokens(ssm_pallas):
    jcfg, tcfg = _cfgs(param_dtype="float32", ssm_pallas=ssm_pallas)
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
    params = convert.to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    stats = {}
    got, tps = serve_session(tcfg, batch=batch, prompt_len=prompt_len,
                             new_tokens=new_tokens, seed=seed, device="cpu",
                             params=params, verbose=False, stats=stats)
    assert got.dtype == np.int32 and got.shape == (batch, new_tokens)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert tps > 0 and stats["logits_finite"]
    assert stats["decode_steps"] == prompt_len - 1 + new_tokens


def test_serve_session_seeded_init_and_no_silent_cpu(monkeypatch):
    _, tcfg = _cfgs()
    a, _ = serve_session(tcfg, batch=2, prompt_len=4, new_tokens=3, seed=1,
                         device="cpu", verbose=False)
    b, _ = serve_session(tcfg, batch=2, prompt_len=4, new_tokens=3, seed=1,
                         device="cpu", verbose=False)
    np.testing.assert_array_equal(a, b)
    assert ((0 <= a) & (a < tcfg.vocab_size)).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_session(tcfg, batch=1, prompt_len=2, new_tokens=1,
                      verbose=False)


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "mamba2-370m", "--reduced", "--batch", "2",
         "--prompt-len", "8", "--new-tokens", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "generated (2, 4) tokens" in proc.stdout
    rows = [ln for ln in proc.stdout.splitlines() if ln.strip().startswith("[")]
    assert len(rows) == 2 and all(len(json.loads(r)) == 4 for r in rows)


@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
def test_cache_geometry_and_specs_match_reference(shape_name):
    for full in (True, False):
        jcfg, tcfg = jax_get_arch("mamba2-370m"), get_arch("mamba2-370m")
        if not full:
            jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
        jshape, tshape = jax_get_shape(shape_name), get_shape(shape_name)
        assert dataclasses.asdict(tshape) == dataclasses.asdict(jshape)
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


def test_ssm_cache_is_constant_in_context_length():
    cfg = get_arch("mamba2-370m")
    sizes = [sum(int(np.prod(s.shape)) for s in
                 leaves(serving.decode_cache_specs(cfg, ShapeConfig(
                     "d", seq_len=L, global_batch=1, kind="decode"))))
             for L in (1024, 524288)]
    assert sizes[0] == sizes[1] < 524288 * 64
