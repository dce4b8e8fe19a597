"""Deterministic synthetic LM data with non-IID worker shards.

A copy of the JAX package's ``data/synthetic.py`` (NumPy only): both
packages draw the same tokens from the same seed.

The paper's setting (§3) has *different local datasets* on each worker:
``D_i != D_j`` and, in general, ``E_{z_i}∇f(x;z_i) != E_{z_j}∇f(x;z_j)``.
The 1B-Word corpus is not available offline, so we substitute a *learnable*
synthetic language: a noisy bigram (Markov) process whose transition table is
a fixed pseudo-random permutation, mixed with Zipf-distributed unigram noise.

* Learnability: the permutation bigram is exactly representable by one
  embedding->logits layer, so cross-entropy falls from log(V) toward the
  noise floor ``H(noise)`` — convergence curves are meaningful.
* Non-IID-ness: each worker ``w`` uses a *different* permutation (derived from
  ``seed + w``) for a ``non_iid_frac`` fraction of positions, so worker
  gradients have genuinely different expectations, matching the paper's
  assumption (tested in tests/test_data.py).
* Determinism: batch ``(worker, step)`` is a pure function of
  ``(seed, worker, step)`` — restarts and data-parallel re-sharding reproduce
  the exact stream with no state files.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


def _permutation(vocab_size: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).permutation(vocab_size)


def _zipf_probs(vocab_size: int, a: float = 1.2) -> np.ndarray:
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


@dataclasses.dataclass
class SyntheticLM:
    """Noisy-bigram synthetic language, sharded non-IID across workers."""

    vocab_size: int
    seq_len: int
    n_workers: int = 1
    seed: int = 0
    non_iid: bool = True
    noise: float = 0.1            # prob. of a Zipf-noise token (entropy floor)
    non_iid_frac: float = 0.5     # fraction of steps driven by the worker table
    zipf_a: float = 1.2

    def __post_init__(self):
        self._shared = _permutation(self.vocab_size, self.seed)
        self._worker_tables = [
            _permutation(self.vocab_size, self.seed + 7919 * (w + 1))
            if self.non_iid else self._shared
            for w in range(self.n_workers)
        ]
        self._zipf = _zipf_probs(self.vocab_size, self.zipf_a)

    # ------------------------------------------------------------------ #
    def worker_batch(self, worker: int, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        """(batch_size, seq_len) tokens + next-token labels for one worker."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + worker * 65_537 + step) % (2**63))
        table = self._worker_tables[worker % max(self.n_workers, 1)]
        S, V = self.seq_len, self.vocab_size
        seq = np.empty((batch_size, S + 1), dtype=np.int64)
        seq[:, 0] = rng.integers(0, V, size=batch_size)
        # Pre-draw the per-position mode: 0 shared-bigram, 1 worker-bigram, 2 noise
        u = rng.random((batch_size, S))
        use_noise = u < self.noise
        use_worker = (~use_noise) & (u < self.noise + (1 - self.noise) * self.non_iid_frac)
        noise_draws = rng.choice(V, size=(batch_size, S), p=self._zipf)
        for t in range(S):
            cur = seq[:, t]
            nxt = np.where(use_worker[:, t], table[cur], self._shared[cur])
            seq[:, t + 1] = np.where(use_noise[:, t], noise_draws[:, t], nxt)
        return {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
        }

    def global_batch(self, step: int, global_batch: int,
                     *, with_worker_axis: bool = True) -> Dict[str, np.ndarray]:
        """Batch for all workers: (R, B/R, S) if with_worker_axis else (B, S)."""
        R = max(self.n_workers, 1)
        assert global_batch % R == 0, (global_batch, R)
        per = global_batch // R
        parts = [self.worker_batch(w, step, per) for w in range(R)]
        out = {k: np.stack([p[k] for p in parts]) for k in parts[0]}
        if not with_worker_axis:
            out = {k: v.reshape(global_batch, -1) for k, v in out.items()}
        return out

    def entropy_floor(self) -> float:
        """Per-token cross-entropy of the true process (nats) — the loss floor."""
        p_noise = self.noise
        h_zipf = -np.sum(self._zipf * np.log(self._zipf))
        # mixture over {deterministic bigram, noise}; non-IID split between two
        # permutations looks like a 2-way mixture to a worker-agnostic model.
        h_det = 0.0
        if self.non_iid and self.non_iid_frac > 0:
            f = self.non_iid_frac
            h_det = -(f * np.log(f) + (1 - f) * np.log(1 - f))
        h = (-(1 - p_noise) * np.log(1 - p_noise + 1e-12)
             - p_noise * np.log(p_noise + 1e-12)
             + (1 - p_noise) * h_det + p_noise * h_zipf)
        return float(h)


def make_train_batch(cfg, shape_cfg, dataset: SyntheticLM, step: int,
                     *, n_workers: int = 0,
                     rank: Optional[Tuple[int, int]] = None
                     ) -> Dict[str, np.ndarray]:
    """Full train batch for an architecture: tokens/labels + modality stubs.

    ``rank=(r, world)`` gives rank r's part of it, the rows that rank
    trains on: with ``n_workers`` (= world, one worker a rank) worker r's
    (1, B/R, ...) rows, drawn alone; without, rows r·B/R to (r+1)·B/R of
    the global (B, ...) batch (the synchronous plan's data parallelism).
    Either is bit for bit the same slice of the whole batch."""
    if n_workers:
        lead = (n_workers, shape_cfg.global_batch // n_workers)
        if rank is None:
            batch = dataset.global_batch(step, shape_cfg.global_batch,
                                         with_worker_axis=True)
        else:
            batch = {k: v[None] for k, v in dataset.worker_batch(
                rank[0], step, lead[1]).items()}
    else:
        batch = dataset.global_batch(step, shape_cfg.global_batch,
                                     with_worker_axis=False)
        lead = (shape_cfg.global_batch,)
    rng = np.random.default_rng((dataset.seed * 9_973 + step) % (2**63))
    if getattr(cfg, "cross_attn_every", 0):
        batch["image_embeds"] = (rng.standard_normal(
            lead + (cfg.n_image_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if getattr(cfg, "is_encdec", False):
        batch["audio_frames"] = (rng.standard_normal(
            lead + (shape_cfg.seq_len, cfg.d_model)) * 0.02).astype(np.float32)
    if rank is not None:
        r, world = rank
        for k in ("image_embeds", "audio_frames"):
            if k in batch:
                batch[k] = batch[k][r:r + 1] if n_workers else batch[k]
        if not n_workers:
            per = shape_cfg.global_batch // world
            batch = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
    return batch
