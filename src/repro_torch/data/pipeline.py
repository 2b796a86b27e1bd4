"""Deterministic sharded data pipeline (the port's copy of
``repro.data.pipeline``; numpy only, so a batch is bit for bit JAX's).

``SyntheticLMData`` generates a reproducible token stream per (epoch, step,
host-shard) — a stand-in for a real corpus reader with the properties the
fault-tolerance story needs: (a) deterministic resume — restarting from a
checkpoint at step k regenerates exactly the batches ≥ k; (b) host-sharded —
each data-parallel shard draws a disjoint slice; (c) prefetchable.

``TokenPacker`` packs variable-length documents into fixed (B, S) training
rows with cross-document attention boundaries marked by a separator token.

``as_tensors`` moves a numpy batch to torch tensors on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLMData:
    """A deterministic synthetic token (or embedding) stream."""

    vocab_size: int
    batch_size: int  # global
    seq_len: int
    seed: int = 0
    frontend: str = "token"
    d_model: int = 0  # for embed-frontend archs

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """Deterministic batch for (step, shard) — resume-safe."""
        b_local = self.batch_size // n_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + shard
        )
        if self.frontend == "token":
            # markov-ish stream so loss has learnable structure
            base = rng.integers(1, self.vocab_size, size=(b_local, 1))
            steps = rng.integers(0, 17, size=(b_local, self.seq_len))
            toks = (base + np.cumsum(steps, axis=1)) % self.vocab_size
            tokens = toks.astype(np.int32)
            labels = np.roll(tokens, -1, axis=1).astype(np.int32)
            labels[:, -1] = -1
            return {"tokens": tokens, "labels": labels}
        emb = rng.normal(0, 1, size=(b_local, self.seq_len, self.d_model))
        labels = rng.integers(0, self.vocab_size,
                              size=(b_local, self.seq_len)).astype(np.int32)
        return {"embeddings": emb.astype(np.float32), "labels": labels}

    def iter_batches(self, start_step: int = 0, shard: int = 0,
                     n_shards: int = 1) -> Iterator[dict]:
        """Batches from ``start_step`` on."""
        step = start_step
        while True:
            yield self.batch_at(step, shard, n_shards)
            step += 1


@dataclasses.dataclass
class TokenPacker:
    """Greedy first-fit packing of documents into rows of ``seq_len``."""

    seq_len: int
    sep_token: int = 0

    def pack(self, docs: List[np.ndarray]) -> np.ndarray:
        """Greedy first-fit packing of documents into rows of seq_len."""
        rows: List[List[int]] = []
        for d in docs:
            d = list(d) + [self.sep_token]
            placed = False
            for r in rows:
                if len(r) + len(d) <= self.seq_len:
                    r.extend(d)
                    placed = True
                    break
            if not placed:
                for off in range(0, len(d), self.seq_len):
                    rows.append(d[off : off + self.seq_len])
        out = np.full((len(rows), self.seq_len), self.sep_token, np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r[: self.seq_len]
        return out


def as_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as torch tensors on ``device`` (dtypes kept)."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}
