"""Batched greedy decode serving with KV/SSM caches (the port of
``repro.launch.serve``): ``init_params → init_cache → prefill → greedy
decode`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --reduced --device cpu --batch 4 --prompt-len 32 --gen 32

It runs on the card (``--device cuda``, the default) and raises at once
without one.  Prompts come from ``np.random.default_rng(seed)`` as JAX's
serve draws them, so a prompt is the same in both packages; parameters
come from a ``torch.Generator`` seeded with ``--seed`` (JAX's
distributions, not JAX's numbers).

``serve(..., mesh=grid)`` runs the same loop on a ``ProcessGrid``: the
model is the rank's sharded model, the prompt its rows, the caches
sequence-sharded over ``"model"`` and decoded split-KV.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..core.backend import resolve_device
from ..models.model import (
    LanguageModel,
    ModelConfig,
    init_cache,
    init_params,
    make_prefill_step,
    make_serve_step,
)


@dataclasses.dataclass
class ServeResult:
    """Greedy tokens (B, gen) int32 on the CPU and the run's times."""

    tokens: torch.Tensor
    prefill_ms: float
    decode_ms: float  # all gen - 1 decode steps
    decode_steps: int
    tokens_per_s: float  # batch · decode_steps / decode time
    peak_bytes: Optional[int]  # the allocator's peak (CUDA), else None


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """JAX serve's flags plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_prompt(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                device="cpu") -> Dict[str, torch.Tensor]:
    """JAX serve's prompt for ``seed``: token ids in ``[1, vocab)``, or for
    the embed frontend normal embeddings cast to bf16."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "token":
        toks = rng.integers(1, cfg.vocab_size, (batch, prompt_len))
        return {"tokens": torch.from_numpy(toks.astype(np.int32)).to(device)}
    emb = rng.normal(0, 1, (batch, prompt_len, cfg.d_model))
    return {"embeddings": torch.from_numpy(emb).to(torch.bfloat16).to(device)}


def step_input(cfg: ModelConfig, params: LanguageModel,
               tok: torch.Tensor, mesh=None) -> Dict[str, torch.Tensor]:
    """The decode input of tokens ``tok`` (B, 1): the ids, or for the embed
    frontend ``unembed.T[tok]`` cast to bf16 (JAX serve's pseudo-embedding;
    on a grid the rank's block of ``unembed``, sharded on ``d_model``, is
    gathered over ``"model"`` along the last dimension)."""
    if cfg.frontend == "token":
        return {"tokens": tok}
    emb = params.unembed.T[tok.long()]
    if mesh is not None and emb.shape[-1] != cfg.d_model:
        emb = mesh.all_gather(emb.contiguous(), "model", dim=-1)
    return {"embeddings": emb.to(torch.bfloat16)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, params: LanguageModel,
          prompt: Dict[str, torch.Tensor], *, gen: int,
          max_len: Optional[int] = None, mesh=None) -> ServeResult:
    """Prefill ``prompt`` and decode ``gen - 1`` more tokens greedily (ties
    to the first maximum) on ``params``' device.  With ``mesh`` (a
    ``ProcessGrid``): ``params`` is the rank's sharded model and
    ``prompt`` its rows of a global batch of ``rows × n_dp``; the tokens
    returned are the rank's rows."""
    device = params.unembed.device
    first = next(iter(prompt.values()))
    batch, prompt_len = first.shape[0], first.shape[1]
    length = max_len or prompt_len + gen
    if mesh is None:
        caches = init_cache(cfg, batch, length, device=device)
        seq_shards = 1
    else:
        from ..runtime.sharding import dp_axes

        n_dp = mesh.size(dp_axes(mesh)) if dp_axes(mesh) else 1
        caches = init_cache(cfg, batch * n_dp, length, device=device,
                            mesh=mesh, seq_sharded=True)
        seq_shards = mesh.shape["model"]
    prefill = make_prefill_step(cfg, mesh=mesh)
    step = make_serve_step(cfg, mesh=mesh, seq_shards=seq_shards)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, caches, prompt)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    toks = [torch.argmax(logits, -1).to(torch.int32)]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = step(params, caches,
                              step_input(cfg, params, toks[-1][:, None], mesh),
                              prompt_len + i)
        toks.append(torch.argmax(logits, -1).to(torch.int32))
    _sync(device)
    t_dec = time.perf_counter() - t0
    steps = gen - 1
    return ServeResult(
        tokens=torch.stack(toks, 1).cpu(),
        prefill_ms=t_prefill * 1e3, decode_ms=t_dec * 1e3, decode_steps=steps,
        tokens_per_s=batch * steps / max(t_dec, 1e-9),
        peak_bytes=(torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else None))


def setup(args: argparse.Namespace):
    """``(cfg, params, prompt)`` of parsed flags; raises at once when the
    card is asked for and there is none."""
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen)
    prompt = make_prompt(cfg, args.batch, args.prompt_len, args.seed, device)
    return cfg, params, prompt


def main(argv: Optional[List[str]] = None) -> torch.Tensor:
    """Serve as the flags say; returns the (batch, gen) greedy tokens."""
    args = parse_args(argv)
    cfg, params, prompt = setup(args)
    res = serve(cfg, params, prompt, gen=args.gen)
    print(f"prefill {res.prefill_ms:.1f} ms; decode {res.decode_ms:.1f} ms "
          f"({res.tokens_per_s:.1f} tok/s); sample row: "
          f"{res.tokens[0][:16].tolist()}")
    return res.tokens


if __name__ == "__main__":
    main()
