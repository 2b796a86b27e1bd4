"""``scripts/lm_grid_nccl.py``'s bf16 prefill rule as a pure function: each
bf16 side is measured against one card's f32 logits of the same weights,
and the grid may add at most ``BF16_EXTRA`` (0.15) to one card's own bf16
error."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "lm_grid_nccl", os.path.join(ROOT, "scripts", "lm_grid_nccl.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _logits(seed: int, card_err: float):
    """One card's f32 logits and its bf16 logits, the latter at most
    ``card_err`` away (reached at one element)."""
    rng = np.random.default_rng(seed)
    want32 = torch.from_numpy(rng.normal(0, 4, (2, 40)).astype(np.float32))
    noise = rng.uniform(-card_err, card_err, want32.shape).astype(np.float32)
    noise.flat[7] = card_err
    return want32 + torch.from_numpy(noise), want32


@pytest.mark.parametrize("card_err", [0.0, 0.05, 0.31])
def test_a_grid_within_the_cards_own_bf16_error_plus_0p15_passes(script,
                                                                  card_err):
    want, want32 = _logits(0, card_err)
    got = want32.clone()
    got.view(-1)[3] += card_err + 0.14
    got.view(-1)[11] -= card_err + 0.10
    ok, c, g = script.bf16_prefill_ok(got, want, want32)
    assert ok
    assert c == pytest.approx(card_err, abs=1e-6)
    assert g == pytest.approx(card_err + 0.14, abs=1e-5)
    # the direct gap may exceed 0.15 (one card's own error at depth) and
    # still pass: the rule measures the grid, not the model's depth
    ok_same, _, _ = script.bf16_prefill_ok(want.clone(), want, want32)
    assert ok_same


@pytest.mark.parametrize("card_err", [0.0, 0.05, 0.31])
def test_a_grid_0p2_beyond_the_rule_fails(script, card_err):
    want, want32 = _logits(1, card_err)
    got = want32.clone()
    got.view(-1)[5] += card_err + script.BF16_EXTRA + 0.2
    ok, c, g = script.bf16_prefill_ok(got, want, want32)
    assert not ok
    assert g - c == pytest.approx(script.BF16_EXTRA + 0.2, abs=1e-5)
    assert script.BF16_EXTRA == 0.15
