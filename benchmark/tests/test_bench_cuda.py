"""On the card: a tiny cell's traced run reads every per-layer metric and
is correct. Run there with ``python3 -m pytest -m cuda benchmark/tests``."""

import sys

import pytest

from tiny import REPO, make_root

sys.path.insert(0, REPO)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["default-2k", "hdrf-1k"])
def test_traced_tiny_cell_on_the_card(card, tmp_path, which):
    from benchmark.core import run_cell
    root, cell = make_root(tmp_path, which)
    out = run_cell(cell, 31, 2.0, True, device="cuda", root=root)
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0
    assert out["device"]["window_s"] > out["device"]["busy_s"]
    sfx = ".steady" if which == "default-2k" else ".hdrf"
    for name in ("launches_per_cycle", "fused_choice_roofline",
                 "device_idle_pct", "dispatch_ms", "intake_ms"):
        assert name + sfx in out["metrics"], name
    assert 0 < out["metrics"]["fused_choice_roofline" + sfx]["value"] <= 105
