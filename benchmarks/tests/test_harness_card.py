"""Each cell's run on the card at a small size: correct, on the GPU, every
per-layer metric read from the device trace.  Run on the card with
``python3 -m pytest -p no:cacheprovider -m cuda benchmarks/tests``."""
import pytest

from benchmarks.harness import manifest, runner

SMALL = {"train_full_graph": {"nodes": 65536},
         "score_resident": {"graphs": [16384, 65536]}}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.manifest()["workloads"]])
def test_cell_on_the_card(card, cell):
    driver = manifest.cell(cell).traffic["driver"]
    r = runner.run_cell(cell, 4242, 1.0, True, card,
                        traffic_override=SMALL[driver])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    want = {m["name"] for m in manifest.cell(cell).per_layer}
    assert set(r["metrics"]) == want
    assert 0 <= r["metrics"][next(n for n in want if "idle" in n)][
        "value"] <= 100
