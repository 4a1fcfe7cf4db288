"""Phase 11's cell (c) of ``chip_smoke.py`` on the card (no JAX here: the
dry run's own prediction is the reference)."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.cuda
def test_phase_11_train_cell_on_the_card():
    """TinyLlama-1.1B, one 2 x 2,048 train step from seeded weights: the
    measured peak within 0.5 GiB plus 1 % of the one-card dry run's, and
    the warm step slower than its roofline bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    arch, shape = chip_smoke.dry_cells()[2]
    rec = chip_smoke.dry_record(arch, shape, device)
    got = chip_smoke.dry_cell(arch, shape, rec, device, 0)
    assert got["within_tol"], got
    assert 0 < got["roofline_fraction"] <= 1
