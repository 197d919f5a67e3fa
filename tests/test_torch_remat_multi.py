"""Fault F4, pinned: ``remat=True`` under the ``multi`` strategy.

``multi`` takes per-example gradients with ``torch.func.vmap(grad)``,
and ``torch.func``'s transforms take no saved-tensor hooks, so
``scan_with_taps`` cannot checkpoint the scanned layers there.  It runs
them without recompute and says so: a ``RuntimeWarning`` that names F4
and the strategy.  On reduced GLM-4-9B (``remat=True``, its config's
setting) the per-example gradients, norms and clipped sums under
``multi`` are bitwise those of ``remat=False``, no layer is recomputed
(``STATS.recomputes``), and the capture pass, which can checkpoint,
still recomputes every layer and warns nothing.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import strategies  # noqa: E402
from repro_torch.core.tapper import STATS, capture_backward  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.models.lm import TransformerLM  # noqa: E402
from repro_torch.tree import get_subtree, leaf_paths  # noqa: E402


@pytest.fixture(scope="module")
def glm():
    assert get_config("glm4-9b").remat
    cfg = get_config("glm4-9b").reduced()
    plain, remat = TransformerLM(cfg), TransformerLM(cfg.replace(remat=True))
    params, _ = plain.init(0, device="cpu")
    b = SyntheticLMDataset(cfg.vocab, 8, n_examples=8).batch(range(3))
    return plain, remat, params, {k: torch.from_numpy(v)
                                  for k, v in b.items()}


def test_multi_remat_warns_f4_and_keeps_values(glm):
    plain, remat, params, batch = glm
    STATS.reset()
    with pytest.warns(RuntimeWarning, match="F4.*'multi'"):
        got = strategies.clipped_grad_sum(remat.apply, params, batch,
                                          l2_clip=0.05, strategy="multi")
    assert STATS.recomputes == 0
    want = strategies.clipped_grad_sum(plain.apply, params, batch,
                                       l2_clip=0.05, strategy="multi")
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    for q in leaf_paths(want[1]):
        assert torch.equal(get_subtree(got[1], q), get_subtree(want[1], q))
    assert np.all(np.isfinite(got[2].numpy()))


def test_capture_pass_still_recomputes_without_warning(glm):
    plain, remat, params, batch = glm
    STATS.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        losses, _, dtaps = capture_backward(remat.apply, params, batch)
    assert STATS.recomputes == remat.cfg.n_layers
    want = capture_backward(plain.apply, params, batch)
    assert torch.equal(losses, want[0])
    for n in want[2]:
        assert torch.equal(dtaps[n], want[2][n]), n
