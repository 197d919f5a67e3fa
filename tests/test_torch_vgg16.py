"""The slice on a VGG16-structured config: the port's DP-SGD step against
the JAX package's (see ``test_torch_slice.run_parity``).

``get_config("vgg16").replace(img_size=32, n_classes=10)`` keeps VGG16's
thirteen stride-1 3x3 convs (conv0's C·KH·KW = 27), its five 2x2 max
pools and the two 4096-wide fc layers (512 features reach fc0 at 32 px)
— about 34 M params — at B = 2.  crb, ghost and bk run flat; the planned
step (``strategy="auto"``) runs under flat, per_layer (uniform and auto
budgets) and stale clipping, and bk under stale (see
``test_torch_clip_modes.run_mode_parity``).  Under stale the plan fuses
conv4–12 (the Gram-realized convs at this size).
"""
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jget  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from test_torch_clip_modes import CLIPPINGS, VGG32  # noqa: E402
from test_torch_clip_modes import run_mode_parity  # noqa: E402
from test_torch_slice import run_parity  # noqa: E402

STALE_FUSED = {f"conv{i}" for i in range(4, 13)}


@pytest.mark.parametrize("strategy", ["crb", "ghost", "bk"])
def test_vgg16_step_parity(strategy):
    run_parity(jget("vgg16").replace(**VGG32), tget("vgg16").replace(**VGG32),
               strategy, B=2)


@pytest.mark.parametrize("clipping", ["flat", "per_layer_uniform",
                                      "per_layer_auto", "stale"])
def test_vgg16_auto_step_parity(clipping):
    teng, _ = run_mode_parity("vgg16_32", "auto", CLIPPINGS[clipping])
    fused = {n for n, lp in teng.plan().layers.items() if lp.fused}
    assert fused == (STALE_FUSED if clipping == "stale" else set())


def test_vgg16_bk_step_parity_under_stale():
    run_mode_parity("vgg16_32", "bk", CLIPPINGS["stale"])
