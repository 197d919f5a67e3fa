"""The slice on an AlexNet-structured config: the port's DP-SGD step
against the JAX package's (see ``test_torch_slice.run_parity``).

``get_config("alexnet").replace(img_size=64, n_classes=10)`` keeps the
stride-4 conv0 (which takes the grouped-conv route in both packages),
the 3/2 max pools and the two 4096-wide fc layers — about 20 M params —
at B = 2.  The planned step (``strategy="auto"``) runs under every
clipping mode, and bk under per_layer and stale (see
``test_torch_clip_modes.run_mode_parity``).
"""
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jget  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from test_torch_clip_modes import CLIPPINGS, run_mode_parity  # noqa: E402
from test_torch_slice import PALLAS, run_parity  # noqa: E402


def _cfgs():
    kw = dict(img_size=64, n_classes=10)
    return jget("alexnet").replace(**kw), tget("alexnet").replace(**kw)


@pytest.mark.parametrize("strategy", ["crb", "ghost", "bk"])
def test_alexnet_step_parity(strategy):
    run_parity(*_cfgs(), strategy, B=2)


def test_alexnet_crb_kernel_knobs():
    run_parity(*_cfgs(), "crb", B=2, port_norm=PALLAS)


@pytest.mark.parametrize("clipping", list(CLIPPINGS))
def test_alexnet_auto_step_parity(clipping):
    teng, _ = run_mode_parity("alexnet64", "auto", CLIPPINGS[clipping])
    fused = {n for n, lp in teng.plan().layers.items() if lp.fused}
    assert fused == ({"conv1", "conv2", "conv3", "conv4"}
                     if clipping == "stale" else set())


@pytest.mark.parametrize("clipping", ["per_layer_uniform", "stale"])
def test_alexnet_bk_step_parity_under_modes(clipping):
    run_mode_parity("alexnet64", "bk", CLIPPINGS[clipping])
