"""The port's ``dpcheck`` CLI (``python -m repro_torch.launch.dpcheck``)
on the CPU: the JAX package's flags and exit status over the port's
registry.  Clean lanes exit 0 (reduced AlexNet, VGG16 and Llama-3.2-1B
under every clipping mode, ``dp_attn``, the fixed strategies); a lane
with an error exits 1 and names it; ``--mesh`` other than ``none`` and
an arch the port does not serve yet raise, naming their ROADMAP items
(14 and 12).
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.strategies as tstrat  # noqa: E402
from repro_torch.launch import dpcheck  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.mark.parametrize("archs", [["alexnet", "vgg16"], ["llama3.2-1b"]])
def test_clean_lanes_exit_zero(archs, capsys):
    argv = ["--archs", *archs, "--clip-modes", "flat", "per_layer",
            "stale"] + CPU
    assert dpcheck.main(argv) == 0
    out = capsys.readouterr().out
    n = 3 * len(archs)
    assert f"{n}/{n} lanes clean" in out
    assert "FAIL" not in out


@pytest.mark.parametrize("extra", [["--dp-attn"], ["--strategy", "ghost"],
                                   ["--strategy", "bk"],
                                   ["--strategy", "multi"]],
                         ids=["dp_attn", "ghost", "bk", "multi"])
def test_other_lanes_exit_zero(extra, capsys):
    argv = ["--archs", "llama3.2-1b", "-v"] + extra + CPU
    assert dpcheck.main(argv) == 0
    assert "1/1 lanes clean" in capsys.readouterr().out


def test_failing_lane_exits_one(monkeypatch, capsys):
    monkeypatch.setattr(
        tstrat, "clip_coefficients",
        lambda n, c, eps=1e-12, *, mode="flat": torch.ones_like(n))
    assert dpcheck.main(["--archs", "alexnet"] + CPU) == 1
    out = capsys.readouterr().out
    assert "FAIL  alexnet clip=flat" in out
    assert "clip_missing" in out and "unclipped_batch_reduction" in out


def test_mesh_lanes_raise_naming_item_14():
    with pytest.raises(NotImplementedError, match="item 14"):
        dpcheck.main(["--mesh", "data:8"] + CPU)


def test_unserved_arch_raises_naming_item_12():
    with pytest.raises(NotImplementedError, match="item 12"):
        dpcheck.main(["--archs", "granite-moe-1b-a400m"] + CPU)
