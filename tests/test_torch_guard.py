"""Guards on the port's boundaries.

* Nothing in ``src/repro_torch/`` or ``chip_smoke.py`` imports JAX or the
  JAX package, and importing every submodule of the port leaves
  ``jax`` out of ``sys.modules``.
* The device rule: entry points default to ``device="cuda"`` and raise
  without a card unless ``device="cpu"`` is passed; on the CPU the
  kernel wrappers take their plain versions and launch nothing.
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DPConfig, PrivacyEngine  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.cnn import CNN, toy_cnn_config  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|repro)(\.|\s|$)")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_no_jax_or_reference_imports():
    files = _port_files()
    assert len(files) > 20 and files[-1].exists()
    bad = []
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            if FORBIDDEN.match(line):
                bad.append(f"{f.relative_to(ROOT)}:{i}: {line.strip()}")
    assert not bad, "\n".join(bad)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules "
        "if k.startswith('jax'))\n"
        "print('ok', len([k for k in sys.modules "
        "if k.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _toy():
    m = CNN(toy_cnn_config(2, 2.0, c0=4, img=16))
    batch = {"img": torch.zeros(2, 3, 16, 16),
             "label": torch.zeros(2, dtype=torch.int32)}
    return m, batch


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    m, batch = _toy()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init(0)
    params, _ = m.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrivacyEngine(m.apply, params, batch, DPConfig(strategy="crb"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2, np.float32)})


def test_cpu_runs_and_kernels_take_their_plain_versions():
    m, batch = _toy()
    params, _ = m.init(0, device="cpu")
    eng = PrivacyEngine(m.apply, params, batch, device="cpu",
                        dp=DPConfig(strategy="ghost"))
    assert eng.device.type == "cpu"
    before = dict(ops.LAUNCHES)
    g = torch.Generator().manual_seed(0)
    x, dy = torch.randn(2, 5, 4, generator=g), torch.randn(2, 5, 3,
                                                           generator=g)
    torch.testing.assert_close(ops.gram_norm(x, dy),
                               ref.gram_norm_ref(x, dy), rtol=0, atol=0)
    xc, dyc = torch.randn(2, 3, 6, 6, generator=g), torch.randn(
        2, 4, 4, 4, generator=g)
    torch.testing.assert_close(ops.pe_conv_grad_2d(xc, dyc, KH=3, KW=3),
                               ref.pe_conv_grad_2d_ref(xc, dyc, 3, 3),
                               rtol=0, atol=0)
    assert ops.LAUNCHES == before
