"""The port's ``dpcheck`` CLI (``python -m repro_torch.launch.dpcheck``)
on the CPU: the JAX package's flags and exit status over the port's
registry.  Clean lanes exit 0 (reduced AlexNet, VGG16 and Llama-3.2-1B
under every clipping mode, ``dp_attn``, the fixed strategies); a lane
with an error exits 1 and names it; ``--mesh`` other than ``none`` and
an arch the port does not serve yet raise, naming their ROADMAP items
(14 and 12).  Reduced Granite-3.0-1B-A400M and SeamlessM4T-large-v2 run
under every clipping mode and give the JAX package's verdicts.
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
    """``--mesh data:4,model:2`` runs the tensor-sharded lanes (item 14
    parts 2 and 3; ``tests/test_torch_model_axis.py``,
    ``tests/test_torch_moe_model_axis.py``,
    ``tests/test_torch_attn_model_axis.py``,
    ``tests/test_torch_recurrent_model_axis.py``); what it leaves out
    raises naming item 14 part 3 — block taps beside sliced heads
    (DeepSeek-V3's MLA and Chameleon's GQA with ``--dp-attn``), serving
    against a cache there (MLA's latent cache, Chameleon's KV cache,
    Seamless's self and cross caches, xLSTM's and Zamba2's recurrent
    states).  The FSDP rules, deferred until a step executed them, now
    give specs on a live mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import fake_world, make_mesh_from_spec
    from repro_torch.launch.sharding import param_sharding
    from repro_torch.models.registry import build_model
    import torch_shard_worker as sw
    for arch, what, extra in (
            ("deepseek-v3-671b", "MLA with block taps", ["--dp-attn"]),
            ("chameleon-34b", "block taps", ["--dp-attn"])):
        with pytest.raises(NotImplementedError,
                           match=f"{what}.*item 14 part 3"):
            dpcheck.main(["--archs", arch, "--mesh", "data:4,model:2",
                          "--seq", "8", "--batch", "4"] + extra + CPU)
    _, axes = build_model(get_config("llama3.2-1b").reduced()).init(
        0, device="cpu")
    planned = param_sharding(axes, "data:4,model:2", fsdp=True)
    with fake_world(8):
        mesh = make_mesh_from_spec("data:4,model:2", device_type="cpu")
        # FSDP's rules give specs on a live mesh too (a step executes
        # them since item 14 part 3's FSDP), the same as over the spec.
        assert param_sharding(axes, mesh, fsdp=True) == planned
        msg = sw.mla_cache_on_model_axis(mesh)
        kv = sw.prefill_on_model_axis(mesh, "chameleon-34b")
        cross = sw.prefill_on_model_axis(mesh, "seamless-m4t-large-v2")
        serve = {arch: sw.prefill_on_model_axis(mesh, arch)
                 for arch in sw.RECURRENT_SERVE.values()}
    assert "MLA with a latent cache" in msg and "item 14 part 3" in msg
    assert "a KV cache beside sliced heads" in kv and "item 14 part 3" in kv
    assert "self and cross caches beside sliced heads" in cross
    assert "item 14 part 3" in cross
    for arch, family in zip(sw.RECURRENT_SERVE.values(), ("ssm", "hybrid")):
        assert f"serving the {family} family on a model axis" in serve[arch]
        assert "item 14 part 3" in serve[arch]


def test_recurrent_archs_on_a_model_axis_give_the_one_device_verdict(
        capsys):
    """Reduced xLSTM-125M and Zamba2-2.7B run on ``data:2,model:2`` (item
    14 part 3) and get their one-device verdict, PASS: no finding of the
    model half (the ``local_vjp`` kind's partial per-example gradients
    of ``ssd`` and sLSTM's gate bias summed over model once before their
    norms; ``wif``'s and ``rec``'s mixed groups one norm sum each) and
    none of the data half.  Their one-device lanes are
    ``test_unserved_arch_raises_naming_item_12``'s."""
    argv = ["--archs", "xlstm-125m", "zamba2-2.7b", "--mesh",
            "data:2,model:2", "--clip-modes", "flat", "--seq", "8",
            "--batch", "4"] + CPU
    assert dpcheck.main(argv) == 0
    out = capsys.readouterr().out
    for arch in ("xlstm-125m", "zamba2-2.7b"):
        assert f"PASS  {arch} clip=flat mesh=data:2,model:2" in out, out
    assert "2/2 lanes clean" in out


def test_attn_archs_on_a_model_axis_give_the_one_device_verdict(capsys):
    """Reduced Chameleon-34B (qk-norm on sliced heads) and SeamlessM4T-
    large-v2 (the enc-dec family) run on ``data:2,model:2`` (item 14
    part 3) and get their one-device verdict, PASS: no finding of the
    model half (``qn``'s partial per-example gradient summed over model
    once before its norm) and none of the data half."""
    argv = ["--archs", "chameleon-34b", "seamless-m4t-large-v2", "--mesh",
            "none", "data:2,model:2", "--clip-modes", "flat", "--seq", "8",
            "--batch", "4"] + CPU
    assert dpcheck.main(argv) == 0
    out = capsys.readouterr().out
    for arch in ("chameleon-34b", "seamless-m4t-large-v2"):
        for spec in ("none", "data:2,model:2"):
            assert f"PASS  {arch} clip=flat mesh={spec}" in out, out
    assert "4/4 lanes clean" in out


@pytest.mark.parametrize("arch", ("granite-moe-1b-a400m",
                                  "deepseek-v3-671b"))
def test_moe_arch_on_a_model_axis_gives_the_one_device_verdict(arch,
                                                                capsys):
    """The MoE archs run on ``data:2,model:2`` (item 14 part 3) and get
    their one-device verdict: FAIL, from the gather dispatch's slot
    competition alone (``unclipped_batch_reduction``), with no finding
    of the model half and none of the data half (the per-expert counts
    the data ranks exchange are integers, no gradient sync)."""
    argv = ["--archs", arch, "--mesh", "none", "data:2,model:2",
            "--clip-modes", "flat", "--seq", "8", "--batch", "4",
            "-v"] + CPU
    assert dpcheck.main(argv) == 1
    out = capsys.readouterr().out
    for spec in ("none", "data:2,model:2"):
        assert f"FAIL  {arch} clip=flat mesh={spec}" in out
    codes = {line.split()[1] for line in out.splitlines()
             if line.startswith("    error")}
    assert codes == {"unclipped_batch_reduction"}, out


def test_unserved_arch_raises_naming_item_12():
    """The SSM and hybrid archs run (reduced xLSTM-125M and Zamba2-2.7B,
    flat, at T = 8: the traced graph holds every step of the
    recurrences), and pass, as the MoE and enc-dec ones run
    (``test_moe_and_encdec_lanes``); an unknown arch raises."""
    assert dpcheck.main(["--archs", "xlstm-125m", "zamba2-2.7b",
                         "--clip-modes", "flat", "--seq", "8",
                         "--batch", "4"] + CPU) == 0
    with pytest.raises(KeyError, match="unknown arch"):
        dpcheck.main(["--archs", "mamba-3b"] + CPU)


def test_moe_and_encdec_lanes(capsys):
    """Reduced Granite-3.0-1B-A400M and SeamlessM4T-large-v2 run under
    every clipping mode.  Granite
    fails, as the JAX package's ``repro.launch.dpcheck`` does on the same
    lane: its gather dispatch has global capacity (the examples' entries
    compete for one expert's slots), and the verifier reports the
    one-hot of every example's expert ids that feeds the slot cumsum as a
    batch-axis reduction (``eq``; the JAX package's first finding is the
    same one-hot).  Seamless is clean: the JAX package's verdict there is
    FAIL, from its LayerNorm's variance (``jnp.var`` in a nested jit its
    taint pass does not model), the same finding it reports for the dense
    OLMo-1B; the port's graph holds the variance as plain ops."""
    argv = ["--archs", "granite-moe-1b-a400m", "seamless-m4t-large-v2",
            "--clip-modes", "flat", "per_layer", "stale", "-v"] + CPU
    assert dpcheck.main(argv) == 1
    out = capsys.readouterr().out
    for mode in ("flat", "per_layer", "stale"):
        assert f"FAIL  granite-moe-1b-a400m clip={mode}" in out
        assert f"PASS  seamless-m4t-large-v2 clip={mode}" in out
    assert "batch-axis reduction in `eq`" in out
    assert "3/6 lanes clean" in out
