"""Ranks of the port's data-parallel tests (gloo on the CPU).

Not collected by pytest.  ``tests/test_torch_sharded_engine.py`` spawns
one process group of 4 ranks and one of 2, each once per module, through
:func:`run_world`; every rank runs all the lanes of its world
(:func:`lanes_4`, :func:`lanes_2`) and saves what it got to
``rank<r>.pt`` for the parent to compare.  It imports no JAX (the ranks
start in seconds), so the toy model is the port's copy of the suite's
``toy_model`` (``tests/conftest.py``; ``test_torch_resume.toy_apply``).
Rendezvous is a ``FileStore`` in the run's own directory, and every
group and every join has a timeout of at most 120 s.
"""
from __future__ import annotations

import datetime
import functools
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

TIMEOUT_S = 120
STEPS = 4
NOISE = 0.9
RUN_SEED = 7
KILL_AT = 2


def toy_apply(params, batch, tp):
    """``tests/conftest.py``'s toy_model in the port: conv + embedding +
    scanned (dense, GELU, LayerNorm, scale) blocks + dense head."""
    from repro_torch.core.tapper import scan_with_taps
    img, ids, y = batch["img"], batch["ids"], batch["label"]
    h = tp.conv("conv1", img, params["conv1"]["w"], params["conv1"]["b"],
                stride=2, padding=1)
    h = torch.relu(h)
    h = h.reshape(h.shape[0], -1)[:, :125]
    e = tp.embed("emb", params["emb"]["emb"], ids)

    def block(stp, carry, p_l):
        x = stp.dense("fc", carry, p_l["fc"]["w"], p_l["fc"]["b"])
        x = F.gelu(x, approximate="tanh")
        mu = x.mean(-1, keepdim=True)
        x = (x - mu) / torch.sqrt(x.var(-1, keepdim=True, unbiased=False)
                                  + 1e-5)
        return stp.scale("nrm", x, p_l["nrm"]["g"], p_l["nrm"]["b"])

    e = scan_with_taps(tp, "blocks", block, e, params["blocks"])
    feat = torch.cat([h, e.mean(dim=1)], dim=-1)
    logits = tp.dense("head", feat, params["head"]["w"])
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, y.long()[:, None])[:, 0]


def to_torch(tree):
    """A nested dict of numpy (or JAX) arrays as CPU tensors."""
    import numpy as np
    return {k: to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Lane configurations, shared by the ranks and the parent's references


def policy(mode: str):
    from repro_torch.core import ClipPolicy
    if mode == "per_layer":
        return ClipPolicy(mode="per_layer", budgets="auto")
    return ClipPolicy(mode=mode)


def grad_extract(grads, state, params, *, lr, weight_decay):
    """Identity 'optimizer': the step's gradient comes out as the params."""
    return grads, state


def make_engine(params, batch, *, mode="flat", sigma=0.0, mesh=None,
                optimizer="adamw", lr=1e-2, accountant=False):
    from repro_torch.core import DPConfig, PrivacyAccountant, PrivacyEngine
    dp = DPConfig(l2_clip=0.1, noise_multiplier=sigma, clipping=policy(mode))
    acct = (PrivacyAccountant(sampling_rate=1 / 128, noise_multiplier=sigma)
            if accountant else None)
    return PrivacyEngine(toy_apply, params, batch, dp=dp, lr=lr,
                         optimizer=optimizer, mesh=mesh, run_seed=RUN_SEED,
                         accountant=acct, calibration="analytic",
                         device="cpu")


def jax_parity_optimizer():
    """The cross-package parity steps' AdamW (eps 1e-6, lr 1e-4)."""
    from repro_torch.optim import adamw_update
    return functools.partial(adamw_update, eps=1e-6)


def batch_at(batch, step):
    """Deterministic per-step batch stream (a pure function of step)."""
    return {k: torch.roll(v, step, 0) for k, v in batch.items()}


def run_steps(engine, params, batch, steps=2):
    from repro_torch.optim import adamw_init
    p, o, losses = params, adamw_init(params), []
    for s in range(steps):
        p, o, loss, _ = engine.private_step(p, o, batch_at(batch, s), step=s)
        losses.append(float(loss))
    return p, o, losses


def drive(engine, params0, batch, ckpt=None, kill_at=None, writer=True):
    """One process lifetime of the kill-and-resume lanes: restore the
    latest checkpoint if there is one, step to STEPS, checkpointing each
    step (rank 0 writes, behind a barrier), and stop just before
    ``kill_at``.  Returns (params, opt, died)."""
    from repro_torch.checkpoint import DPTrainState
    from repro_torch.optim import adamw_init
    params, opt, start = params0, adamw_init(params0), 0
    if ckpt is not None and ckpt.latest_step() is not None:
        st, at = ckpt.restore_state(params, opt)
        params, opt = st.params, st.opt
        engine.load_clip_state(st.clip_state)
        engine.accountant.load_state_dict(st.ledger)
        start = at + 1
    else:
        engine.reset_clip_state()
        engine.accountant.reset()
    for step in range(start, STEPS):
        if kill_at is not None and step == kill_at:
            return params, opt, True
        params, opt, _, _ = engine.private_step(
            params, opt, batch_at(batch, step), step=step)
        if ckpt is not None:
            state = DPTrainState(
                params=params, opt=opt, clip_state=engine.clip_state_dict(),
                ledger=engine.accountant.state_dict(),
                plan_fingerprint=engine.fingerprint(calibration="analytic"),
                run_seed=RUN_SEED, noise_device="cpu",
                mesh_axes=engine.mesh_axes)
            if writer:
                ckpt.save_state(step, state)
            if dist.is_initialized():
                dist.barrier()
    return params, opt, False


# ---------------------------------------------------------------------------
# The lanes


def lanes_4(rank, mesh, data, out_dir):
    from repro_torch.checkpoint import Checkpointer
    params, batch = data["params"], data["batch"]
    res = {}
    res["sigma0_flat"] = run_steps(
        make_engine(params, batch, mesh=mesh), params, batch)[0]
    eng = make_engine(params, batch, sigma=NOISE, mesh=mesh,
                      accountant=True)
    res["elastic_ref"] = drive(eng, params, batch)[0]
    ck = Checkpointer(os.path.join(out_dir, "ck_data4"))
    died = drive(make_engine(params, batch, sigma=NOISE, mesh=mesh,
                             accountant=True), params, batch, ckpt=ck,
                 kill_at=3, writer=rank == 0)[2]
    res["elastic_killed"] = died
    # The training CLI on data:4, stale: two steps, checkpointed at step 1
    # (lanes_2 resumes it on two ranks).
    cli_run(out_dir, "cli_elastic", ["--mesh", "data:4", "--steps", "2",
                                     "--clip-mode", "stale"])
    return res


CLI = ["--arch", "alexnet", "--batch", "8", "--strategy", "auto",
       "--device", "cpu", "--noise", "1.0", "--ckpt-every", "2"]


def cli_run(out_dir, name, extra):
    """``launch.train`` in this rank over the group already initialized;
    (losses, its stdout)."""
    import contextlib
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = train.main(CLI + ["--backend", "gloo", "--ckpt-dir",
                                   os.path.join(out_dir, name)] + extra)
    return losses, buf.getvalue()


def lanes_2(rank, mesh, data, out_dir):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import elastic_mesh_axes
    params, batch = data["params"], data["batch"]
    res = {}
    # The sharded step against the single-device step, every clip mode,
    # at sigma = 0 and 1.3; the flat sigma = 1.3 run twice.
    for mode in ("flat", "per_layer", "stale"):
        for sigma in (0.0, 1.3):
            res[f"step_{mode}_{sigma}"] = run_steps(
                make_engine(params, batch, mode=mode, sigma=sigma,
                            mesh=mesh), params, batch)
    res["repeat_flat_1.3"] = run_steps(
        make_engine(params, batch, sigma=1.3, mesh=mesh), params, batch)[0]
    # Against the JAX package at its parity settings.
    res["jax_parity"] = run_steps(
        make_engine(params, batch, mesh=mesh, lr=1e-4,
                    optimizer=jax_parity_optimizer()), params, batch)
    # The oracle lanes: the released gradient itself.
    for mode in ("flat", "per_layer", "stale"):
        eng = make_engine(params, batch, mode=mode, mesh=mesh,
                          optimizer=grad_extract)
        opt0 = {"step": torch.zeros((), dtype=torch.int32)}
        g1, _, _, aux = eng.private_step(params, opt0, batch)
        res[f"oracle_{mode}"] = g1
        res[f"oracle_{mode}_aux"] = {k: v for k, v in aux.items()
                                     if isinstance(v, torch.Tensor)}
        if mode == "stale":
            res["oracle_stale_steady"] = eng.private_step(params, opt0,
                                                          batch)[0]
    # Kill-and-resume on data:2, bitwise, flat and stale.
    for mode in ("flat", "stale"):
        def eng():
            return make_engine(params, batch, mode=mode, sigma=NOISE,
                               mesh=mesh, accountant=True)
        ref_p, ref_o, _ = drive(eng(), params, batch)
        ck = Checkpointer(os.path.join(out_dir, f"ck_{mode}"))
        assert drive(eng(), params, batch, ckpt=ck, kill_at=KILL_AT,
                     writer=rank == 0)[2]
        res_eng = eng()
        got_p, got_o, _ = drive(res_eng, params, batch, ckpt=ck,
                                writer=rank == 0)
        res[f"resume_{mode}"] = (ref_p, ref_o, got_p, got_o,
                                 res_eng.accountant.steps)
    # Elastic: the data:4 run's checkpoint resumes on data:2.
    ck4 = Checkpointer(os.path.join(out_dir, "ck_data4"))
    meta = ck4.read_meta()
    stored = tuple((n, int(s)) for n, s in meta["mesh_axes"])
    res["elastic_axes"] = (stored, elastic_mesh_axes(
        stored, dist.get_world_size(), batch["img"].shape[0]))
    eng = make_engine(params, batch, sigma=NOISE, mesh=mesh,
                      accountant=True)
    st, _ = ck4.restore_state(params, adamw_init(params))
    res["elastic_fingerprints"] = (
        st.plan_fingerprint, eng.fingerprint(calibration="analytic"),
        eng.fingerprint(calibration="analytic", mesh=st.mesh_axes))
    got_p, _, _ = drive(eng, params, batch, ckpt=ck4, writer=False)
    res["elastic_resumed"] = (got_p, eng.accountant.steps,
                              eng.accountant.state_dict())
    # The training CLI on data:2: straight, and killed before step 2;
    # then the data:4 run's checkpoint resumed with no --mesh on the
    # two live ranks (elastic).
    cli = {}
    for name, extra in (("cli_straight", []),
                        ("cli_killed", ["--fail-at", "2"])):
        cli[name] = cli_run(out_dir, name, ["--mesh", "data:2",
                                            "--steps", "4"] + extra)[1]
    os.environ["WORLD_SIZE"] = str(dist.get_world_size())
    cli["cli_elastic"] = cli_run(out_dir, "cli_elastic",
                                 ["--steps", "4", "--clip-mode",
                                  "stale"])[1]
    res["cli_out"] = cli
    # The verifier on a live mesh traces this rank over its own group.
    rep = make_engine(params, batch, mode="stale", sigma=1.3,
                      mesh=mesh).verify()
    res["live_verify"] = (rep.ok, rep.checked["sharding"])
    # The collective calibration over the group: every rank gets rank
    # 0's calibration (one digest, one plan fingerprint).
    from repro_torch import calibrate
    res["calibration"] = calibrate.measure(
        "data:2", quick=True, device="cpu").to_payload()
    # What raises: an indivisible batch; on a live model axis the
    # families item 14 part 2 leaves out.  FSDP runs (item 14 part 3).
    try:
        make_engine(params, {k: v[:3] for k, v in batch.items()},
                    mesh=mesh)
    except ValueError as e:
        res["indivisible"] = str(e)
    mesh2 = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    res["model_axis"] = deferred_on_model_axis(mesh2, mesh)
    return res


# Serving the recurrent families beside sliced heads: a recurrent state
# (and Zamba2's ring KV cache) there.
RECURRENT_SERVE = {"ssm-serve": "xlstm-125m", "hybrid-serve": "zamba2-2.7b"}
# Block taps (dp_attn) beside sliced heads: reduced DeepSeek-V3 (MLA) and
# reduced Chameleon-34B (GQA with qk-norm).
DP_ATTN_ARCHS = {"mla-dp_attn": "deepseek-v3-671b",
                 "gqa-dp_attn": "chameleon-34b"}


def deferred_on_model_axis(mesh, data_mesh):
    """{case: the NotImplementedError's message} of one private step on
    ``mesh``'s model axis of reduced DeepSeek-V3 and Chameleon under
    block taps (``"mla-dp_attn"``, ``"gqa-dp_attn"``), of serving against
    a cache there: MLA's latent cache (``"mla-cache"``), Chameleon's KV
    cache (``"gqa-cache"``), Seamless's self and cross caches
    (``"cross-cache"``), xLSTM's and Zamba2's recurrent states
    (``"ssm-serve"``, ``"hybrid-serve"``); and ``"fsdp"``: what one
    FSDP step on ``data_mesh`` gave (:func:`fsdp_step_on`)."""
    from repro_torch.configs import get_config
    from repro_torch.core import DPConfig, PrivacyEngine
    from repro_torch.launch.train import make_batch_fn, to_device
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw_init
    out = {}
    for arch in DP_ATTN_ARCHS:
        cfg = get_config(DP_ATTN_ARCHS[arch]).reduced().replace(dp_attn=True)
        model = build_model(cfg)
        p, axes = model.init(0, device="cpu")
        b = to_device(make_batch_fn(cfg, 2, 8)(0), "cpu")
        eng = PrivacyEngine(model.apply, p, b, dp=DPConfig(strategy="bk"),
                            mesh=mesh, param_axes=axes, device="cpu",
                            calibration="analytic")
        local = eng.shard_params(p)
        try:
            eng.private_step(local, adamw_init(local), b)
            out[arch] = "ran"
        except NotImplementedError as e:
            out[arch] = str(e)
    out["mla-cache"] = mla_cache_on_model_axis(mesh)
    out["gqa-cache"] = prefill_on_model_axis(mesh, "chameleon-34b")
    out["cross-cache"] = prefill_on_model_axis(mesh,
                                               "seamless-m4t-large-v2")
    for case, arch in RECURRENT_SERVE.items():
        out[case] = prefill_on_model_axis(mesh, arch)
    out["fsdp"] = fsdp_step_on(data_mesh)
    return out


def fsdp_step_on(mesh) -> str:
    """``"ran"`` when one FSDP step of reduced Chameleon-34B (bk, σ = 1)
    on the live ``mesh`` takes and returns this rank's data slices and
    its gathered params equal the replicated step's on the same mesh;
    otherwise what differed."""
    from repro_torch.configs import get_config
    from repro_torch.core import DPConfig, PrivacyEngine
    from repro_torch.launch.sharding import data_dims, param_sharding
    from repro_torch.launch.train import make_batch_fn, to_device
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.tree import get_subtree, leaf_paths
    cfg = get_config("chameleon-34b").reduced()
    model = build_model(cfg)
    p, axes = model.init(0, device="cpu")
    b = to_device(make_batch_fn(cfg, 2, 8)(0), "cpu")
    specs = param_sharding(axes, mesh, fsdp=True, shapes_tree=p)
    got = {}
    for fsdp in (False, True):
        eng = PrivacyEngine(model.apply, p, b,
                            dp=DPConfig(strategy="bk", noise_multiplier=1.0),
                            mesh=mesh, param_axes=axes, fsdp=fsdp,
                            run_seed=0, device="cpu", calibration="analytic")
        local = eng.shard_params(p)
        new, _, _, _ = eng.private_step(local, adamw_init(local), b, step=0)
        got[fsdp] = (local, eng.gather_params(new))
    for q in leaf_paths(p):
        dims = data_dims(get_subtree(specs, q))
        want = list(get_subtree(p, q).shape)
        for d in dims:
            want[d] //= 2
        if list(get_subtree(got[True][0], q).shape) != want:
            return f"{'/'.join(q)}: not this rank's data slice"
        if not torch.equal(get_subtree(got[True][1], q),
                           get_subtree(got[False][1], q)):
            return f"{'/'.join(q)}: FSDP differs from the replicated step"
    return "ran"


def prefill_on_model_axis(mesh, arch) -> str:
    """The message of ``arch``'s (reduced) prefill on this rank's slices
    under ``mesh``'s model group: serving against a cache beside sliced
    heads."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.models.registry import build_model
    model = build_model(get_config(arch).reduced())
    params, axes = model.init(0, device="cpu")
    specs = sh.param_sharding(axes, mesh, shapes_tree=params)
    ms = sh.model_shard_of(mesh, specs)
    local = sh.shard_params(params, specs, ms)
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    args = ((torch.zeros((2, 4, model.cfg.d_model)),)
            if model.cfg.family == "encdec" else ())
    try:
        with sh.model_parallel(ms):
            model.prefill(local, *args, tokens, 8)
        return "ran"
    except NotImplementedError as e:
        return str(e)


def mla_cache_on_model_axis(mesh) -> str:
    """The message of reduced DeepSeek-V3's MLA, one decode step against
    its latent cache, under ``mesh``'s model group."""
    from repro_torch.configs import get_config
    from repro_torch.core.tapper import Tapper
    from repro_torch.launch import sharding as sh
    from repro_torch.models import attention
    from repro_torch.models.registry import build_model
    c = get_config("deepseek-v3-671b").reduced()
    layers = build_model(c).init(0, device="cpu")[0]["blocks"]["attn"]
    p = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in layers.items()}
    cache = attention.mla_cache(2, 8, c.kv_lora_rank, c.qk_rope_dim)
    try:
        with sh.model_parallel(sh.model_shard_of(mesh)):
            attention.mla_apply(
                Tapper(), "attn", p, torch.zeros(2, 1, c.d_model),
                n_heads=c.n_heads, q_lora_rank=c.q_lora_rank,
                kv_lora_rank=c.kv_lora_rank, qk_nope_dim=c.qk_nope_dim,
                qk_rope_dim=c.qk_rope_dim, v_head_dim=c.v_head_dim,
                cache=cache)
        return "ran"
    except NotImplementedError as e:
        return str(e)


LANES = {2: lanes_2, 4: lanes_4}


def worker(rank: int, world: int, out_dir: str):
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        data = torch.load(os.path.join(out_dir, "in.pt"))
        res = LANES[world](rank, mesh, data, out_dir)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(world: int, out_dir: str, data: dict) -> list:
    """Spawn ``world`` gloo ranks over ``out_dir``, wait at most
    TIMEOUT_S, and return each rank's results."""
    os.makedirs(out_dir, exist_ok=True)
    torch.save(data, os.path.join(out_dir, "in.pt"))
    ctx = mp.start_processes(worker, args=(world, out_dir), nprocs=world,
                             start_method="spawn", join=False)
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world} gloo ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(world)]
