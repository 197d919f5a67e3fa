"""Ranks of the port's model-axis tests (gloo on the CPU).

Not collected by pytest.  ``tests/test_torch_model_axis.py`` spawns one
``data:2,model:2`` world (4 ranks) and one ``model:2`` world (2 ranks),
each once per module, through :func:`start` / :func:`join`; every rank
runs all the lanes of its world (:func:`lanes_4`, :func:`lanes_2`) and
saves what it got to ``rank<r>.pt`` for the parent to compare.  It
imports no JAX (the ranks start in seconds): the parent computes every
reference, single-device and JAX, meanwhile.  Rendezvous is a
``FileStore`` in the run's own directory, and every group and every join
has a timeout of at most 120 s.

The conv lanes are ``tests/test_exactness.py``'s ``conv_model`` and
``conv_plus_head_model`` in the port, written for a model axis: the conv
is column-sharded (out-channels), a partial loss over the rank's channels
is summed over ``model``, and the features are all-gathered for the
3-wide head, which the axis does not divide and so stays replicated.
"""
from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120
STEPS = 4
KILL_AT = 2
NOISE = 0.9
SIGMA = 0.8
RUN_SEED = 7
# (strategy, clip mode) of the step lanes.
STEP_LANES = (("crb", "flat"), ("ghost", "flat"), ("bk", "flat"),
              ("bk", "per_layer"), ("bk", "stale"), ("auto", "flat"),
              ("auto", "per_layer"), ("auto", "stale"))
CONV_GEOM = (4, 6, 9, 3, 2, 1, 1, 1)   # CONV_GEOMS[1]: strided
CONV_AXES = {"c": {"w": ("mlp", None, None, "conv_k"), "b": ("mlp",)}}
CONV_HEAD_AXES = {"c": {"w": ("mlp", None, None, "conv_k"), "b": ("mlp",)},
                  "head": {"w": ("embed", "mlp")}}


# ---------------------------------------------------------------------------
# Models and engines, shared by the ranks and the parent's references


def conv_apply(with_head: bool):
    """The suite's conv (plus 3-wide head) model on a model axis."""
    from repro_torch.launch import sharding as sh
    C, D, HW, K, s, p_, dil, g = CONV_GEOM

    def apply_fn(p, batch, tp):
        w = p["c"]["w"]
        cut = sh.split(w.shape[0], D)
        x = sh.copy_to_model(batch["x"]) if cut else batch["x"]
        y = tp.conv("c", x, w, p["c"]["b"], stride=s, padding=p_,
                    dilation=dil, groups=g)
        t = torch.tanh(y.float())
        if not with_head:
            loss = (t ** 2).sum(dim=(1, 2, 3))
            return sh.reduce_from_model(loss) if cut else loss
        feat = t.mean(dim=(2, 3))
        if cut:
            feat = sh.gather_from_model(feat, -1)
        # JAX promotes the f32 features times a bf16 head to f32.
        o = tp.dense("head", feat, p["head"]["w"].float())
        return (torch.tanh(o.float()) ** 2).sum(dim=1)
    return apply_fn


def lm_model(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    return build_model(get_config(arch).reduced())


def policy(mode: str):
    from repro_torch.core import ClipPolicy
    if mode == "per_layer":
        return ClipPolicy(mode="per_layer", budgets="auto")
    return ClipPolicy(mode=mode)


def grad_extract(grads, state, params, *, lr, weight_decay):
    """Identity 'optimizer': the step's gradient comes out as the params."""
    return grads, state


def momentum(grad, opt, params, *, lr, weight_decay):
    """A custom optimizer callable (the JAX suite's): its state is not
    adamw's or sgdm's, so the engine derives its layout."""
    from repro_torch.tree import tree_map
    mom = tree_map(lambda m, g: 0.9 * m + g, opt["mom"], grad)
    new = tree_map(lambda p, m: p - lr * m, params, mom)
    return new, {"mom": mom, "step": opt["step"] + 1}


def momentum_init(params):
    from repro_torch.tree import tree_map
    return {"mom": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32)}


def engine(apply_fn, params, batch, *, strategy="auto", mode="flat",
           sigma=SIGMA, mesh=None, axes=None, optimizer="sgdm", lr=1e-2,
           accountant=False, C=1.0):
    from repro_torch.core import DPConfig, PrivacyAccountant, PrivacyEngine
    dp = DPConfig(l2_clip=C, noise_multiplier=sigma, strategy=strategy,
                  clipping=policy(mode))
    acct = (PrivacyAccountant(sampling_rate=1 / 128, noise_multiplier=sigma)
            if accountant else None)
    return PrivacyEngine(apply_fn, params, batch, dp=dp, optimizer=optimizer,
                         lr=lr, mesh=mesh, param_axes=axes,
                         run_seed=RUN_SEED, accountant=acct,
                         calibration="analytic", device="cpu")


def opt_init(name, params):
    from repro_torch.optim import adamw_init, sgdm_init
    return {"sgdm": sgdm_init, "adamw": adamw_init}[name](params)


def run_steps(eng, params, batches, optimizer="sgdm"):
    """Steps over ``batches`` from this rank's slices of whole
    ``params``: (slices, optimizer state, losses)."""
    p = eng.shard_params(params)
    o = opt_init(optimizer, p) if isinstance(optimizer, str) \
        else momentum_init(p)
    losses = []
    for s, b in enumerate(batches):
        p, o, loss, _ = eng.private_step(p, o, b, step=s)
        losses.append(float(loss))
    return p, o, losses


def batch_at(batches, step):
    return batches[step % len(batches)]


def drive(eng, params0, batches, ckpt=None, kill_at=None, writer=True):
    """One process lifetime of the kill-and-resume lanes (AdamW): restore
    the latest checkpoint (whole arrays, cut to this rank's slices) if
    there is one, step to STEPS, checkpointing every step (every rank
    gathers, rank 0 writes, behind a barrier), and stop just before
    ``kill_at``.  Returns (slices, opt slices, died)."""
    from repro_torch.checkpoint import DPTrainState
    from repro_torch.optim import adamw_init
    params, start = eng.shard_params(params0), 0
    opt = adamw_init(params)
    if ckpt is not None and ckpt.latest_step() is not None:
        st, at = ckpt.restore_state(params0, adamw_init(params0))
        params, opt = eng.shard_params(st.params), eng.shard_opt(st.opt)
        eng.load_clip_state(st.clip_state)
        eng.accountant.load_state_dict(st.ledger)
        start = at + 1
    else:
        eng.reset_clip_state()
        eng.accountant.reset()
    for step in range(start, STEPS):
        if kill_at is not None and step == kill_at:
            return params, opt, True
        params, opt, _, _ = eng.private_step(
            params, opt, batch_at(batches, step), step=step)
        if ckpt is not None:
            state = DPTrainState(
                params=eng.gather_params(params), opt=eng.gather_opt(opt),
                clip_state=eng.clip_state_dict(),
                ledger=eng.accountant.state_dict(),
                plan_fingerprint=eng.fingerprint(calibration="analytic"),
                run_seed=RUN_SEED, noise_device="cpu",
                mesh_axes=eng.mesh_axes)
            if writer:
                ckpt.save_state(step, state)
            if dist.is_initialized():
                dist.barrier()
    return params, opt, False


CLI = ["--arch", "alexnet", "--batch", "8", "--strategy", "auto",
       "--device", "cpu", "--noise", "1.0", "--ckpt-every", "2",
       "--backend", "gloo", "--steps", "4"]


def cli_run(out_dir, name, extra):
    """``launch.train`` in this rank over the group already initialized;
    its stdout."""
    import contextlib
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(CLI + ["--ckpt-dir", os.path.join(out_dir, name)]
                   + extra)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# The lanes


def step_lanes(data, mesh, lanes=STEP_LANES):
    """{(arch, strategy, mode): (this rank's slices, whole params, losses)}
    after 2 steps at sigma = 0.8 (SGD with momentum)."""
    out = {}
    for arch in ("alexnet", "llama3.2-1b"):
        d, model = data[arch], lm_model(arch)
        for strategy, mode in lanes:
            eng = engine(model.apply, d["params"], d["batches"][0],
                         strategy=strategy, mode=mode, mesh=mesh,
                         axes=d["axes"])
            p, _, losses = run_steps(eng, d["params"], d["batches"])
            out[(arch, strategy, mode)] = (p, eng.gather_params(p), losses)
    return out


def lanes_4(rank, mesh, data, out_dir):
    from repro_torch import calibrate
    from repro_torch.checkpoint import Checkpointer
    res = {"steps": step_lanes(data, mesh)}
    # The conv oracle lanes: the released gradient itself.
    for dt, d in data["conv"].items():
        for mode in ("flat", "per_layer", "stale"):
            head = mode != "flat"
            inp = d["head" if head else "conv"]
            eng = engine(conv_apply(head), inp["params"], inp["batch"],
                         mode=mode, sigma=0.0, mesh=mesh, C=0.1,
                         axes=CONV_HEAD_AXES if head else CONV_AXES,
                         optimizer=grad_extract)
            local = eng.shard_params(inp["params"])
            opt0 = {"step": torch.zeros((), dtype=torch.int32)}
            got = [eng.private_step(local, opt0, inp["batch"])]
            if mode == "stale":
                got.append(eng.private_step(local, opt0, inp["batch"]))
            res[("conv", dt, mode)] = (
                [eng.gather_params(g[0]) for g in got],
                {k: tuple(v.shape) for k, v in local["c"].items()},
                tuple(got[0][3]["per_layer_clip_fraction"].shape)
                if mode == "per_layer" else None)
    # A custom optimizer: its moments are slices of the params' layout.
    d, model = data["llama3.2-1b"], lm_model("llama3.2-1b")
    eng = engine(model.apply, d["params"], d["batches"][0], mesh=mesh,
                 axes=d["axes"], optimizer=momentum)
    p, o, losses = run_steps(eng, d["params"], d["batches"],
                             optimizer=momentum)
    specs = eng.opt_specs(o)
    res["custom"] = (eng.gather_params(p), eng.gather_opt(o), losses,
                     {"mom": o["mom"], "specs": specs})
    # Kill-and-resume bitwise on data:2,model:2, and resumes across model
    # degrees: a one-device checkpoint onto this mesh (its straight
    # run's checkpoints stay for the parent to resume on one device).
    d, model = data["alexnet"], lm_model("alexnet")

    def eng_stale():
        return engine(model.apply, d["params"], d["batches"][0],
                      strategy="auto", mode="stale", sigma=NOISE,
                      mesh=mesh, axes=d["axes"], accountant=True,
                      optimizer="adamw")
    ref_p, ref_o, _ = drive(eng_stale(), d["params"], d["batches"],
                            ckpt=Checkpointer(os.path.join(out_dir,
                                                           "ck_2d")),
                            writer=rank == 0)
    ck = Checkpointer(os.path.join(out_dir, "ck_2d_killed"))
    assert drive(eng_stale(), d["params"], d["batches"], ckpt=ck,
                 kill_at=KILL_AT, writer=rank == 0)[2]
    e = eng_stale()
    got_p, got_o, _ = drive(e, d["params"], d["batches"], ckpt=ck,
                            writer=rank == 0)
    res["resume"] = (ref_p, ref_o, got_p, got_o, e.accountant.steps,
                     e.gather_params(ref_p))
    e = eng_stale()
    got_p, _, _ = drive(e, d["params"], d["batches"], writer=False,
                        ckpt=Checkpointer(os.path.join(out_dir,
                                                       "ck_single")))
    res["from_single"] = (e.gather_params(got_p), e.accountant.steps)
    # The training CLI on data:2,model:2: straight, and killed before
    # step 2.
    res["cli"] = {name: cli_run(out_dir, name,
                                ["--mesh", "data:2,model:2"] + extra)
                  for name, extra in (("cli_straight", []),
                                      ("cli_killed", ["--fail-at", "2"]))}
    # The verifier on a live mesh traces this rank over its own groups.
    rep = engine(model.apply, d["params"], d["batches"][0], mode="stale",
                 mesh=mesh, axes=d["axes"]).verify()
    res["live_verify"] = (rep.ok, rep.checked["sharding"],
                          [f.code for f in rep.errors])
    # The collective calibration over each axis's own group.
    res["calibration"] = calibrate.measure(
        "data:2,model:2", quick=True, device="cpu",
        groups={"data": mesh.get_group("data"),
                "model": mesh.get_group("model")}).to_payload()
    return res


def lanes_2(rank, mesh, data, out_dir):
    res = {"steps": step_lanes(data, mesh, (("auto", "flat"),
                                            ("auto", "stale")))}
    # At sigma = 0 against the JAX package's single-device step.
    for arch in ("alexnet", "llama3.2-1b"):
        d, model = data[arch], lm_model(arch)
        eng = engine(model.apply, d["params"], d["batches"][0], sigma=0.0,
                     mesh=mesh, axes=d["axes"])
        p, _, losses = run_steps(eng, d["params"], d["batches"])
        res[("jax", arch)] = (eng.gather_params(p), losses)
    return res


LANES = {2: lanes_2, 4: lanes_4}


def worker(rank: int, world: int, out_dir: str):
    from torch.distributed.device_mesh import init_device_mesh
    # One intra-op thread a rank: the ranks (and the parent) share the
    # host's cores, and oversubscribed threads spin.
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = init_device_mesh("cpu", (world // 2, 2),
                                mesh_dim_names=("data", "model"))
        data = torch.load(os.path.join(out_dir, "in.pt"))
        res = LANES[world](rank, mesh, data, out_dir)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def start(world: int, out_dir: str, data: dict):
    """Spawn ``world`` gloo ranks over ``out_dir`` (not waiting)."""
    os.makedirs(out_dir, exist_ok=True)
    torch.save(data, os.path.join(out_dir, "in.pt"))
    return mp.start_processes(worker, args=(world, out_dir), nprocs=world,
                              start_method="spawn", join=False)


def join(ctx, world: int, out_dir: str) -> list:
    """Wait at most TIMEOUT_S for :func:`start`'s ranks; each rank's
    results."""
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
