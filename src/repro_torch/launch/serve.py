"""Batched serving driver (the JAX package's ``repro.launch.serve``).

Requests (token prompts) are grouped into fixed-size batches; each batch
is prefilled once and decoded token by token against the KV cache,
greedily, eagerly (one ``decode_step`` call a token).

``--dp-plan`` pre-loads a plan store (written by ``launch/train.py
--plan-json``), so that DP-gradient work colocated with serving finds
its plan by fingerprint and pays no model probe in the serving process;
``--calibration`` registers a saved calibration blob (an unusable one
falls back to the analytic constants with a warning).  ``--device``
(``cuda`` unless the caller asks for ``cpu``) is where the model runs.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
        --n-requests 8 --batch 4 --gen 16

Every LM id of ``configs.SERVED_LM`` is served: the dense ones, the MoE
Granite-3.0-1B-A400M and DeepSeek-V3-671B, the enc-dec
SeamlessM4T-large-v2, and the recurrent xLSTM-125M and Zamba2-2.7B, whose
prefill is one decode step a prompt token.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model


def generate_batch(model, params, prompts, *, max_len: int, gen: int):
    """prompts (B, Tp) -> greedily generated tokens (B, gen).  An enc-dec
    model is given zero source frames of the prompt's length (the
    frontend is a stub, as in the JAX package)."""
    cfg = model.cfg
    if cfg.family == "encdec":
        src = torch.zeros((prompts.shape[0], prompts.shape[1], cfg.d_model),
                          dtype=torch.float32, device=prompts.device)
        logits, cache = model.prefill(params, src, prompts, max_len=max_len)
    else:
        logits, cache = model.prefill(params, prompts, max_len=max_len)
    tok = torch.argmax(logits, -1)
    out = [tok]
    for _ in range(gen - 1):
        logits, cache = model.decode_step(params, cache, tok)
        tok = torch.argmax(logits, -1)
        out.append(tok)
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--dp-plan", default=None,
                    help="plan store to pre-load (skips the planning probe "
                         "for colocated DP-gradient work)")
    ap.add_argument("--calibration", default=None,
                    help="calibration JSON to register; unusable blobs "
                         "fall back to the analytic constants with a "
                         "named warning")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.calibration:
        from repro_torch import calibrate
        calib = calibrate.load_or_fallback(args.calibration, device=device)
        if calib is not None:
            calibrate.register(calib)
            print(f"[calibrate] registered {calib.digest()} "
                  f"(source={calib.source})")
    if args.dp_plan:
        from repro_torch.core import costmodel
        n = costmodel.load_plan_store(args.dp_plan)
        print(f"[dp] pre-loaded {n} exec plan(s) from {args.dp_plan}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params, _ = model.init(0, device=device)

    rng = np.random.RandomState(0)
    queue = [rng.randint(0, cfg.vocab, args.prompt_len).astype(np.int32)
             for _ in range(args.n_requests)]

    t0 = time.time()
    done = 0
    while queue:
        batch = queue[: args.batch]
        queue = queue[args.batch:]
        while len(batch) < args.batch:        # pad the final batch
            batch.append(batch[-1])
        prompts = torch.from_numpy(np.stack(batch)).to(device)
        toks = generate_batch(model, params, prompts,
                              max_len=args.prompt_len + args.gen,
                              gen=args.gen)
        done += len(batch)
        print(f"batch done: {tuple(toks.shape)} "
              f"sample={toks[0, :8].cpu().numpy()}")
    dt = time.time() - t0
    print(f"served {done} requests in {dt:.2f}s "
          f"({done * args.gen / dt:.1f} tok/s aggregate)")


if __name__ == "__main__":
    main()
