#!/usr/bin/env python3
"""Time ``PrivacyEngine.private_step`` on one card, from a given source
tree, so two trees can be compared in one run on one card.

    python3 scripts/step_time.py --src <checkout>/src --label change

Lanes (full width, σ = 1, C = 1, AdamW, seed 0, synthetic data):
AlexNet (3x256x256, 1000 classes, B = 32) ``auto`` flat with
``conv_impl="pallas"``, and Llama-3.2-1B (B = 8, T = 1024, bf16,
``attn_impl="flash"``) ``auto`` stale (its first step is the flat
bootstrap and is not counted).  Each lane runs ``WARMUP`` untimed
steps, then ``STEPS`` steps timed on the host clock, each ended by a
synchronise.  One JSON line a lane: the tree's label, the step ms, their
median, the kernel launches a step, the card's name and power limit
(``nvidia-smi``).  To compare two trees, run this script on each in
turns (parent, change, change, parent) within one call on one card.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

STEPS = 10
WARMUP = 3


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="the src/ directory of the tree to time")
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("step_time: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.core import ClipPolicy, DPConfig, NormCfg, PrivacyEngine
    from repro_torch.data import SyntheticImageDataset, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import CNN
    from repro_torch.models.lm import TransformerLM
    from repro_torch.optim import adamw_init

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    n = WARMUP + STEPS

    def lane(name, model, batches, clipping, bootstrap):
        params, _ = model.init(0, device="cuda")
        dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, strategy="auto",
                      norm=NormCfg(conv_impl="pallas"),
                      clipping=ClipPolicy(mode=clipping))
        eng = PrivacyEngine(model.apply, params, batches[0], dp, lr=1e-4,
                            run_seed=0, device="cuda")
        opt = adamw_init(params)
        ms, launches = [], None
        for s in range(n + bootstrap):
            ops.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, _, _ = eng.private_step(
                params, opt, batches[s % len(batches)], step=s)
            torch.cuda.synchronize()
            if s >= bootstrap + WARMUP:
                ms.append((time.perf_counter() - t) * 1e3)
                launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        print(json.dumps({"label": args.label, "lane": name, "step_ms": ms,
                          "median_ms": statistics.median(ms),
                          "launches_per_step": launches,
                          "card": smi.strip()}), flush=True)
        del params, opt, eng
        torch.cuda.empty_cache()

    ds = SyntheticImageDataset(256, 1000, n_examples=4096, seed=0)
    img = []
    for s in range(4):
        b = ds.batch(range(s * 32, (s + 1) * 32))
        img.append({"img": torch.from_numpy(b["img"]).cuda(),
                    "label": torch.from_numpy(
                        b["label"].astype(np.int64)).cuda()})
    lane("alexnet_auto_flat", CNN(get_config("alexnet")), img, "flat", 0)
    cfg = get_config("llama3.2-1b").replace(attn_impl="flash")
    ds = SyntheticLMDataset(cfg.vocab, 1024, n_examples=4096, seed=0)
    tok = [{k: torch.from_numpy(v).cuda() for k, v in
            ds.batch(range(s * 8, (s + 1) * 8)).items()} for s in range(4)]
    lane("llama_auto_stale", TransformerLM(cfg), tok, "stale", 1)


if __name__ == "__main__":
    main()
