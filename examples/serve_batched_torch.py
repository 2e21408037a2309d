"""Batched serving across architecture families on the PyTorch port:
prefill + KV-cache decode.

    PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]

The counterpart of ``examples/serve_batched.py`` on ``repro_torch``.  Serves
three different cache disciplines side by side on smoke-scale models:
  * qwen3  — full KV cache (GQA),
  * gemma3 — sliding-window ring caches (5 local : 1 global),
  * mamba2 — constant recurrent state (the long_500k discipline).
Prints per-family decode throughput and shows the generations are
deterministic for identical prompts.  Runs on CUDA, through the port's
kernels, unless ``--device cpu`` is given.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model

ARCHS = ("qwen3-4b", "gemma3-4b", "mamba2-370m")


def serve(arch: str, device, batch: int = 4, prompt_len: int = 24, gen: int = 12):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device).manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (batch, prompt_len))).to(device)
    max_seq = prompt_len + gen
    logits, cache = model.prefill(params, {"tokens": toks}, max_seq=max_seq)
    nxt = logits[:, -1].argmax(-1, keepdim=True)
    positions = torch.arange(prompt_len, max_seq, device=device)  # 0-d device positions
    out = [nxt]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = model.decode_step(params, cache, nxt, positions[i])
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        out.append(nxt)
    seq = torch.cat(out, dim=1).cpu()  # waits for the device
    dt = time.perf_counter() - t0
    print(f"{arch:12s} {batch} seqs x {gen} tokens  "
          f"{batch * (gen - 1) / max(dt, 1e-9):7.1f} tok/s   sample={seq[0, :8].tolist()}")
    return seq


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to serve on the CPU")
    out = {}
    for arch in ARCHS:
        a = serve(arch, device)
        b = serve(arch, device)
        assert torch.equal(a, b), "serving must be deterministic"
        out[arch] = a
    print("deterministic across repeats: OK")
    return out


if __name__ == "__main__":
    main()
