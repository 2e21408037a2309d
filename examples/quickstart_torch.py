"""Quickstart on the PyTorch port: the paper's memory planner on a real
training step, end to end.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The same steps as ``examples/quickstart.py`` on ``repro_torch``:

1. builds a small qwen3-family model (the quickstart config),
2. runs the ``repro_torch.plan`` pipeline on its loss step: TraceCapture
   traces the step on fake tensors (``core.trace``: no memory, no launch)
   into a MemoryProgram, PoolPlacement runs SmartPool (offline DSA) against
   the CnMem-style online pool and the exact allocator — the paper's Table
   I quantities, under ``H100_SXM``,
3. runs AutoSwap scorers from the strategy registry to find the largest
   zero-overhead memory-load reduction — the paper's Table II quantity,
4. persists the solved plan to an on-disk artifact and reloads it without
   tracing, showing the solve-once/reuse-forever contract (paper §V),
5. trains five steps (fp32 masters, AdamW) to show nothing about the model
   changed.  Runs on CUDA unless ``--device cpu`` is given.
"""

import argparse
import tempfile

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import LayerSpec
from repro_torch.core import H100_SXM
from repro_torch.core.planner import MemoryPlanner
from repro_torch.data import SyntheticTokens
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model
from repro_torch.optim import adamw_init
from repro_torch.plan import PlanCache, PlanKey, scorer_names


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")

    cfg = get_smoke_config("qwen3-4b").reduced(
        name="quickstart", num_layers=4, d_model=256, num_heads=8, num_kv_heads=4,
        head_dim=32, d_ff=1024, vocab_size=8192,
        program=(((LayerSpec(attn="full", ffn="dense"),), 4),),
    )
    model = build_model(cfg, device)
    B, S = 8, 256
    batch = {k: torch.empty(B, S, dtype=torch.long, device="meta") for k in ("tokens", "labels")}
    pshapes = model.init_shapes()

    def step(params, batch):
        return model.loss(params, batch)[0]

    print("== planning (model-transparent, from the traced graph) ==")
    with tempfile.TemporaryDirectory() as plan_dir:
        cache = PlanCache(plan_dir)
        key = PlanKey("quickstart", f"train:b{B}s{S}", H100_SXM.name)
        planner = MemoryPlanner(step, pshapes, batch, hw=H100_SXM, cache=cache, key=key)
        rep = planner.report()
        print(f" variables            : {rep.num_variables}")
        print(f" peak load omega(G)   : {rep.peak_load/2**20:8.2f} MiB")
        print(f" SmartPool chi(G)     : {rep.smartpool_footprint/2**20:8.2f} MiB "
              f"(ratio {rep.smartpool_ratio:.4f})")
        print(f" CnMem-style pool     : {rep.cnmem_footprint/2**20:8.2f} MiB "
              f"(ratio {rep.cnmem_ratio:.4f})")

        print("\n== AutoSwap: zero-overhead reduction per priority score ==")
        for m in (s for s in scorer_names() if s != "bo"):
            limit, ov = planner.swap.max_zero_overhead_reduction(method=m, grid=16)
            red = 100 * (1 - limit / max(planner.swap.peak_load, 1))
            print(f"  {m:6s}: load -> {limit/2**20:8.2f} MiB  (-{red:.1f}%), overhead {ov*100:.2f}%")

        print("\n== solve once, reuse forever: reload the plan artifact ==")
        reloaded = MemoryPlanner(None, cache=cache, key=key)  # no step_fn: no re-trace
        rep2 = reloaded.report()
        assert rep2.as_dict() == rep.as_dict()
        print(f" artifact {cache.keys()[0]}.json restored "
              f"(from_cache={reloaded.from_cache}), reports identical")

    print("\n== training (unchanged numerics) ==")
    torch.backends.cuda.matmul.allow_tf32 = False
    params = model.init(torch.Generator(device).manual_seed(0), dtype=torch.float32)
    opt = adamw_init(params)
    train = build_train_step(model, cfg)
    ds = SyntheticTokens(cfg.vocab_size, S, B)
    for i in range(5):
        b = {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
             for k, v in ds.batch_at(i).items()}
        params, opt, metrics = train(params, opt, b, i)
        print(f"  step {i}  loss {float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
