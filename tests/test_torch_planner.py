"""The port's ``MemoryPlanner`` facade (``repro_torch.core.planner``), on the CPU.

The invariants of the reference's ``tests/test_planner.py`` hold on the
port's facade over the port's own qwen3-4b smoke trace; a plan cache that
the reference's facade wrote reads through the port's facade and key into
an equal report; ``train --plan --plan-cache`` prints the reference's
``[plan]`` line and restores it on a second run; and the quickstart
counterpart runs.
"""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.planner import MemoryPlanner as R_MemoryPlanner
from repro.core.simulator import TPU_V5E as R_TPU_V5E
from repro.models import build_model as jax_build_model
from repro.plan import PlanCache as R_PlanCache
from repro.plan import PlanKey as R_PlanKey
from repro_torch.configs import get_smoke_config
from repro_torch.core import H100_SXM, TPU_V5E, MemoryPlanner
from repro_torch.core.offload import KNOWN_NAMES
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.plan import PlanCache, PlanKey

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def planner():
    """The reference fixture's config and shapes (``tests/test_planner.py``)."""
    cfg = get_smoke_config("qwen3-4b").reduced(d_model=128, d_ff=512, vocab_size=2048)
    model = build_model(cfg, "cpu")
    batch = {k: torch.empty(4, 128, dtype=torch.long, device="meta") for k in ("tokens", "labels")}

    def step(params, batch):
        return model.loss(params, batch)[0]

    return MemoryPlanner(step, model.init_shapes(), batch, size_threshold=1 << 16)


def test_pool_report(planner):
    rep = planner.report()
    assert planner.hw is H100_SXM
    assert rep.num_variables > 50
    assert rep.smartpool_footprint >= rep.peak_load
    assert rep.smartpool_ratio <= rep.cnmem_ratio + 1e-9
    # exact allocator footprint == raw peak load (report's peak is aligned)
    assert rep.exact_footprint <= rep.peak_load


def test_swap_report_limit_respected(planner):
    limit = int(planner.swap.peak_load * 0.85)
    rep = planner.swap_report(limit)
    assert rep.num_selected > 0
    assert rep.selected_bytes > 0
    assert rep.overhead >= 0.0
    assert rep.load_min <= rep.peak_load


def test_offload_plan_names_are_known(planner):
    limit = int(planner.swap.peak_load * 0.7)
    plan = planner.offload_plan(limit)
    assert all(n in KNOWN_NAMES for n in plan.offload_names)


def test_reference_plan_cache_reads_through_the_port(tmp_path):
    """A cache the reference's facade solved and wrote is read by the port's
    facade under the same key, with no step function, into an equal report."""
    cfg = jax_smoke_config("qwen3-4b")
    model = jax_build_model(cfg)
    batch = {k: jax.ShapeDtypeStruct((2, 32), jnp.int32) for k in ("tokens", "labels")}
    sig = "train:b2s32:smoke"
    ref = R_MemoryPlanner(lambda p, b: model.loss(p, b)[0], model.init_shapes(), batch,
                          hw=R_TPU_V5E, cache=R_PlanCache(tmp_path),
                          key=R_PlanKey("qwen3-4b", sig, R_TPU_V5E.name))
    want = ref.report().as_dict()
    port = MemoryPlanner(None, hw=TPU_V5E, cache=PlanCache(tmp_path),
                         key=PlanKey("qwen3-4b", sig, TPU_V5E.name))
    assert port.from_cache
    assert port.report().as_dict() == want


def test_train_plan_is_solved_then_restored(tmp_path):
    argv = ["--smoke", "--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "32",
            "--plan", "--plan-cache", str(tmp_path)]
    lines = []
    for _ in range(2):
        out = io.StringIO()
        with redirect_stdout(out):
            train.main(argv)
        lines.append(next(l for l in out.getvalue().splitlines() if l.startswith("[plan]")))
    assert lines[0].startswith("[plan] vars=") and " smartpool x" in lines[0]
    assert "cnmem x" in lines[0] and "restored" not in lines[0]
    assert lines[1] == lines[0] + " (restored from cache)"
    assert [p.name.startswith("qwen3-4b_train_b2s32_smoke_h100_sxm") for p in tmp_path.iterdir()
            if p.suffix == ".json"] == [True]


def test_quickstart_counterpart_runs():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, str(REPO / "examples" / "quickstart_torch.py"),
                           "--device", "cpu"], env=env, capture_output=True, text=True,
                          timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "reports identical" in proc.stdout
    assert proc.stdout.count("  step ") == 5
