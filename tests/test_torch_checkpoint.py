"""The port's checkpointing (``repro_torch.checkpoint``), the training launcher's
``--ckpt-dir``/``--ckpt-every`` with resume, and ``examples/train_100m_torch.py``
against the JAX package on the CPU.

``tests/test_checkpoint.py``'s six cases over port trees; the on-disk
layout against the reference's manager (the same manifest bytes, the same
arrays, each restoring the other's); bf16 leaves and ``AdamWState``'s count
bit for bit; the async snapshot against in-place mutation; failure injection
and resume through ``train.main``, bit for bit; a reference-written checkpoint
resumed by the port within ``test_five_train_steps_match_jax``'s tolerance;
and the 100M example's config and resume.  Runs that are compared bit for
bit run at one thread (ATen's CPU kernels split work by thread; ROADMAP C2).
"""

import dataclasses
import importlib.util
import os
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jax_manager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import train as jax_train
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint import CheckpointManager, latest_step, restore_pytree, save_pytree
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import adamw_from_jax, params_from_jax
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.tree import map_tree, tree_leaves

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones(5, dtype=torch.int32), "c": [torch.zeros(2, 2)] * 2},
    }


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes, so that == compares bits (NaN payloads, -0)."""
    return t.contiguous().view(torch.uint8)


# ------------------------------------------------ tests/test_checkpoint.py
@pytest.mark.parametrize("how", ["save_pytree", "save", "async_save"])
def test_roundtrip(tmp_path, how):
    """test_checkpoint.py's ``test_roundtrip`` (save_pytree) and
    ``test_async_save_then_restore`` (async_save), and the manager's save."""
    t = tree()
    if how == "save_pytree":
        save_pytree(t, str(tmp_path), 7)
        out, step = restore_pytree(map_tree(lambda x: x, t), str(tmp_path))
    else:
        mgr = CheckpointManager(str(tmp_path))
        getattr(mgr, how)(t, 7)
        mgr.wait()
        out, step = mgr.restore(tree())
        assert [s["step"] for s in mgr.saves] == [7]
        assert mgr.saves[0]["async"] == (how == "async_save")
    assert step == 7
    for a, b in zip(tree_leaves(t), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 5, 9):
        mgr.save(tree(), s)
    assert mgr.latest_step() == 9
    assert sorted(os.listdir(tmp_path)) == ["step_00000005", "step_00000009"]


def test_partial_write_is_invisible(tmp_path):
    """A .tmp dir from a crashed writer must not be picked up."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(tree(), 1)
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert mgr.latest_step() == 1
    # a step dir without MANIFEST (mid-rename crash) is also skipped
    os.makedirs(tmp_path / "step_00000003")
    assert mgr.latest_step() == 1


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_pytree(tree(), str(tmp_path / "nope"))


def test_template_dtype_cast(tmp_path):
    save_pytree({"w": torch.ones(4)}, str(tmp_path), 0)
    out, _ = restore_pytree({"w": torch.zeros(4, dtype=torch.bfloat16)}, str(tmp_path))
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"].float(), torch.ones(4))


# ------------------------------------------------- against the reference
def _np_trees(rng, with_opt: bool):
    """(the reference's tree, the port's) of the same numpy arrays: nested
    dicts and lists, or (params, AdamWState) with a 0-d int32 count."""
    params = {
        "embed": rng.standard_normal((6, 4), dtype=np.float32),
        "blocks": [{"w": rng.standard_normal((4, 4), dtype=np.float32),
                    "ids": np.arange(5, dtype=np.int32)} for _ in range(2)],
        "final_norm": {"scale": np.ones(4, np.float32)},
    }
    if not with_opt:
        return params, params
    m = jax.tree.map(lambda a: a + 1, params)
    v = jax.tree.map(lambda a: a * 2, params)
    count = np.asarray(3, np.int32)
    return (params, jax_adamw.AdamWState(m, v, count)), (params, AdamWState(m, v, count))


def _as_reference(tree, with_opt: bool):
    """A port tree as the reference's pytree (its ``AdamWState``)."""
    if not with_opt:
        return tree
    params, opt = tree
    return params, jax_adamw.AdamWState(opt.m, opt.v, opt.count)


@pytest.mark.parametrize("with_opt", [False, True], ids=["nested", "params-and-adamw"])
def test_layout_equals_the_reference(tmp_path, with_opt):
    """The same numpy-valued tree written by both managers: the same
    MANIFEST.json bytes (keys, ``AdamWState`` as ``1/0``, ``1/1``, ``1/2``),
    the same arrays under the same keys; each restores the other's."""
    ref_tree, port_tree = _np_trees(np.random.default_rng(0), with_opt)
    jax_manager.save_pytree(ref_tree, str(tmp_path / "ref"), 4)
    save_pytree(port_tree, str(tmp_path / "port"), 4)
    ref_dir, port_dir = tmp_path / "ref" / "step_00000004", tmp_path / "port" / "step_00000004"
    assert (ref_dir / "MANIFEST.json").read_bytes() == (port_dir / "MANIFEST.json").read_bytes()
    with np.load(ref_dir / "shard_0.npz") as a, np.load(port_dir / "shard_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        if with_opt:
            assert {"1/2", "1/0/embed", "1/1/blocks/1/w"} <= set(a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    got, step = restore_pytree(port_tree, str(tmp_path / "ref"))
    back, jstep = jax_manager.restore_pytree(ref_tree, str(tmp_path / "port"))
    assert step == jstep == 4
    want = jax.tree.leaves(ref_tree)
    got_leaves = jax.tree.leaves(_as_reference(got, with_opt))
    assert len(got_leaves) == len(jax.tree.leaves(back)) == len(want)
    for g, b, w in zip(got_leaves, jax.tree.leaves(back), want):
        assert g.dtype == b.dtype == w.dtype
        assert np.array_equal(g, w) and np.array_equal(b, w)
    if with_opt:
        assert isinstance(got[1], AdamWState) and got[1].count == 3


def test_bf16_and_adamw_count_round_trip_bit_for_bit(tmp_path):
    """bf16 leaves (NaN with a payload, -0, inf, a subnormal, random values)
    and bf16 moments come back bit for bit, an fp16 leaf too, and
    ``AdamWState.count`` as the same int."""
    gen = torch.Generator().manual_seed(0)
    special = torch.tensor([0x7FC1, 0x8000, 0x7F80, 0x0001, 0xFF81], dtype=torch.int32)
    odd = special.to(torch.int16).view(torch.bfloat16)
    w = torch.randn(33, 7, generator=gen).bfloat16()
    params = {"w": w, "odd": odd, "h": torch.randn(9, generator=gen).half(),
              "scale": torch.randn(7, generator=gen)}
    opt = AdamWState(m=map_tree(lambda t: torch.randn(t.shape, generator=gen).to(t.dtype), params),
                     v=map_tree(lambda t: torch.rand(t.shape, generator=gen).to(t.dtype), params),
                     count=123_456)
    save_pytree((params, opt), str(tmp_path), 2)
    zeros = map_tree(torch.zeros_like, params)
    (p2, o2), _ = restore_pytree((zeros, AdamWState(zeros, zeros, 0)), str(tmp_path))
    assert type(o2.count) is int and o2.count == 123_456
    for a, b in zip(tree_leaves((params, opt.m, opt.v)), tree_leaves((p2, o2.m, o2.v))):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def test_reference_bf16_leaf_restores_bit_for_bit(tmp_path):
    """The reference's ``save_pytree`` writes an ml_dtypes bf16 leaf as a
    2-byte void array (``|V2``); the port reads it into a bf16 template as
    its bits, specials included, and refuses it under any other dtype with
    a ValueError naming the key and both dtypes."""
    rng = np.random.default_rng(0)
    w = jax.numpy.asarray(rng.standard_normal((4, 8)), jax.numpy.bfloat16)
    w = w.at[0, :4].set(jax.numpy.asarray([np.nan, -0.0, np.inf, 1e-40], jax.numpy.bfloat16))
    b = rng.standard_normal(3).astype(np.float32)
    jax_manager.save_pytree({"w": w, "b": b}, str(tmp_path), 0)
    with np.load(tmp_path / "step_00000000" / "shard_0.npz") as data:
        assert data["w"].dtype.kind == "V" and data["w"].dtype.itemsize == 2
    like = {"w": torch.zeros(4, 8, dtype=torch.bfloat16), "b": torch.zeros(3)}
    got, step = restore_pytree(like, str(tmp_path))
    assert step == 0 and got["w"].dtype == torch.bfloat16
    want_w = torch.from_numpy(np.array(w).view(np.int16))
    assert torch.equal(got["w"].view(torch.int16), want_w)
    assert torch.equal(_bits(got["b"]), _bits(torch.from_numpy(b)))
    with pytest.raises(ValueError, match=r"'w'.*\|V2.*torch.float32"):
        restore_pytree({"w": torch.zeros(4, 8), "b": torch.zeros(3)}, str(tmp_path))


def test_async_save_snapshots_before_returning(tmp_path):
    """``async_save`` then, at once, ``mul_`` of every leaf in place (as the
    port's AdamW rewrites params, m and v): the checkpoint holds the values
    from before the mutation."""
    params = {"w": torch.randn(64, 32), "b": torch.randn(32).bfloat16()}
    opt = adamw_init(params)
    opt.m["w"].add_(1.0)
    before = [t.clone() for t in tree_leaves((params, opt.m, opt.v))]
    mgr = CheckpointManager(str(tmp_path))
    mgr.async_save((params, opt), 1)
    for t in tree_leaves((params, opt.m, opt.v)):
        t.mul_(3.0).add_(1.0)
    mgr.wait()
    (p2, o2), _ = mgr.restore((params, opt))
    for a, b in zip(before, tree_leaves((p2, o2.m, o2.v))):
        assert torch.equal(_bits(a), _bits(b))
    mgr.async_save((params, opt), 2)  # the buffers are reused for the next save
    mgr.wait()
    (p3, _), _ = mgr.restore((params, opt))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(p3)))


# -------------------------------------------------------------- train.main
ARGS = ["--smoke", "--device", "cpu", "--steps", "8", "--batch", "2", "--seq", "32"]


def test_train_failure_injection_and_resume(tmp_path, capsys, one_thread):
    """The reference's ``test_train_failure_injection_and_resume`` on the
    port, bit for bit: the injected error leaves ``main`` (after the save of
    step 3 in flight is joined), the relaunch resumes at step 4 with the
    batches of steps 4-7, and its losses equal an uninterrupted run's."""
    plain = train.main(ARGS)
    ckpt = str(tmp_path / "ckpt")
    args = ARGS + ["--ckpt-dir", ckpt, "--ckpt-every", "3"]
    with pytest.raises(RuntimeError, match="injected failure at step 6") as err:
        train.main(args + ["--fail-at", "6"])
    assert err.value.run.losses == plain[:6]
    assert [s["step"] for s in err.value.run.saves] == [3]
    assert latest_step(ckpt) == 3 and not any(n.endswith(".tmp") for n in os.listdir(ckpt))
    capsys.readouterr()
    resumed = train.main(args)
    assert "[resume] restored checkpoint, continuing at step 4" in capsys.readouterr().out
    assert resumed == plain[4:]
    assert latest_step(ckpt) == 7
    assert sorted(os.listdir(ckpt)) == ["step_00000003", "step_00000006", "step_00000007"]


def test_reference_checkpoint_resumes_on_the_port(tmp_path):
    """The reference's ``train.main`` trains its smoke qwen3 with ``--ckpt-dir``; the
    port restores that checkpoint (the reference's ``restore_pytree``, then
    ``params_from_jax`` and ``adamw_from_jax``) and takes the next steps
    through ``build_train_step`` on the same batches: losses within
    ``test_five_train_steps_match_jax``'s 1e-5 of the reference's resumed
    run."""
    ckpt = str(tmp_path / "ckpt")
    args = ["--arch", "qwen3-4b", "--smoke", "--batch", "2", "--seq", "32", "--ckpt-dir", ckpt,
            "--ckpt-every", "2"]
    jax_train.main(args + ["--steps", "4"])
    jcfg = jax_smoke_config("qwen3-4b")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    (jp, jopt), step = jax_manager.restore_pytree((jparams, jax_adamw.adamw_init(jparams)),
                                                  ckpt, 3)
    want = jax_train.main(args + ["--steps", "6"])  # resumes at step 4
    assert step == 3 and len(want) == 2

    cfg = get_smoke_config("qwen3-4b")
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    opt = adamw_from_jax(jax.tree.map(np.asarray, jopt), cfg, "cpu")
    assert opt.count == 4
    step_fn = build_train_step(build_model(cfg, "cpu"), cfg)
    batch_fn = train.make_batch_fn(cfg, 2, 32, 0, "cpu")
    for s, w in zip((4, 5), want):
        params, opt, metrics = step_fn(params, opt, batch_fn(s), s)
        assert abs(float(metrics["loss"]) - w) <= 1e-5 * abs(w), (s, float(metrics["loss"]), w)


# ----------------------------------------------------------------- example
def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_example_config_is_the_reference():
    """``config_100m`` field by field, and the same parameter count."""
    ref = _load(ROOT / "examples" / "train_100m.py", "train_100m")
    port = _load(ROOT / "examples" / "train_100m_torch.py", "train_100m_torch")
    rcfg, pcfg = ref.config_100m(), port.config_100m()
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax_build_model(rcfg).init_shapes()))
    n_port = sum(t.numel() for t in tree_leaves(
        build_model(pcfg, "cpu").init_shapes(torch.float32)))
    assert n_ref == n_port == 93_454_720


def test_example_resumes_with_the_next_batches(tmp_path, capsys, one_thread):
    """3 steps, then ``--steps 5`` in the same directory: it resumes at step 3
    and its losses equal an uninterrupted 5-step run's steps 3-4, so the
    batches continue where the first run stopped."""
    example = _load(ROOT / "examples" / "train_100m_torch.py", "train_100m_torch")
    args = ["--device", "cpu", "--batch", "1", "--seq", "32"]
    try:
        first = example.main(args + ["--steps", "3", "--ckpt-dir", str(tmp_path / "a")])
        capsys.readouterr()
        resumed = example.main(args + ["--steps", "5", "--ckpt-dir", str(tmp_path / "a")])
        out = capsys.readouterr().out
        plain = example.main(args + ["--steps", "5", "--ckpt-dir", str(tmp_path / "b")])
        assert "resumed at step 3" in out and "model: qwen3-100m  params=93.5M" in out
        assert len(first) == 3 and resumed == plain[3:]
        assert latest_step(str(tmp_path / "a")) == 4
        assert sorted(os.listdir(tmp_path / "a")) == ["step_00000002", "step_00000004"]
    finally:  # about 1.1 GB a checkpoint
        shutil.rmtree(tmp_path, ignore_errors=True)
