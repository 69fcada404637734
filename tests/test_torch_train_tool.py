"""The training tool and its runtime, the port on the CPU: ``train_model``
(exact resume, validation on draws of its own, prefetch, the
loss-second-moment sampler, per-sample logs, the device sample bank),
the bank's eviction, ``MetricWriter``, ``PrefetchLoader``,
``prefetch_iter``, the dataset wrappers, ``optim_config_from`` and
``load_codec_params`` against the JAX package, and
``python -m raggesture_tpu_torch.tools.train`` end to end.

Equalities here are bitwise: the runs compared draw the same values from
the same generator state and run the same float32 operations in the same
order.  The metrics rows' keys are held against the JAX runner's, from
one JAX ``train_model`` run on the same records.
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_runtime import _ListDataset, _records
from test_torch_common import port_arch_config, port_model_and_jax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("basegesture_len150_beat.py", "basegesture_len150_beat_spk2.py",
           "tiny_smoke.py")


def _cfg():
    from raggesture_tpu.datasets.fixtures import tiny_arch_config

    return tiny_arch_config()


def _model(seed=1):
    from raggesture_tpu_torch.models.architecture import create_model

    return create_model(port_arch_config(_cfg()), device="cpu", seed=seed,
                        zero_init_std=0.05)


def _loader(n=16, batch=4, shuffle=True):
    from raggesture_tpu_torch.datasets.sampler import DataLoader

    return DataLoader(_ListDataset(_records(n)), batch_size=batch,
                      shuffle=shuffle, drop_last=True)


def _train(wd, max_epochs=2, model=None, **kw):
    from raggesture_tpu_torch.train.loop import OptimConfig
    from raggesture_tpu_torch.train.runner import train_model

    model = model or _model()
    kw.setdefault("checkpoint_interval", 1)
    state = train_model(model, kw.pop("loader", None) or _loader(),
                        OptimConfig(lr=1e-3, total_steps=16),
                        max_epochs=max_epochs, workdir=str(wd),
                        log_interval=1, tensorboard=False, seed=3, **kw)
    return state


def _rows(wd, prefix="train"):
    with open(os.path.join(str(wd), "metrics.jsonl")) as f:
        rows = [json.loads(l) for l in f]
    return [r for r in rows if r["prefix"] == prefix]


def _losses(rows):
    return [(r["step"], r["recon_loss"], r["grad_norm"]) for r in rows]


def _same_params(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)


# ------------------------------------------------------------- the runner

def test_two_epochs_then_resume_equal_one_run(tmp_path):
    """Two epochs, then a resume from ``latest`` to three, equal three
    epochs in one run: the third epoch's losses and every parameter; the
    resume from an explicit checkpoint file also."""
    whole = _train(tmp_path / "whole", max_epochs=3)
    _train(tmp_path / "cut", max_epochs=2)
    resumed = _train(tmp_path / "cut", max_epochs=3, resume=True)
    assert resumed.step == whole.step == 12
    assert _same_params(resumed, whole)
    assert _losses(_rows(tmp_path / "cut"))[-4:] == \
        _losses(_rows(tmp_path / "whole"))[-4:]
    assert sorted(os.listdir(tmp_path / "cut" / "checkpoints")) == [
        "epoch_0.pt", "epoch_1.pt", "epoch_2.pt"]
    again = _train(tmp_path / "again", max_epochs=3, resume_checkpoint=str(
        tmp_path / "cut" / "checkpoints" / "epoch_1.pt"))
    assert _same_params(again, whole)


def test_validation_leaves_the_training_draws_unchanged(tmp_path):
    """With validation each epoch the training rows and parameters equal a
    run without it; val rows come per epoch, decorrelated across epochs."""
    plain = _train(tmp_path / "plain")
    val = _train(tmp_path / "val",
                 val_loader=_loader(8, shuffle=False), val_max_batches=2)
    assert _same_params(plain, val)
    assert _losses(_rows(tmp_path / "plain")) == _losses(_rows(tmp_path / "val"))
    vrows = _rows(tmp_path / "val", "val")
    assert [r["epoch"] for r in vrows] == [0, 1]
    assert vrows[0]["recon_loss"] != vrows[1]["recon_loss"]
    assert all(np.isfinite(r["recon_loss"]) for r in vrows)


def test_multi_step_with_prefetch_equals_single_steps(tmp_path):
    """One step a batch (the port runs no stacks: ``--multi-step`` is
    accepted and changes nothing), staged two ahead by the prefetch
    thread, equals the same steps staged in line, bitwise, with a row
    every step."""
    single = _train(tmp_path / "single", device_prefetch=0)
    multi = _train(tmp_path / "multi", device_prefetch=2)
    assert multi.step == single.step == 8
    assert _same_params(single, multi)
    assert _losses(_rows(tmp_path / "multi")) == \
        _losses(_rows(tmp_path / "single"))
    assert [r["step"] for r in _rows(tmp_path / "multi")] == list(
        range(1, 9))


def test_loss_second_moment_sampler_and_per_sample_logs(tmp_path):
    """The importance-sampler path: t and its weights from
    RandomState(seed + 17), the losses fed back; equal to the same steps
    made by hand.  log_per_sample writes each row's per-sample losses."""
    from raggesture_tpu_torch.diffusion.samplers import build_sampler
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        create_train_state,
        make_train_step,
    )
    from raggesture_tpu_torch.train.runner import device_batch

    run = _train(tmp_path / "lsm", max_epochs=1,
                 schedule_sampler="loss-second-moment")
    assert len(_rows(tmp_path / "lsm")) == 4
    model = _model()
    state = create_train_state(model, OptimConfig(lr=1e-3, total_steps=16))
    sched = model.cfg.diffusion_train.schedule()
    step = make_train_step(sched, with_timesteps=True, log_per_sample=True)
    sampler = build_sampler("loss-second-moment", sched.num_timesteps)
    t_rng = np.random.RandomState(3 + 17)
    g = torch.Generator().manual_seed(3)
    loader = _loader()
    loader.set_epoch(0)
    for batch in loader:
        db = {k: v for k, v in device_batch(batch, "cpu").items()
              if isinstance(v, torch.Tensor)}
        t, w = sampler.sample_np(t_rng, 4)
        logs = step(state, db, g, t=torch.as_tensor(t).long(),
                    t_weights=torch.as_tensor(w))
        sampler.update_with_losses(t, logs["per_sample_loss"].numpy())
    assert _same_params(run, state)
    _train(tmp_path / "ps", max_epochs=1, log_per_sample=True)
    rows = _rows(tmp_path / "ps")
    assert len(rows) == 4
    for r in rows:
        assert len(r["per_sample_loss"]) == 4 and "t" not in r
        np.testing.assert_allclose(np.mean(r["per_sample_loss"]),
                                   r["recon_loss"], rtol=1e-6)


def test_banked_run_equals_streaming(tmp_path):
    """--cond-bank: a banked run equals the streaming one bitwise, epoch 2
    from the bank (every row a hit)."""
    stats = {}
    stream = _train(tmp_path / "stream")
    banked = _train(tmp_path / "bank", cond_bank=64, stats=stats)
    assert _same_params(stream, banked)
    assert _losses(_rows(tmp_path / "stream")) == \
        _losses(_rows(tmp_path / "bank"))
    assert stats["bank"] == {"hits": 16, "misses": 16, "evicted": 0}


def test_bank_below_a_stack_evicts_exactly_and_keeps_staged_rows():
    """Capacity 5 under 4-sample batches staged ahead of their steps (two
    batches, 8 samples, in flight): staging the second batch evicts 0, 1,
    2 (least recently used, outside the batch), a third batch of 0..3
    then evicts 4, 5, 6 (3 is in it); every staged batch still holds its
    own samples' rows, as streaming ships them, after the later
    evictions."""
    from raggesture_tpu_torch.datasets.beatx import collate
    from raggesture_tpu_torch.train.cond_bank import DeviceSampleBank
    from raggesture_tpu_torch.train.runner import device_batch

    recs = _records(8)
    batches = [collate([recs[i] for i in ids])
               for ids in ([0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 2, 3])]
    bank = DeviceSampleBank(5)
    staged, evicted = [], []
    for b in batches:
        before = set(bank.resident())
        staged.append(bank.stage(b, b["sample_idx"]))
        evicted.append(before - set(bank.resident()))
    assert evicted == [set(), {0, 1, 2}, {4, 5, 6}]
    assert bank.resident() == [7, 0, 1, 2, 3]
    assert (bank.hits, bank.misses, bank.evictions) == (1, 11, 6)
    for b, got in zip(batches, staged):
        want = {k: v for k, v in device_batch(b, "cpu").items()
                if isinstance(v, torch.Tensor)}
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="capacity"):
        DeviceSampleBank(3).stage(batches[0], batches[0]["sample_idx"])


def test_a_failed_stage_maps_no_id_to_an_unwritten_row():
    """A stage that fails while it writes (a field of another width) maps
    none of its ids, and drops the victims whose rows it began to
    overwrite; the next stages gather each sample's own rows."""
    from raggesture_tpu_torch.datasets.beatx import collate
    from raggesture_tpu_torch.train.cond_bank import DeviceSampleBank
    from raggesture_tpu_torch.train.runner import device_batch

    recs = _records(8)
    good = [collate([recs[i] for i in ids])
            for ids in ([0, 1, 2, 3], [4, 5, 6, 7], [0, 5, 6, 7])]
    bad = collate([recs[i] for i in (4, 5, 6, 7)])
    bad["audio"] = bad["audio"][:, :-1]
    bank = DeviceSampleBank(5)
    bank.stage(good[0], good[0]["sample_idx"])
    with pytest.raises(RuntimeError):
        bank.stage(bad, bad["sample_idx"])
    # no id of the failed batch is mapped; 0, 1, 2, the victims whose
    # slots it wrote into, are gone; 3 stays
    assert bank.resident() == [3]
    for b in good[1:]:
        got = bank.stage(b, b["sample_idx"])
        want = device_batch(b, "cpu")
        for k in got:
            assert torch.equal(got[k], want[k]), k
    assert bank.resident() == [4, 0, 5, 6, 7]


def test_bank_below_a_batch_streams_it(tmp_path, caplog):
    """A bank smaller than a batch's unique samples: the runner streams
    every batch (warned once) and the run equals the streaming one."""
    from raggesture_tpu_torch.utils.logger import get_root_logger

    stats = {}
    stream = _train(tmp_path / "stream", max_epochs=1)
    logger = get_root_logger()
    logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING, logger="raggesture"):
            small = _train(tmp_path / "small", max_epochs=1, cond_bank=3,
                           stats=stats)
    finally:
        logger.propagate = False
    assert _same_params(stream, small)
    assert stats["bank"] == {"hits": 0, "misses": 0, "evicted": 0}
    assert caplog.text.count("more unique samples than the capacity") == 1


# -------------------------------------------------------- runtime pieces

def test_metric_writer_rows(tmp_path):
    """Scalars as floats, vectors as lists, the record's keys over a metric
    of the same name; the text log every interval or when forced."""
    from raggesture_tpu_torch.utils.logger import MetricWriter

    w = MetricWriter(str(tmp_path), interval=2, tensorboard=False)
    w.write(1, {"loss": np.float32(0.5), "per_sample_loss": [1, 2.5],
                "step": 99}, epoch=0)
    w.write(2, {"loss": 0.25}, prefix="val")
    w.close()
    rows = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert rows[0]["loss"] == 0.5 and rows[0]["per_sample_loss"] == [1.0, 2.5]
    assert rows[0]["step"] == 1 and rows[0]["epoch"] == 0
    assert rows[1]["prefix"] == "val" and "epoch" not in rows[1]


def test_prefetch_loader_equals_the_loader():
    from raggesture_tpu_torch.datasets.sampler import PrefetchLoader

    loader = _loader(10, batch=3)
    pre = PrefetchLoader(loader, num_workers=3, depth=2)
    pre.set_epoch(4)
    want = list(loader)
    got = list(pre)
    assert len(got) == len(want) == len(pre) == 3
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_prefetch_iter_passes_on_a_workers_error():
    from raggesture_tpu_torch.datasets.sampler import prefetch_iter

    def gen():
        yield 1
        yield 2
        raise KeyError("staging failed")

    got = []
    with pytest.raises(KeyError, match="staging failed"):
        for x in prefetch_iter(gen(), depth=1):
            got.append(x)
    assert got == [1, 2]
    assert list(prefetch_iter(iter(range(5)), depth=3)) == list(range(5))


def test_dataset_wrappers_match_jax():
    from raggesture_tpu.datasets import wrappers as J
    from raggesture_tpu_torch.datasets import wrappers as P

    a, b = list(range(3)), list(range(10, 15))
    for mine, theirs in ((P.ConcatDataset([a, b]), J.ConcatDataset([a, b])),
                         (P.RepeatDataset(b, 3), J.RepeatDataset(b, 3))):
        assert len(mine) == len(theirs)
        assert [mine[i] for i in range(-len(mine), len(mine))] == \
            [theirs[i] for i in range(-len(theirs), len(theirs))]
        with pytest.raises(IndexError):
            mine[len(mine)]
    with pytest.raises(ValueError):
        P.RepeatDataset(a, 0)


@pytest.mark.parametrize("name", CONFIGS)
def test_optim_config_from_matches_jax(name):
    """Field by field, with bf16 on both ways the config turns it on."""
    import dataclasses

    from raggesture_tpu.builders import optim_config_from as jax_fn
    from raggesture_tpu.config import Config as JConfig
    from raggesture_tpu_torch.builders import optim_config_from
    from raggesture_tpu_torch.config import Config

    path = os.path.join(REPO, "configs/raggesture_beatx", name)
    for opts in ([], ["optimizer.bf16=True"], ["fp16.loss_scale=512."]):
        jc, pc = JConfig.fromfile(path), Config.fromfile(path)
        if opts:
            jc.merge_option_strings(opts)
            pc.merge_option_strings(opts)
        want = dataclasses.asdict(jax_fn(jc, 1234))
        got = dataclasses.asdict(optim_config_from(pc, 1234))
        assert got == want, (name, opts)
    assert got["bf16_compute"]


def test_load_codec_params_grafts_and_warns_on_a_missing_file(tmp_path,
                                                              caplog):
    from raggesture_tpu_torch.train.checkpoint import (
        load_codec_params,
        save_params,
    )
    from raggesture_tpu_torch.utils.logger import get_root_logger

    src, dst = _model(seed=5), _model(seed=6)
    save_params(str(tmp_path / "hands.pt"), src.codec.hands_vae)
    upper0 = {k: v.clone() for k, v in dst.codec.upper_vae.state_dict().items()}
    logger = get_root_logger()
    logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING, logger="raggesture"):
            loaded = load_codec_params(dst, {
                "hands_ckpt": str(tmp_path / "hands.pt"),
                "upper_ckpt": str(tmp_path / "missing.msgpack")}, logger)
    finally:
        logger.propagate = False
    assert loaded == ["hands"]
    assert "missing.msgpack not found" in caplog.text
    for k, v in src.codec.hands_vae.state_dict().items():
        assert torch.equal(dst.codec.hands_vae.state_dict()[k], v), k
    for k, v in dst.codec.upper_vae.state_dict().items():
        assert torch.equal(v, upper0[k]), k


# -------------------------------------------------------------- the tool

@pytest.fixture(scope="module")
def jax_row_keys(tmp_path_factory):
    """The keys of the JAX runner's train and val rows, from one JAX
    train_model epoch on the same records."""
    import jax

    from raggesture_tpu.datasets.sampler import DataLoader
    from raggesture_tpu.models.architecture import MotionDiffusionModel
    from raggesture_tpu.train.loop import OptimConfig
    from raggesture_tpu.train.runner import train_model

    _, params = port_model_and_jax_tree(_cfg(), seed=1)
    wd = str(tmp_path_factory.mktemp("jax_run"))
    train_model(MotionDiffusionModel(_cfg()),
                DataLoader(_ListDataset(_records(8)), batch_size=8),
                OptimConfig(total_steps=2),
                params=jax.tree_util.tree_map(jax.numpy.asarray, params),
                max_epochs=1, workdir=wd, log_interval=1, tensorboard=False,
                val_loader=DataLoader(_ListDataset(_records(8)),
                                      batch_size=8, shuffle=False))
    return {r["prefix"]: set(r) for r in _rows(wd) + _rows(wd, "val")}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from test_dataset_build import make_raw_beat2

    ws = str(tmp_path_factory.mktemp("ws"))
    root = os.path.join(ws, "beat2")
    make_raw_beat2(root, [("2_scott_0_1_1", "train"),
                          ("2_scott_0_2_2", "train"),
                          ("2_scott_0_3_3", "test")], n_sec=12)
    opts = [f"data.{s}.{k}={v}" for s in ("train", "val", "test")
            for k, v in (("data_path", root),
                         ("cache_path", os.path.join(ws, "cache")),
                         ("allow_fake_contacts", True))]
    return ws, opts


def test_tool_trains_checkpoints_and_resumes(workspace, jax_row_keys):
    """The tool on tiny_smoke.py with --device cpu: the JAX tool's files
    (config.py, the timestamped log, metrics.jsonl, checkpoints/) and its
    row keys; bf16 from the config; a resume from latest to a third epoch;
    the latent cache with the bank."""
    from raggesture_tpu_torch.tools.train import main

    ws, opts = workspace
    wd = os.path.join(ws, "work")
    cfg = os.path.join(REPO, "configs/raggesture_beatx/tiny_smoke.py")
    base = [cfg, "--work-dir", wd, "--device", "cpu",
            "--device-batch-size", "4"]
    stats = main(base + ["--options", *opts, "optimizer.bf16=True"])
    names = sorted(os.listdir(wd))
    assert names[0].endswith(".log") and names[1:] == ["checkpoints", "config.py", "metrics.jsonl"]
    assert stats["checkpoints"] == ["epoch_0.pt", "epoch_1.pt"]
    assert [e["steps"] for e in stats["epochs"]] == [4, 4]
    rows = _rows(wd) + _rows(wd, "val")
    for r in rows:
        assert set(r) == jax_row_keys[r["prefix"]], r
        assert all(np.isfinite(v) for v in r.values()
                   if isinstance(v, float))
    stats = main(base + ["--resume-from", "--options", *opts,
                         "optimizer.bf16=True", "runner.max_epochs=3"])
    assert stats["final_step"] == 12 and [
        e["epoch"] for e in stats["epochs"]] == [2]
    stats = main([cfg, "--work-dir", os.path.join(ws, "cached"), "--device",
                  "cpu", "--device-batch-size", "4", "--latent-cache",
                  os.path.join(ws, "latents"), "--multi-step", "2",
                  "--cond-bank", "32", "--no-validate", "--options", *opts])
    assert stats["bank"]["misses"] == 16 and stats["bank"]["hits"] == 16
    assert not _rows(os.path.join(ws, "cached"), "val")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present: the default device is the card")
def test_tool_without_a_card_or_device_cpu_exits_nonzero(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "raggesture_tpu_torch.tools.train",
         os.path.join(REPO, "configs/raggesture_beatx/tiny_smoke.py"),
         "--work-dir", str(tmp_path / "w")], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "w")
