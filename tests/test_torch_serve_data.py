"""The serving tool's host side, the port against the JAX package on the
CPU: the config loader, the builders, the BEAT2 window cache and its
reader, the data loader's batch order, ``motion_io`` and the parameter
file.  Everything here is host numpy (the rotation conversions of
``motion_io`` run the port's torch code on the CPU).

Tolerances: the cache's arrays are written by the same numpy code from the
same files, so they agree exactly (checked at 1e-6 for floats, exactly for
ints and strings); ``motion_io``'s rotation round trips run in float32 in
both frameworks, within 1e-5 (observed ≤ 1.5e-6).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_dataset_build import make_raw_beat2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join(REPO, "configs/raggesture_beatx", name) for name in (
    "basegesture_len150_beat.py", "basegesture_len150_beat_spk2.py",
    "tiny_smoke.py")]
OPTIONS = ["data.train.stride=15", "data.test.training_speakers=[2,4]",
           "model.model.retrieval_cfg.stratification_interval=1",
           "optimizer.lr=2e-4", "data.train.allow_fake_contacts=true",
           "custom_hooks=[{'type': 'DatabaseSaveHook', 'save_dir': 'm'}]",
           "model.model.sa_block_cfg.num_heads=8", "newkey.sub=a,b"]
CLIPS = [("2_scott_0_1_1", "train"), ("2_scott_0_2_2", "train"),
         ("2_scott_0_3_3", "test"), ("4_lawrence_0_1_1", "additional")]


def _configs(path):
    from raggesture_tpu.config import Config as JaxConfig
    from raggesture_tpu_torch.config import Config

    jcfg, cfg = JaxConfig.fromfile(path), Config.fromfile(path)
    jcfg.merge_option_strings(OPTIONS)
    cfg.merge_option_strings(OPTIONS)
    return jcfg, cfg


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_loads_to_the_jax_packages_dict(path):
    jcfg, cfg = _configs(path)
    assert cfg.to_dict() == jcfg.to_dict()
    assert cfg.model.model.sa_block_cfg.num_heads == 8
    assert cfg.newkey.sub == ["a", "b"]


def test_option_values_parse_as_in_the_jax_package():
    from raggesture_tpu.config import parse_option_value as jax_parse
    from raggesture_tpu_torch.config import parse_option_value

    for raw in ("1", "1.5e-3", "true", "No", "none", "[64,128],[1,2]",
                "(1, 2)", "{'a': [1, 2]}", "abc", "a,b,,c", "'x,y'"):
        assert parse_option_value(raw) == jax_parse(raw), raw


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_builders_give_the_jax_packages_dataclasses(path):
    from raggesture_tpu import builders as JB
    from raggesture_tpu_torch import builders as B

    jcfg, cfg = _configs(path)
    assert (dataclasses.asdict(B.arch_config_from(cfg.model))
            == dataclasses.asdict(JB.arch_config_from(jcfg.model)))
    for split in ("train", "val", "test"):
        assert (dataclasses.asdict(B.beatx_config_from(cfg.data[split]))
                == dataclasses.asdict(JB.beatx_config_from(jcfg.data[split])))
    assert (dataclasses.asdict(B.retrieval_config_from(cfg.model.model))
            == dataclasses.asdict(JB.retrieval_config_from(jcfg.model.model)))


def test_build_architecture_builds_the_configs_model():
    from raggesture_tpu_torch.builders import (
        arch_config_from,
        build_architecture,
    )

    _, cfg = _configs(CONFIGS[2])
    model = build_architecture(cfg.model, device="cpu")
    assert model.cfg == arch_config_from(cfg.model)
    assert next(model.parameters()).device.type == "cpu"
    assert not model.training
    with pytest.raises(KeyError, match="architecture type"):
        build_architecture(dict(cfg.model, type="Other"), device="cpu")


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The same raw directory cached by each package (train and test)."""
    from raggesture_tpu.datasets.beatx import BeatXConfig as JaxCfg
    from raggesture_tpu.datasets.build import build_dataset as jax_build
    from raggesture_tpu_torch.datasets.beatx import BeatXConfig
    from raggesture_tpu_torch.datasets.build import build_dataset

    tmp = str(tmp_path_factory.mktemp("serve_data"))
    root = os.path.join(tmp, "beat2")
    make_raw_beat2(root, CLIPS, n_sec=12)
    out = {}
    for split in ("train", "test"):
        kw = dict(data_root=root, split=split, pose_length=30, stride=15,
                  allow_fake_contacts=True)
        out[split] = (
            build_dataset(BeatXConfig(cache_dir=os.path.join(tmp, "port"),
                                      **kw)),
            jax_build(JaxCfg(cache_dir=os.path.join(tmp, "jax"), **kw)))
    return out


def _assert_records_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) and x.dtype.kind == "f":
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6, err_msg=k)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


@pytest.mark.parametrize("split", ["train", "test"])
def test_cache_records_equal_the_jax_packages(caches, split):
    port, jax_ds = caches[split]
    assert port.names == jax_ds.names and len(port) > 1
    for f in ("name_to_idx.json", "COMPLETE"):
        with open(os.path.join(port.cache.path, f)) as a, \
                open(os.path.join(jax_ds.cache.path, f)) as b:
            assert json.load(a) == json.load(b), f
    for i in range(len(port)):
        _assert_records_equal(port[i], jax_ds[i])
    rec = port[port.names[-1]]
    assert rec["motion"].shape[1] == 165 and rec["contact"].shape[1] == 4


def test_each_package_reads_the_others_cache(caches):
    from raggesture_tpu.datasets.beatx import BeatXDataset as JaxDataset
    from raggesture_tpu.datasets.beatx import ShardCache as JaxCache
    from raggesture_tpu_torch.datasets.beatx import BeatXDataset, ShardCache

    port, jax_ds = caches["train"]
    port_reads_jax = BeatXDataset(ShardCache(jax_ds.cache.path))
    jax_reads_port = JaxDataset(JaxCache(port.cache.path))
    assert port_reads_jax.cache.is_complete and jax_reads_port.cache.is_complete
    for i in range(len(port)):
        _assert_records_equal(port_reads_jax[i], jax_ds[i])
        _assert_records_equal(jax_reads_port[i], port[i])


@pytest.mark.parametrize("batch, shuffle, drop_last, seed", [
    (3, True, False, 0), (4, True, True, 7), (5, False, False, 1)])
def test_loader_gives_the_jax_packages_batches(caches, batch, shuffle,
                                               drop_last, seed):
    from raggesture_tpu.datasets.sampler import DataLoader as JaxLoader
    from raggesture_tpu.datasets.sampler import (
        build_dataloader as jax_build_loader,
    )
    from raggesture_tpu_torch.datasets.sampler import (
        DataLoader,
        build_dataloader,
    )

    ds = caches["train"][0]
    for epoch in (0, 1):
        ours = DataLoader(ds, batch, shuffle=shuffle, drop_last=drop_last,
                          seed=seed)
        theirs = JaxLoader(ds, batch, shuffle=shuffle, drop_last=drop_last,
                           seed=seed)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours) == len(theirs)
        for g, w in zip(got, want):
            assert g["sample_name"] == w["sample_name"]
            np.testing.assert_array_equal(g["valid_mask"], w["valid_mask"])
            np.testing.assert_array_equal(g["speaker_ids"], w["speaker_ids"])
    for shard in (0, 1):
        kw = dict(samples_per_device=2, num_devices=1, num_shards=2,
                  shard=shard, seed=seed, shuffle=shuffle)
        assert ([b["sample_name"] for b in build_dataloader(ds, **kw)]
                == [b["sample_name"] for b in jax_build_loader(ds, **kw)])


def test_device_batch_moves_the_model_fields_and_keeps_ragged_lists(caches):
    from raggesture_tpu_torch.datasets.beatx import collate
    from raggesture_tpu_torch.train.runner import (
        DEVICE_BATCH_KEYS,
        device_batch,
    )

    ds = caches["test"][0]
    batch = collate([ds[0], ds[1]])
    got = device_batch(batch, "cpu")
    for k in DEVICE_BATCH_KEYS:
        if k in batch:
            assert isinstance(got[k], torch.Tensor), k
            np.testing.assert_array_equal(got[k].numpy(), batch[k], k)
    assert got["speaker_ids"].dtype == torch.int64
    assert got["word"].dtype == torch.float32
    assert got["sample_name"] == batch["sample_name"]
    assert got["discourse"] == batch["discourse"]
    assert "beta" not in got and "emo" not in got


def test_motion_io_matches_the_jax_packages(tmp_path):
    from raggesture_tpu.utils import motion_io as J
    from raggesture_tpu_torch.utils import motion_io as M

    rng = np.random.RandomState(0)
    pose = (rng.randn(15, 165) * 0.8).astype(np.float32)
    pose[0, :6] = 0.0                       # the angle-0 branch
    x = rng.randn(15, 100).astype(np.float32)
    for factor in (1, 2, 3):
        np.testing.assert_allclose(M.linear_resample(x, factor),
                                   J.linear_resample(x, factor), atol=1e-6)
        np.testing.assert_allclose(M.upsample_pose_aa(pose, factor),
                                   J.upsample_pose_aa(pose, factor),
                                   atol=1e-5)
    a, b = pose[:6], (rng.randn(6, 165) * 0.8).astype(np.float32)
    np.testing.assert_allclose(M.crossfade_pose_aa(a, b),
                               J.crossfade_pose_aa(a, b), atol=1e-5)
    np.testing.assert_allclose(M.crossfade_linear(x[:6], x[6:12]),
                               J.crossfade_linear(x[:6], x[6:12]), atol=1e-6)
    with pytest.raises(ValueError):
        M.crossfade_pose_aa(a, b[:5])
    dims = {"pred_upper": 39, "pred_hands": 90, "pred_lower": 27,
            "pred_facepose": 3}
    pred = {k: rng.randn(2, 15, d).astype(np.float32)
            for k, d in dims.items()}
    np.testing.assert_array_equal(M.reassemble_full_pose(pred),
                                  J.reassemble_full_pose(pred))
    one = {k: v[1] for k, v in pred.items()}
    np.testing.assert_array_equal(M.reassemble_full_pose(one),
                                  J.reassemble_full_pose(one))
    betas = rng.randn(16)
    for mod, name in ((M, "port.npz"), (J, "jax.npz")):
        mod.save_smplx_npz(str(tmp_path / name), pose, x, x[:, :3],
                           betas=betas, fps=30)
    got, want = (M.load_smplx_npz(str(tmp_path / "jax.npz")),
                 J.load_smplx_npz(str(tmp_path / "port.npz")))
    assert sorted(got) == sorted(want)
    assert got["betas"].shape == (300,)
    for k in ("betas", "poses", "expressions", "trans"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6)
    for k in ("model", "gender", "mocap_frame_rate"):
        assert got[k] == want[k]


def _tiny_model(seed):
    from raggesture_tpu.datasets.fixtures import tiny_arch_config
    from raggesture_tpu_torch.models.architecture import create_model

    from test_torch_common import port_arch_config

    return create_model(port_arch_config(tiny_arch_config()), device="cpu",
                        seed=seed, zero_init_std=0.05)


def test_params_file_round_trips_bitwise(tmp_path):
    from raggesture_tpu_torch.train.checkpoint import load_params, save_params

    src, dst = _tiny_model(1), _tiny_model(2)
    path = str(tmp_path / "params.pt")
    save_params(path, src, {"epoch": 3})
    assert load_params(path, dst) == {"epoch": 3}
    want = src.state_dict()
    for k, v in dst.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_params_file_refuses_a_tree_that_does_not_fit(tmp_path, fault):
    from raggesture_tpu_torch.train.checkpoint import load_params, save_params

    src, dst = _tiny_model(1), _tiny_model(2)
    path = str(tmp_path / "params.pt")
    save_params(path, src)
    state = torch.load(path, weights_only=True)
    key = sorted(state)[0]
    if fault == "missing":
        del state[key]
    elif fault == "extra":
        state["denoiser.extra.weight"] = torch.zeros(2)
    else:
        state[key] = torch.zeros(tuple(state[key].shape) + (2,))
    torch.save(state, path)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        load_params(path, dst)
    for k, v in dst.state_dict().items():       # nothing was copied
        assert torch.equal(v, before[k]), k


def test_jax_params_reach_the_params_file(tmp_path):
    """The README's recipe: a JAX numpy tree through load_jax_params into a
    port model, then save_params; the tool loads that file."""
    from raggesture_tpu_torch.train.checkpoint import load_params, save_params
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    from test_torch_common import jax_tree_from_port

    src = _tiny_model(4)
    tree = jax_tree_from_port(src)          # the JAX tree of these weights
    carrier = _tiny_model(5)
    load_jax_params(carrier, tree)
    path = str(tmp_path / "from_jax.pt")
    save_params(path, carrier, {"from": "jax"})
    dst = _tiny_model(6)
    load_params(path, dst)
    for k, v in dst.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
