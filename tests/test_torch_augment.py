"""The augmentations, the random draws behind them, the threaded loader and the
staged store of the port against the JAX package, on the CPU.

Bounds:
- the host augmentations (numpy and PIL in both packages): bit for bit;
- threefry ``randint``: bit for bit; ``normal``: within 4 float32 ulps (the
  uniform draw is bit for bit; XLA's log1p inside erf_inv differs from
  torch's by up to 2 ulps, which leaves up to 3 in the result here);
- the device augmentations at the same key: 99.9% of the elements within
  1e-6 and every element within 1/24 (the normal draws above, and float32
  sums and powers taken in another order; where a value sits at a step of the
  JPEG stand-in's quantization, at 24 to 200 levels, it rounds to the
  neighbouring level, which the blur then spreads);
- augment_stats: 1e-6 relative;
- PrefetchLoader against the sequential epoch, and against the JAX loader,
  and DeviceStore's staging and its sampled rows: bit for bit.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geocalib_tpu.data import augmentations as jaug, device_augment as jdev
from geocalib_tpu.data.dataset import (DatasetConf as JConf, PrefetchLoader as JLoader,
                                       SimpleDataset as JDataset)
from geocalib_tpu.training import device_store as jstore
from geocalib_tpu.utils.image import write_image
from geocalib_tpu_torch.data import augmentations as taug, device_augment as tdev
from geocalib_tpu_torch.data.dataset import DatasetConf, PrefetchLoader, SimpleDataset
from geocalib_tpu_torch.training import device_store as tstore
from geocalib_tpu_torch.utils import threefry

ULPS = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed):
    key = jax.random.PRNGKey(seed)
    return key, tuple(int(x) for x in np.asarray(key))


# ------------------------------------------------------------------ host zoo

@pytest.mark.parametrize("name", ["identity", "default", "geocalib", "dark"])
def test_host_augmentations_match_jax_bit_for_bit(name):
    img = np.random.default_rng(3).uniform(size=(48, 64, 3)).astype(np.float32)
    for seed in (0, 1, 7, 123):
        ref = jaug.get_augmentation(name, seed)(img.copy())
        out = taug.get_augmentation(name, seed)(img.copy())
        assert out.dtype == ref.dtype and np.array_equal(out, ref), (name, seed)
    with pytest.raises(ValueError):
        taug.get_augmentation("sepia")


# ------------------------------------------------------------------ threefry

@pytest.mark.parametrize("lo,hi", [(0, 5), (0, 20), (0, 1000), (0, 12345), (-7, 300), (3, 3)])
def test_randint_matches_jax(lo, hi):
    for seed in (0, 5):
        key, tk = _key(seed)
        for shape in ((37,), (4, 6)):
            ref = np.asarray(jax.random.randint(key, shape, lo, hi))
            assert np.array_equal(threefry.randint(tk, shape, lo, hi).numpy(), ref)


@pytest.mark.parametrize("shape", [(24, 1, 1, 1), (2, 64, 64, 3), (1, 1, 1, 3)])
def test_normal_and_uniform_range_match_jax(shape):
    for seed in range(4):
        key, tk = _key(seed)
        ref = np.asarray(jax.random.uniform(key, shape, minval=0.8, maxval=1.8))
        assert np.array_equal(threefry.uniform_range(tk, shape, 0.8, 1.8).numpy(), ref)
        ref = np.asarray(jax.random.normal(key, shape))
        out = threefry.normal(tk, shape).numpy()
        ulps = np.abs(out.view(np.int32).astype(np.int64) - ref.view(np.int32))
        assert ulps.max() <= ULPS, ulps.max()


# ------------------------------------------------------------------ device augmentations

@pytest.mark.parametrize("name", ["geocalib", "dark", "deepcalib", "identity"])
def test_device_augmentations_match_jax(name):
    img = np.random.default_rng(0).uniform(size=(6, 64, 48, 3)).astype(np.float32)
    fn = jax.jit(jdev.DEVICE_AUGMENTATIONS[name])
    for seed in (0, 1, 2):
        key, tk = _key(seed)
        ref = np.asarray(fn(jnp.asarray(img), key))
        out = tdev.DEVICE_AUGMENTATIONS[name](torch.from_numpy(img), tk).numpy()
        d = np.abs(out - ref)
        assert (d <= 1e-6).mean() >= 0.999 and d.max() <= 1 / 24, (seed, d.max())


def test_augment_stats_match_jax():
    img = np.random.default_rng(1).uniform(size=(4, 32, 32, 3)).astype(np.float32)
    key, tk = _key(9)
    ref = [float(v) for v in jax.jit(jdev.augment_stats)(jnp.asarray(img), key)]
    out = [float(v) for v in tdev.augment_stats(torch.from_numpy(img), tk)]
    np.testing.assert_allclose(out, ref, rtol=1e-6)


# ------------------------------------------------------------------ loader and store

@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("augment_ds")
    (root / "images").mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(10):
        write_image(rng.uniform(0, 1, (32, 32, 3)).astype(np.float32), root / "images" / f"im{i}.png")
        rows.append({"fname": f"im{i}.png", "height": 32, "width": 32, "vfov": 1.0 + 0.01 * i,
                     "roll": 0.1 * i, "pitch": -0.05 * i})
    with open(root / "train.csv", "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return root


def _datasets(root, augmentation="geocalib", batch_size=3):
    kw = dict(dataset_dir=str(root), csv_name="train.csv", batch_size=batch_size,
              augmentation=augmentation, seed=1)
    return SimpleDataset(DatasetConf(**kw)), JDataset(JConf(**kw))


def test_prefetch_matches_sequential_and_jax(dataset_dir):
    ds, jds = _datasets(dataset_dir)
    seq = list(ds.epoch(epoch=2))
    pre = list(PrefetchLoader(ds, num_workers=4, prefetch=2).epoch(epoch=2))
    ref = list(JLoader(jds, num_workers=4, prefetch=2).epoch(epoch=2))
    assert len(seq) == len(pre) == len(ref) == 3
    for a, b, r in zip(seq, pre, ref):
        for k in ("image", "gt_params"):
            assert torch.equal(a[k], b[k]) and np.array_equal(b[k].numpy(), r[k])


def test_prefetch_early_break_does_not_hang(dataset_dir):
    ds, _ = _datasets(dataset_dir)
    loader = PrefetchLoader(ds, num_workers=2, prefetch=1)
    it = loader.epoch(epoch=0)
    next(it)
    it.close()  # must shut the producer down cleanly
    assert loader.stall_s >= 0.0


def test_prefetch_sharding(dataset_dir):
    ds, _ = _datasets(dataset_dir, augmentation="identity")
    full = list(PrefetchLoader(ds).epoch(epoch=0, shard=0, num_shards=1))
    s0 = list(PrefetchLoader(ds).epoch(epoch=0, shard=0, num_shards=2))
    s1 = list(PrefetchLoader(ds).epoch(epoch=0, shard=1, num_shards=2))
    assert sum(b["image"].shape[0] for b in full) == 9  # 10 rows, batch 3, tail dropped
    assert sum(b["image"].shape[0] for b in s0 + s1) == 6  # 5 rows per shard: one batch each
    for part, shard in ((s0, 0), (s1, 1)):
        seq = list(ds.epoch(epoch=0, shard=shard, num_shards=2))
        assert all(torch.equal(a["image"], b["image"]) for a, b in zip(seq, part))


def test_prefetch_raises_a_worker_failure(dataset_dir):
    ds, _ = _datasets(dataset_dir, augmentation="identity")
    ds.rows = ds.rows + [dict(ds.rows[0], fname="missing.png")] * 5
    with pytest.raises(FileNotFoundError):
        list(PrefetchLoader(ds, num_workers=2).epoch(epoch=0))


def test_device_store_stages_and_samples_as_jax(dataset_dir):
    ds, jds = _datasets(dataset_dir, augmentation="identity")
    store = tstore.DeviceStore.stage(ds, device="cpu", chunk_images=4, progress=None)
    jst = jstore.DeviceStore.stage(jds, chunk_images=4, progress=None)
    assert store.images.dtype == torch.uint8
    assert np.array_equal(store.images.numpy(), np.asarray(jst.images))
    assert np.array_equal(store.gt_params.numpy(), np.asarray(jst.gt_params))
    for seed in (0, 3):
        key, tk = _key(seed)
        ref = jstore.sample_batch(jst.images, jst.gt_params, key, 5, augment=False)
        out = tstore.sample_batch(store.images, store.gt_params, tk, 5, augment=False)
        for k in ("image", "gt_params"):
            assert np.array_equal(out[k].numpy(), np.asarray(ref[k])), k
        ref = jstore.sample_batch(jst.images, jst.gt_params, key, 5, augment="geocalib")
        out = tstore.sample_batch(store.images, store.gt_params, tk, 5, augment="geocalib")
        d = np.abs(out["image"].numpy() - np.asarray(ref["image"]))
        assert (d <= 1e-6).mean() >= 0.999 and d.max() <= 1 / 24
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tstore.DeviceStore.stage_sharded(ds, num_shards=2)
