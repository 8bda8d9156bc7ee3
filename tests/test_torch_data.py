"""The port's data pipeline against the JAX package's (CPU): synthetic CLEAR
rows, the forget dataset's per-loss pairs, the collators, the loader's order,
micro-batch stacking, the prefetch thread and the native pad-and-mask.
Everything is compared exactly (images and pixel values included): the port
copies the JAX package's arithmetic and its order of random draws."""

import threading
import time

import numpy as np
import pytest

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.config.registry import get_model_identifiers as jget
from multimodal_unlearning_tpu.data import datasets as jds
from multimodal_unlearning_tpu.data import loader as jloader
from multimodal_unlearning_tpu.data.prefetch import PrefetchLoader as JPrefetch
from multimodal_unlearning_tpu.utils import native as jnative
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.config.registry import get_model_identifiers
from multimodal_unlearning_tpu_torch.data import datasets as tds
from multimodal_unlearning_tpu_torch.data import loader as tloader
from multimodal_unlearning_tpu_torch.data.prefetch import PrefetchLoader
from multimodal_unlearning_tpu_torch.utils import native as tnative

DATA = "synthetic:n_persons=10,qa_per_person=4"


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("split", ["full", "forget10+tofu", "retain90+tofu", "real_faces"])
def test_synthetic_splits_equal_jax(split):
    _same(tds.resolve_rows(DATA, split), jds.resolve_rows(DATA, split))


def test_only_synthetic_rows_are_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="datasets"):
        tds.resolve_rows(str(tmp_path), "train")


@pytest.mark.parametrize("idk_fix", [False, True], ids=["quirk", "idk_fix"])
@pytest.mark.parametrize("loss", ["grad_diff_forget_ce_retain_ce", "idk", "dpo", "sku"])
def test_forget_dataset_items_equal_jax(loss, idk_fix):
    kw = dict(forget_data_path=DATA, retain_data_path=DATA, forget_loss=loss,
              retain_split="retain90+tofu", forget_split="forget10+tofu", seed=3,
              idk_fix=idk_fix)
    t, j = tds.MMMixedForgetDataset(**kw), jds.MMMixedForgetDataset(**kw)
    assert len(t) == len(j)
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(t)):
            _same(t[i], j[i], f"epoch {epoch} item {i}")


@pytest.mark.parametrize("cls,kw", [
    ("MMDatasetQA", {}),
    ("ImageCaptioningDataset", {"question_strategy": "random_caption", "seed": 1}),
    ("MMMixedDataset", {"seed": 2}),
])
def test_other_datasets_equal_jax(cls, kw):
    t = getattr(tds, cls)(DATA, "forget10+tofu", **kw)
    j = getattr(jds, cls)(DATA, "forget10+tofu", **kw)
    _same([t[i] for i in range(len(t))], [j[i] for i in range(len(j))])


def _processors(family):
    return (tcommon.build_processor(get_model_identifiers(family)),
            jcommon.build_processor(jget(family), {}))


@pytest.mark.parametrize("family", ["tiny-llava-test", "llava"])
def test_collators_equal_jax(family):
    tp, jp = _processors(family)
    ds_kw = dict(forget_data_path=DATA, retain_data_path=DATA,
                 forget_loss="grad_diff_forget_ce_retain_ce", retain_split="retain90+tofu",
                 forget_split="forget10+tofu", seed=0)
    items = tds.MMMixedForgetDataset(**ds_kw)
    # an image row and a text row (forget10+tofu puts the text rows last)
    samples = [items[0], items[len(items) - 1]]
    got = tp.collate_forget(samples, max_length=2048)
    want = jp.collate_forget(samples, max_length=2048)
    _same(got, want)
    if family == "llava":
        assert got["forget"]["pixel_values"].shape == (2, 336, 336, 3)
        img_id = tp.tokenizer.image_token_id
        assert (got["forget"]["input_ids"][0] == img_id).sum() == 576
    plain = [s["forget"] for s in samples]
    _same(tp.collate(plain, 64, return_indices=False, return_answers=True),
          jp.collate(plain, 64, return_answers=True))


def test_loader_order_stacking_and_prefetch():
    ds = list(range(11))
    collate = lambda xs: {"x": np.asarray(xs), "y": {"z": np.asarray(xs) * 2}}
    t = tloader.DataLoader(ds, 4, collate, shuffle=True, seed=5)
    j = jloader.DataLoader(ds, 4, collate, shuffle=True, seed=5)
    for _ in range(2):  # two epochs: the shuffle is seeded per epoch
        _same(list(t), list(j))
    batch = collate(list(range(8)))
    _same(tloader.stack_microbatches(batch, 2), jloader.stack_microbatches(batch, 2))
    t.epoch = j.epoch = 0
    _same(list(PrefetchLoader(t, depth=2)), list(JPrefetch(j, depth=2)))


def test_prefetch_early_break_releases_its_thread():
    def slow_collate(xs):
        time.sleep(0.01)
        return {"x": np.asarray(xs)}

    before = set(threading.enumerate())
    pf = PrefetchLoader(tloader.DataLoader(list(range(64)), 2, slow_collate), depth=1)
    it = iter(pf)
    next(it)
    (producer,) = set(threading.enumerate()) - before
    it.close()  # what an early `break` does to the generator
    producer.join(timeout=5)
    assert not producer.is_alive()
    assert pf.batches == 1 and pf.collate_seconds > 0


def test_pad_and_mask_native_matches_numpy_and_jax():
    rng = np.random.default_rng(0)
    rows = [rng.integers(3, 200, n).tolist() for n in (0, 5, 17, 40)]
    nq = [0, 2, 30, 7]
    for left in (True, False):
        want = tnative.pad_and_mask_numpy(rows, nq, 32, 0, pad_left=left)
        _same(tnative.pad_and_mask(rows, nq, 32, 0, pad_left=left), want)
        _same(jnative.pad_and_mask(rows, nq, 32, 0, pad_left=left), want)
    assert tnative.available() == jnative.available()
