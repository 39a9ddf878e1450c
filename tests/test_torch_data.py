"""The port's input pipeline against the JAX package's on the same inputs:
the synthetic dataset's files, the native resampler, the datasets' samples
and the loaders' batches, bit for bit; the prefetcher on the CPU."""

import os

import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.data import dataset as jax_dataset
from lanedetection_end2end_tpu.data import loader as jax_loader
from lanedetection_end2end_tpu.data import native as jax_native
from lanedetection_end2end_tpu.data import synthetic as jax_synthetic
from lanedetection_end2end_tpu.data import labels as jax_labels
from lanedetection_end2end_tpu_torch.data import dataset, labels, loader
from lanedetection_end2end_tpu_torch.data import native, synthetic

RESIZE = 32


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("synth_parity")
    port = synthetic.make_synthetic_root(str(base / "port"), num_train=10,
                                         num_test=3, seed=7)
    ref = jax_synthetic.make_synthetic_root(str(base / "jax"), num_train=10,
                                            num_test=3, seed=7)
    return port, ref


def test_synthetic_root_is_byte_identical(roots):
    port, ref = roots
    assert {k: os.path.relpath(v, os.path.dirname(port["image_dir"]))
            for k, v in port.items()} == {
        k: os.path.relpath(v, os.path.dirname(ref["image_dir"]))
        for k, v in ref.items()}
    a = _files(os.path.dirname(port["image_dir"]))
    b = _files(os.path.dirname(ref["image_dir"]))
    assert sorted(a) == sorted(b) and len(a) == 10 + 10 + 4 + 3 + 1
    for name in a:
        assert a[name] == b[name], name


def test_synthetic_lanes_batches_match():
    got = synthetic.SyntheticLanes(2, resize=RESIZE, seed=3).batch()
    want = jax_synthetic.SyntheticLanes(2, resize=RESIZE, seed=3).batch()
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("shape,out", [((640, 1280, 3), (32, 64)),
                                       ((37, 53, 3), (61, 22))])
def test_native_resampler_matches_jax(shape, out, flip):
    rng = np.random.default_rng(sum(shape) + flip)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(
        native.resample_to_f32(img, *out, flip=flip),
        jax_native.resample_to_f32(img, *out, flip=flip))
    np.testing.assert_array_equal(
        native.u8_to_unit_f32(img, flip=flip),
        jax_native.u8_to_unit_f32(img, flip=flip))
    mask = rng.integers(0, 5, shape[:2], dtype=np.uint8)
    np.testing.assert_array_equal(
        native.resize_nearest_u8(mask, *out, flip=flip),
        jax_native.resize_nearest_u8(mask, *out, flip=flip))


def test_native_library_builds_under_the_package_build_dir():
    native.resample_to_f32(np.zeros((4, 4, 3), np.uint8), 2, 2)
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "_build" and path.parent != native.SRC.parent


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed g++ raises: there is no second resampler to fall back
    to."""
    bad = tmp_path / "laneops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.resample_to_f32(np.zeros((4, 4, 3), np.uint8), 2, 2)


def _datasets(roots, image_dtype, valid_idx=(1, 4)):
    port, ref = roots
    kw = dict(valid_idx=list(valid_idx), resize=RESIZE, nclasses=4,
              flip_on=True, image_dtype=image_dtype)
    a = dataset.LaneDataset("bp", port["image_dir"], port["gt_dir"],
                            lanes_file=port["lanes_file"],
                            line_file=port["line_file"], **kw)
    b = jax_dataset.LaneDataset("bp", ref["image_dir"], ref["gt_dir"],
                                lanes_file=ref["lanes_file"],
                                line_file=ref["line_file"], **kw)
    return a, b


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("image_dtype", ["uint8", "float32"])
def test_dataset_items_are_bit_equal(roots, image_dtype):
    a, b = _datasets(roots, image_dtype)
    for i in range(len(a)):
        for flip in (False, True):
            _same(a.__getitem__(i, flip=flip), b.__getitem__(i, flip=flip))


def test_test_set_items_are_bit_equal(roots):
    port, ref = roots
    a = dataset.LaneTestSet(os.path.join(port["test_dir"], "test_label.json"),
                            port["test_dir"], RESIZE)
    b = jax_dataset.LaneTestSet(os.path.join(ref["test_dir"],
                                             "test_label.json"),
                                ref["test_dir"], RESIZE)
    assert len(a) == len(b) == 3
    for i in range(len(a)):
        _same(a[i], b[i])


def test_split_indices_match_jax():
    for n, p in ((10, 0.2), (37, 0.1), (3626, 0.2)):
        assert loader.split_indices(n, p) == jax_loader.split_indices(n, p)


@pytest.mark.parametrize("epoch", [0, 3])
def test_loader_batches_are_bit_equal(roots, epoch):
    a, b = _datasets(roots, "uint8", valid_idx=(0, 5))
    idx = [1, 2, 3, 4, 6, 7, 8, 9]
    la = loader.Loader(a, idx, 4, shuffle=True, flip=True, nworkers=2,
                       seed=5)
    lb = jax_loader.Loader(b, idx, 4, shuffle=True, flip=True, nworkers=2,
                           seed=5, process_index=0, process_count=1)
    la.set_epoch(epoch)
    lb.set_epoch(epoch)
    got, want = list(la), list(lb)
    assert len(got) == len(want) == len(la) == 2
    for x, y in zip(got, want):
        _same(x, y)
    # some image of the epoch is flipped, so the comparison covers it
    assert any(bool(x["flip"].any()) for x in got)


def test_get_loader_and_testloader_match_jax(roots):
    a_ds, b_ds = _datasets(roots, "float32", valid_idx=())
    port, ref = roots
    la, va, vidx = loader.get_loader(lambda v: a_ds, 10, 4, 2, nworkers=1,
                                     flip_on=True, seed=2)
    lb, vb, widx = jax_loader.get_loader(lambda v: b_ds, 10, 4, 2,
                                         nworkers=1, flip_on=True, seed=2)
    assert vidx == widx and la.indices == lb.indices
    assert va.indices == vb.indices
    ta = loader.get_testloader(dataset.LaneTestSet(
        os.path.join(port["test_dir"], "test_label.json"), port["test_dir"],
        RESIZE), 2, nworkers=1)
    assert ta.num_real == 3 and len(ta) == 2 and ta.indices[-1] == 2
    for x, y in zip(la, lb):
        _same(x, y)


def test_prefetcher_passes_batches_through_on_the_cpu(roots):
    a, _ = _datasets(roots, "uint8")
    la = loader.Loader(a, range(8), 4, shuffle=True, flip=True, nworkers=1,
                       seed=1)
    host = list(la)
    got = list(loader.DevicePrefetcher(la, torch.device("cpu"), depth=2))
    assert len(got) == len(host) == 2
    for t, h in zip(got, host):
        assert sorted(t) == sorted(h)
        for k in h:
            assert isinstance(t[k], torch.Tensor) and t[k].device.type == "cpu"
            np.testing.assert_array_equal(t[k].numpy(), h[k])


def test_labels_match_jax(roots, tmp_path):
    port, _ = roots
    assert labels.mirror_list(list(range(10))) == jax_labels.mirror_list(
        list(range(10)))
    assert labels.image_indices(port["image_dir"]) == \
        jax_labels.image_indices(port["image_dir"])
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    labels.load_valid_set_file_all([2, 0, 5], a, port["image_dir"],
                                   port["labels_all_file"])
    jax_labels.load_valid_set_file_all([2, 0, 5], b, port["image_dir"],
                                       port["labels_all_file"])
    assert open(a).read() == open(b).read()
    assert labels.read_json_lines(a) == jax_labels.read_json_lines(b)
