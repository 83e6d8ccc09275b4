"""Port parity: the data layer (``data/idxbin.py``, ``data/dataset.py``,
``data/prefetch.py``) against the JAX package's, with no model.

Files: both packages' ``write_torch_idx`` write the same bytes for the
same elements (uniform uint8, non-uniform f32, object fields holding the
label dicts that ``pack_sample_data`` writes), and each package reads the
other's files, also in the legacy v0 vintage, with a nonzero first data
offset, preloaded and preloaded into shared memory. Objects go through the
port's own msgpack codec, held byte for byte against ``msgpack.packb(obj,
use_bin_type=True)``. Dataset discovery, items, ``ShardSampler`` indices
and lengths (over a grid of n, rank, world, workers, shuffle, seed, epoch
and drop), ``subsample_indices`` and ``collate`` are equal exactly.
Everything is made from seeds; nothing reads reference data.
"""

import itertools
import json
import threading
import time

import msgpack
import numpy as np
import pytest

import chip_smoke
from absolutetrack_tpu.data import dataset as jds
from absolutetrack_tpu.data import idxbin as jidx
from absolutetrack_tpu.data import prefetch as jprefetch
from absolutetrack_tpu_torch import data as port_data
from absolutetrack_tpu_torch.data import dataset as ds
from absolutetrack_tpu_torch.data import idxbin
from absolutetrack_tpu_torch.data.prefetch import PrefetchIterator
from absolutetrack_tpu_torch.utils import flax_msgpack

WRITERS = {"jax": jidx.write_torch_idx, "port": idxbin.write_torch_idx}
READERS = {"jax": jidx.TorchIdx, "port": idxbin.TorchIdx}


def label_dicts(n: int = 3, window: int = 2) -> list:
    """Label dicts of ``pack_sample_data``'s schema from the hermetic scene:
    nested float lists, a hand model with None fields and int lists, the
    generic hand model, and a one-element hand list."""
    scene = chip_smoke.build_scene(4, n * window, mesh=True)
    hand_model = {k: np.asarray(v).tolist() for k, v in scene["hand_model"].items()}
    hand_model.update(hand_scale=None)
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        sl = slice(i * window, (i + 1) * window)
        out.append({
            "extrinsics": rng.standard_normal((window, 2, 4, 4)).astype(np.float32).tolist(),
            "intrinsics": rng.standard_normal((window, 2, 3, 3)).astype(np.float32).tolist(),
            "enclosing_points": (300 * rng.standard_normal((window, 21, 3))).astype(np.float32).tolist(),
            "hand": [float(i % 2)],
            "hand_model": hand_model,
            "wrist": scene["wrist_transforms"][sl, i % 2].tolist(),
            "joint_angles": scene["joint_angles"][sl, i % 2].tolist(),
            "solved_wrist_xfs": scene["wrist_transforms"][sl, i % 2].tolist(),
            "solved_joint_angles": scene["joint_angles"][sl, i % 2].tolist(),
            "generic_hand_model": json.loads(json.dumps(hand_model)),
            "pinch": [0.0] * window,
        })
    return out


def _elements(kind: str) -> list:
    rng = np.random.default_rng({"uint8": 1, "float32_ragged": 2, "objects": 3}[kind])
    if kind == "uint8":
        return [rng.integers(0, 256, (2, 2, 5, 7), dtype=np.uint8) for _ in range(4)]
    if kind == "float32_ragged":
        return [rng.standard_normal((n, 3)).astype(np.float32) for n in (3, 1, 6, 2)]
    return label_dicts()


def _bytes(idx_path) -> tuple:
    return idx_path.read_bytes(), idx_path.with_suffix(".bin").read_bytes()


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        if isinstance(want[i], np.ndarray):
            assert got[i].dtype == want[i].dtype
            np.testing.assert_array_equal(got[i], want[i])
        else:
            assert got[i] == want[i]


@pytest.mark.parametrize("kind", ["uint8", "float32_ragged", "objects"])
def test_files_byte_equal_and_cross_read(kind, tmp_path):
    elems = _elements(kind)
    paths = {name: tmp_path / name / "field.torch.idx" for name in WRITERS}
    for name, write in WRITERS.items():
        write(str(paths[name]), elems)
    assert _bytes(paths["port"]) == _bytes(paths["jax"])
    for writer, reader in itertools.product(WRITERS, READERS):
        r = READERS[reader](str(paths[writer]))
        want = jidx.TorchIdx(str(paths["jax"]))
        assert r.is_object == (kind == "objects") and r.is_uniform == (kind == "uint8")
        assert r.dtype == want.dtype and r.shape == want.shape
        assert [r.element_shape(i) for i in range(len(r))] == [want.element_shape(i) for i in range(len(want))]
        _assert_items_equal(r, elems)
        if kind == "uint8":
            np.testing.assert_array_equal(r.as_array(), np.stack(elems))
        else:
            with pytest.raises(ValueError, match="uniform"):
                r.as_array()


def test_codec_bytes_equal_msgpack_on_label_dicts():
    """The object blobs: the port's codec writes ``msgpack.packb(obj,
    use_bin_type=True)``'s bytes, and each side decodes the other's."""
    objs = label_dicts() + [
        {"a": 1, "b": [1.5, 2.5], "c": "hi", "n": None, "t": True, "neg": [-1, -33, -200, -70000]},
        {"big": [255, 256, 65536, 2**32, 2**40], "ragged": [[1.0], [2.0, 3.0]], "s": "x" * 40},
        list(range(20)), {str(i): float(i) for i in range(20)},
    ]
    for obj in objs:
        blob = msgpack.packb(obj, use_bin_type=True)
        assert flax_msgpack.packb(obj) == blob
        assert flax_msgpack.unpackb(blob) == msgpack.unpackb(blob, raw=False) == obj


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_v0_vintage_and_bad_headers(writer, tmp_path):
    """Version 0 with magic 0 reads like version 1; a wrong magic or an
    unknown version is refused by both readers."""
    elems = _elements("float32_ragged")
    p = str(tmp_path / "field.torch.idx")
    WRITERS[writer](p, elems)
    h = np.fromfile(p, np.int64)
    h[0], h[1] = 0, 0
    h.tofile(p)
    for reader in READERS.values():
        _assert_items_equal(reader(p), elems)
    for magic, version in ((12345, 1), (7, 0), (0, 2)):
        h[0], h[1] = magic, version
        h.tofile(p)
        for reader in READERS.values():
            with pytest.raises(ValueError):
                reader(p)


def test_uniform_nonzero_first_offset(tmp_path):
    """A uniform file whose .bin starts with a prefix (stored offsets
    shifted) keeps its zero-copy view in both readers."""
    elems = [np.full((2, 2), i, np.float32) for i in range(3)]
    p = str(tmp_path / "field.torch.idx")
    idxbin.write_torch_idx(p, elems)
    h = np.fromfile(p, np.int64)
    n = int(h[4])
    h[6 + n + 1 : 6 + 2 * n + 2] += 4  # 4 floats
    h.tofile(p)
    binp = p[:-4] + ".bin"
    payload = open(binp, "rb").read()
    with open(binp, "wb") as f:
        f.write(b"\xff" * 16 + payload)
    for reader in READERS.values():
        r = reader(p)
        assert r.is_uniform and r.shape == (3, 2, 2)
        _assert_items_equal(r, elems)
        np.testing.assert_array_equal(r.as_array(), np.stack(elems))


@pytest.mark.parametrize("shared", [False, True])
def test_preload(shared, tmp_path):
    """``preload`` (into RAM, or into POSIX shared memory with ``close``)
    serves the same items and array as the memory map and as JAX's."""
    for kind in ("uint8", "objects"):
        elems = _elements(kind)
        p = str(tmp_path / f"{kind}.torch.idx")
        jidx.write_torch_idx(p, elems)
        pre = idxbin.TorchIdx(p).preload(shared=shared)
        try:
            _assert_items_equal(pre, elems)
            if kind == "uint8":
                np.testing.assert_array_equal(pre.as_array(), jidx.TorchIdx(p).preload().as_array())
            if shared:
                assert pre._shm is not None
        finally:
            pre.close()
        assert pre._shm is None
        pre.close()  # a second close is a no-op


def _folder(root, name, n, write):
    d = root / name / "testing"
    d.mkdir(parents=True)
    write(str(d / "mono.torch.idx"), [np.full((2, 4, 4), i, np.uint8) for i in range(n)])
    write(str(d / "labels.torch.idx"), [{"i": i, "name": name} for i in range(n)])


@pytest.mark.parametrize("preload", [False, True])
def test_discovery_and_dataset(preload, tmp_path):
    """Folders found in the same order; the same items at every index
    (negative ones too) across three folders, one of them only partly
    packed (found by neither)."""
    _folder(tmp_path, "rec_b", 2, jidx.write_torch_idx)
    _folder(tmp_path, "rec_a", 3, idxbin.write_torch_idx)
    _folder(tmp_path / "deeper", "rec_c", 1, jidx.write_torch_idx)
    (tmp_path / "rec_d" / "testing").mkdir(parents=True)
    idxbin.write_torch_idx(str(tmp_path / "rec_d" / "testing" / "mono.torch.idx"), [np.zeros(2, np.uint8)])
    fields = ["mono", "labels"]
    folders = ds.find_dataset_folders(str(tmp_path), fields)
    assert folders == jds.find_dataset_folders(str(tmp_path), fields) and len(folders) == 3
    assert ds.find_dataset_folders(str(tmp_path), fields, ds.SPLIT_TRAIN) == []
    assert (ds.SPLIT_TRAIN, ds.SPLIT_TEST) == (jds.SPLIT_TRAIN, jds.SPLIT_TEST)
    got, want = ds.PackedDataset(folders, fields, preload=preload), jds.PackedDataset(folders, fields)
    assert len(got) == len(want) == 6
    for i in list(range(6)) + [-1, -6]:
        a, b = got[i], want[i]
        assert a["labels"] == b["labels"]
        np.testing.assert_array_equal(a["mono"], b["mono"])


def test_dataset_refuses_unequal_fields(tmp_path):
    d = tmp_path / "rec" / "testing"
    d.mkdir(parents=True)
    idxbin.write_torch_idx(str(d / "mono.torch.idx"), [np.zeros(2, np.uint8)] * 3)
    idxbin.write_torch_idx(str(d / "labels.torch.idx"), [{"i": 0}] * 2)
    with pytest.raises(ValueError, match="length mismatch"):
        ds.PackedDataset([str(d)], ["mono", "labels"])


@pytest.mark.parametrize("shuffle,drop", list(itertools.product((False, True), (False, True))))
def test_shard_sampler_equals_jax(shuffle, drop):
    """Over n, world size, io workers, every (rank, worker), two seeds and
    three epochs: the same indices and length as JAX's sampler, exactly."""
    for n, world, workers in itertools.product((0, 1, 7, 10, 24), (1, 2, 3), (1, 2, 3)):
        _check_sampler(n, world, workers, shuffle, drop)


def _check_sampler(n, world, workers, shuffle, drop):
    for rank, worker, seed in itertools.product(range(world), range(workers), (0, 7)):
        kw = dict(n=n, rank=rank, world_size=world, shuffle=shuffle, seed=seed, drop_remainder=drop,
                  worker=worker, num_workers=workers)
        a, b = ds.ShardSampler(**kw), jds.ShardSampler(**kw)
        for epoch in (0, 1, 5):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert a.indices.dtype == b.indices.dtype
            np.testing.assert_array_equal(a.indices, b.indices)
            assert list(a) == list(b) and len(a) == len(b)


def test_shard_sampler_refuses_bad_ranks():
    with pytest.raises(ValueError, match="rank"):
        ds.ShardSampler(4, rank=2, world_size=2)
    with pytest.raises(ValueError, match="worker"):
        ds.ShardSampler(4, worker=1, num_workers=1)


def test_subsample_map_and_collate():
    for n, fraction, seed in ((10, 0.3, 0), (100, 0.05, 3), (7, 1.0, 1), (5, 0.01, 2)):
        np.testing.assert_array_equal(ds.subsample_indices(n, fraction, seed), jds.subsample_indices(n, fraction, seed))
    base = list(range(5))
    mapped = ds.map_dataset(base, lambda x: x * 3)
    assert isinstance(mapped, ds.MappedDataset) and len(mapped) == 5 and [mapped[i] for i in range(5)] == [0, 3, 6, 9, 12]
    rng = np.random.default_rng(0)
    samples = [{"x": rng.standard_normal((2, 3)), "y": {"i": i}, "z": [i]} for i in range(3)]
    a, b = ds.collate(samples), jds.collate(samples)
    assert sorted(a) == sorted(b)
    np.testing.assert_array_equal(a["x"], b["x"])
    assert a["y"] == b["y"] and a["z"] == b["z"]


def test_package_exports_match_jax():
    from absolutetrack_tpu import data as jdata

    assert sorted(port_data.__all__) == sorted(jdata.__all__)


def test_prefetch_order_and_transform():
    assert list(PrefetchIterator(range(50), max_prefetch=4)) == list(jprefetch.PrefetchIterator(range(50), max_prefetch=4))
    worker_threads = []

    def transform(x):
        worker_threads.append(threading.current_thread())
        return x * 2

    assert list(PrefetchIterator(range(5), transform=transform)) == [0, 2, 4, 6, 8]
    assert worker_threads and all(t is not threading.main_thread() for t in worker_threads)


def test_prefetch_reraises_worker_exceptions():
    """Items before the failure arrive, then the worker's exception raises
    at the consumer, also from ``transform``."""

    def gen():
        yield 1
        raise RuntimeError("boom")

    it = PrefetchIterator(gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)

    def bad(x):
        if x == 2:
            raise ValueError("bad item")
        return x

    got = []
    with pytest.raises(ValueError, match="bad item"):
        for x in PrefetchIterator(range(5), transform=bad):
            got.append(x)
    assert got == [0, 1]


def test_prefetch_close_stops_worker():
    """``close`` on an endless source returns and the worker thread ends."""
    it = PrefetchIterator(itertools.count(), max_prefetch=2)
    assert next(it) == 0
    it.close()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()
    # a source slower than the consumer: the worker stops after its current item
    slow = PrefetchIterator((time.sleep(0.01) or i for i in itertools.count()), max_prefetch=1)
    next(slow)
    slow.close()
    slow._thread.join(timeout=5)
    assert not slow._thread.is_alive()
