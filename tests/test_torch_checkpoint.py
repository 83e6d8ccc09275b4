"""Port parity: weights and checkpoints (``models/weights.py``,
``models/checkpoint.py``, ``models/params.py::export_jax_params``,
``utils/flax_msgpack.py``).

The reference-named state dict is ``chip_smoke.reference_state_dict``
(seeded: BN statistics nonzero, variances positive, biases nonzero). Both
packages convert it; their trees must be bit-equal leaf by leaf and have
the structure of JAX's ``init_umetrack_params``. Checkpoint files cross
both ways bit-exactly, and the port's file holds the same bytes as the JAX
package's ``save_params`` (flax's ``to_bytes`` of the ``jax.tree.map``-ed
tree, whose dict keys are sorted). Tolerance: none, every comparison is
exact.
"""

import io
import json
import pickle
from contextlib import redirect_stdout

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from absolutetrack_tpu.models import checkpoint as jck, weights as jw
from absolutetrack_tpu.models.config import ModelConfig as JConfig
from absolutetrack_tpu.models.umetrack import init_umetrack_params
from absolutetrack_tpu_torch.apps import eval_lib
from absolutetrack_tpu_torch.apps.demo import main as demo_main
from absolutetrack_tpu_torch.models import checkpoint as ck, weights as tw
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.models.params import export_jax_params, load_jax_params
from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
from absolutetrack_tpu_torch.utils import flax_msgpack

jax.config.update("jax_platforms", "cpu")

CFG = ModelConfig.tiny()
JCFG = JConfig.tiny()
CONFIGS = {"tiny": (ModelConfig.tiny(), JConfig.tiny()), "full": (ModelConfig(), JConfig())}


@pytest.fixture(scope="module")
def state_dict():
    return chip_smoke.reference_state_dict(CFG, seed=4)


def _assert_same_tree(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _model_tree(model):
    """The model's weights as a JAX tree (the inverse of ``load_jax_params``)."""
    return export_jax_params(model)


@pytest.mark.parametrize("size", sorted(CONFIGS))
def test_convert_state_dict_matches_jax(size):
    """The reference-named state dict through both converters: bit-equal
    leaves, the structure and shapes of ``init_umetrack_params``."""
    cfg, jcfg = CONFIGS[size]
    sd = chip_smoke.reference_state_dict(cfg, seed=1)
    ours = tw.convert_torch_state_dict(sd, cfg)
    _assert_same_tree(jw.convert_torch_state_dict(sd, jcfg), ours)
    init = init_umetrack_params(jax.random.PRNGKey(0), jcfg)
    assert jax.tree.structure(init) == jax.tree.structure(ours)
    assert [np.shape(x) for x in jax.tree.leaves(init)] == [x.shape for x in jax.tree.leaves(ours)]
    # the fixture folds real BNs: positive variances, nonzero means
    assert all(float(sd[k].abs().min()) > 0 for k in sd if k.endswith("running_var"))
    assert any(float(sd[k].abs().max()) > 0 for k in sd if k.endswith("running_mean"))


def test_export_inverts_load_jax_params():
    init = init_umetrack_params(jax.random.PRNGKey(2), JCFG)
    params = jax.tree.map(np.asarray, init)
    model = load_jax_params(params, CFG, device="cpu")
    tree = _model_tree(model)
    _assert_same_tree(params, tree)
    # the init tree's key order (jax.tree.map sorts dict keys; the init does not)
    assert list(tree) == list(init) and list(tree["backbone"]) == list(init["backbone"])


def test_jax_file_loads_in_the_port(tmp_path, state_dict):
    tree = jw.convert_torch_state_dict(state_dict, JCFG)
    path = str(tmp_path / "jax.msgpack")
    jck.save_params(path, tree)
    loaded = ck.load_params(path, CFG)
    _assert_same_tree(tree, loaded)
    model = load_jax_params(loaded, CFG, device="cpu")
    _assert_same_tree(tree, _model_tree(model))


@pytest.mark.parametrize("source", ["model", "tree"])
def test_port_file_loads_in_jax_with_the_same_bytes(tmp_path, state_dict, source):
    tree = tw.convert_torch_state_dict(state_dict, CFG)
    ours = str(tmp_path / "port.msgpack")
    theirs = str(tmp_path / "jax.msgpack")
    ck.save_params(ours, load_jax_params(tree, CFG, device="cpu") if source == "model" else tree)
    jck.save_params(theirs, tree)
    data = open(ours, "rb").read()
    assert data == open(theirs, "rb").read()
    assert data == serialization.to_bytes(jax.tree.map(np.asarray, tree))
    _assert_same_tree(tree, jax.tree.map(np.asarray, jck.load_params(ours, JCFG)))
    assert not (tmp_path / "port.msgpack.tmp").exists()


def test_save_params_overwrites_atomically(tmp_path, state_dict):
    tree = tw.convert_torch_state_dict(state_dict, CFG)
    path = str(tmp_path / "sub" / "ckpt.msgpack")
    ck.save_params(path, tree)
    bumped = jax.tree.map(lambda x: x + np.float32(1), tree)
    ck.save_params(path, bumped)
    _assert_same_tree(bumped, ck.load_params(path, CFG))
    assert sorted(p.name for p in (tmp_path / "sub").iterdir()) == ["ckpt.msgpack"]


@pytest.mark.parametrize(
    "case",
    ["torch_ext", "pt_ext", "pth_ext", "zip_magic", "legacy_p2", "legacy_p3", "legacy_p4", "legacy_p5", "msgpack"],
)
def test_load_any_dispatch(tmp_path, state_dict, case):
    """Each dispatch route of ``load_any``, in both packages, gives the
    converted tree; the sniffed files carry no torch extension. Pickle
    protocols 4 and 5 reach the torch loader in both packages, whose
    tensors-only unpickler refuses their FRAME opcode (PyTorch 2.13): both
    raise its ``UnpicklingError``, not the msgpack path's ``ValueError``."""
    want = tw.convert_torch_state_dict(state_dict, CFG)
    if case.endswith("_ext"):
        path = str(tmp_path / f"w.{case[:-4]}")
        torch.save(state_dict, path)
    elif case == "zip_magic":
        path = str(tmp_path / "w.ckpt")
        torch.save(state_dict, path)
        assert open(path, "rb").read(4) == b"PK\x03\x04"
    elif case.startswith("legacy"):
        protocol = int(case[-1])
        path = str(tmp_path / "w.bin")
        torch.save(state_dict, path, _use_new_zipfile_serialization=False, pickle_protocol=protocol)
        assert open(path, "rb").read(2) == bytes([0x80, protocol])
        if protocol >= 4:
            for load_any, cfg in ((ck.load_any, CFG), (jck.load_any, JCFG)):
                with pytest.raises(pickle.UnpicklingError, match="Weights only load failed"):
                    load_any(path, cfg)
            return
    else:
        path = str(tmp_path / "w.msgpack")
        jck.save_params(path, want)
    _assert_same_tree(want, ck.load_any(path, CFG))
    _assert_same_tree(want, jax.tree.map(np.asarray, jck.load_any(path, JCFG)))


def test_load_any_error_on_a_mismatched_config(tmp_path, state_dict):
    """A native file saved for another architecture: the JAX package's
    ValueError text, with the cause chained."""
    path = str(tmp_path / "tiny.msgpack")
    ck.save_params(path, tw.convert_torch_state_dict(state_dict, CFG))
    full = ModelConfig()
    with pytest.raises(ValueError, match="failed to load as a native flax-msgpack checkpoint") as ours:
        ck.load_any(path, full)
    with pytest.raises(ValueError, match="failed to load as a native flax-msgpack checkpoint") as theirs:
        jck.load_any(path, JConfig())
    head = "architecture likely does not match the one it was saved from"
    assert head in str(ours.value) and head in str(theirs.value)
    assert str(ours.value).split("(cfg=")[0] == str(theirs.value).split("(cfg=")[0]
    assert isinstance(ours.value.__cause__, ValueError)
    # a file that is neither format
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"\x01\x02\x03\x04")
    with pytest.raises(ValueError, match="magic bytes"):
        ck.load_any(str(junk), CFG)


def test_build_model_from_checkpoints(tmp_path, state_dict):
    """``build_model(checkpoint=...)`` in parity and serving: the parity
    model holds the converted weights exactly, the serving model the same
    weights rounded to bf16 once."""
    path = str(tmp_path / "w.pt")
    torch.save(state_dict, path)
    want = tw.convert_torch_state_dict(state_dict, CFG)
    parity = eval_lib.build_model(path, CFG, device="cpu")
    _assert_same_tree(want, _model_tree(parity))
    serving = eval_lib.build_model(path, ModelConfig.tiny(compute_dtype="bfloat16"), device="cpu")
    assert serving.backbone.stem.weight.dtype == torch.bfloat16
    # the skeleton encoder stays f32 in the serving preset
    rounded = {
        k: v if k == "skeleton_encoder" else jax.tree.map(lambda x: torch.from_numpy(x).to(torch.bfloat16).float().numpy(), v)
        for k, v in want.items()
    }
    _assert_same_tree(rounded, _model_tree(serving))


def test_demo_checkpoint_flag_loads_the_file(tmp_path, monkeypatch):
    """The demo's ``--checkpoint`` builds the tracker from that file."""
    sd = chip_smoke.reference_state_dict(ModelConfig(), seed=2)
    path = str(tmp_path / "w.pt")
    torch.save(sd, path)
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps(chip_smoke.labels_json(chip_smoke.build_scene(0, n_frames=2, mesh=True))))
    built = []
    original = eval_lib.build_model

    def spy(*args, **kwargs):
        built.append(original(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(eval_lib, "build_model", spy)
    out = io.StringIO()
    with redirect_stdout(out):
        demo_main.main([
            "--source", "replay", "--labels", str(labels), "--max-frames", "1", "--torch-device", "cpu",
            "--no-udp", "--precision", "parity", "--checkpoint", path,
        ])
    assert out.getvalue().startswith("frame 0:")
    _assert_same_tree(tw.convert_torch_state_dict(sd, ModelConfig()), _model_tree(built[0]))


# -- the msgpack codec ---------------------------------------------------------


def _values():
    return {
        **{f"key{i:02d}": i for i in range(17)},  # map16: more than 15 keys
        "k" * 40: "v" * 300,  # str8 key, str16 value
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129, -(2**15) - 1, -(2**31) - 1],
        "floats": [0.5, -1e300, float("inf")],
        "misc": [None, True, False, b"", b"x" * 70000, list(range(20))],  # bin8, bin32, array16
        "arrays": [np.arange(6, dtype=np.float32).reshape(2, 3), np.zeros((0,), np.int64), np.full((), 3, np.float32),
                   np.ones(20000, np.float32), np.array([1, 2], np.uint8)],  # payload bin32 for 80,000 bytes
    }


def _ext(code, data):
    assert code == flax_msgpack.EXT_NDARRAY
    shape, dtype, raw = msgpack.unpackb(data, raw=False)
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def test_msgpack_codec_matches_the_msgpack_package():
    values = _values()
    ours = flax_msgpack.packb(values)
    reference = msgpack.packb(
        values,
        use_bin_type=True,
        default=lambda a: msgpack.ExtType(
            flax_msgpack.EXT_NDARRAY, msgpack.packb([list(a.shape), a.dtype.name, a.tobytes("C")], use_bin_type=True)
        ),
    )
    assert ours == reference
    assert ours[0] == 0xDE  # map16
    back = flax_msgpack.unpackb(ours)
    again = msgpack.unpackb(ours, raw=False, ext_hook=_ext)
    for got in (back, again):
        assert {k: v for k, v in got.items() if k != "arrays"} == {k: v for k, v in values.items() if k != "arrays"}
        for a, b in zip(got["arrays"], values["arrays"]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # the headers the test means to cover
    assert b"\xd9\x28" + b"k" * 40 in ours and b"\xc6\x00\x01\x11\x70" in ours and b"\xdc\x00\x14" in ours
    assert flax_msgpack.unpackb(msgpack.packb(values["ints"])) == values["ints"]


def test_msgpack_codec_reads_flax_and_refuses_what_it_cannot():
    tree = {"a": [np.ones((2, 2), np.float32)], "b": {"c": np.arange(3, dtype=np.int32)}}
    back = flax_msgpack.unpackb(serialization.to_bytes(tree))
    assert sorted(back) == ["a", "b"] and sorted(back["a"]) == ["0"]
    np.testing.assert_array_equal(back["a"]["0"], tree["a"][0])
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])
    chunked = msgpack.packb({"w": {flax_msgpack.CHUNKED_MARKER: True, "shape": {"0": 1}, "chunks": {}}})
    with pytest.raises(ValueError, match="chunked array"):
        flax_msgpack.unpackb(chunked)
    with pytest.raises(ValueError, match="extension type 3"):
        flax_msgpack.unpackb(serialization.to_bytes({"s": np.float32(1.0)}))
    with pytest.raises(ValueError, match="bytes after"):
        flax_msgpack.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(TypeError, match="cannot pack"):
        flax_msgpack.packb({"x": object()})
    with pytest.raises(ValueError, match="ends inside"):
        flax_msgpack.unpackb(msgpack.packb("abc")[:-1])


def test_pickled_results_are_plain_dicts(tmp_path):
    """The eval apps' result files (``write_result``) load with pickle alone."""
    from absolutetrack_tpu_torch.apps.run_eval_known_skeleton import write_result

    res = eval_lib.SequenceResult(
        tracked_keypoints=np.zeros((2, 3, 21, 3), np.float32),
        gt_keypoints=np.ones((2, 3, 21, 3), np.float32),
        valid_tracking=np.array([[True, False, True], [True, True, True]]),
    )
    err = write_result(str(tmp_path / "a" / "r.npy"), res, calibrated_scale=1.5)
    d = pickle.load(open(tmp_path / "a" / "r.npy", "rb"))
    assert sorted(d) == ["calibrated_scale", "gt_keypoints", "tracked_keypoints", "valid_tracking"]
    assert d["calibrated_scale"] == 1.5 and err.shape == (5,)
    np.testing.assert_allclose(err, np.sqrt(3.0), rtol=1e-6)


def test_model_tree_is_float32_for_a_serving_model():
    model = UmeTrackModel(ModelConfig.tiny(compute_dtype="bfloat16"), device="cpu")
    assert all(x.dtype == np.float32 for x in jax.tree.leaves(export_jax_params(model)))
