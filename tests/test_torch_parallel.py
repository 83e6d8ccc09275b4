"""Port parity: sharding over processes (``absolutetrack_tpu_torch/parallel/``
and the paths that take a mesh) against one process of the port and
against the JAX package's ``parallel/`` on its 8 virtual CPU devices.

The port's worlds are spawned gloo processes on the CPU
(``chip_smoke.spawn_world``: each rank a fresh ``python chip_smoke.py
--rank`` process that imports only the port, joined over a ``file://``
store in a temporary directory, so parallel test workers share no port;
joined with a timeout, every rank killed on a failure, each rank's log in
the error). One world of 2 ranks runs every 2-rank drill in turn
(``chip_smoke.world_drill``), one of 4 the (2, 2) steps; their results
come back through files. Everything runs at tiny width
(``ModelConfig.tiny()``, 32x32 crops) but the data CLI, which always
builds the full model.

Tolerances, JAX's own layout budgets (``tests/test_parallel.py``,
``tests/test_multiprocess.py``) unless said otherwise:

* ``window_shard`` and the blocks of ``shard_batch``: exact;
  ``allreduce_metrics``: JAX's float32 formula bit for bit;
* the eval step under a mesh against one process: ``err_sum_m`` 1e-4
  relative, ``err_count`` equal, joint angles and wrists 1e-4 absolute,
  the unknown branch's scales 1e-4 relative; against JAX's step under the
  (2, 1) mesh: ``err_sum_m`` 1e-5 relative (``LOSS_FN_REL`` of
  ``tests/test_torch_training.py``), the outputs 2e-4 / 5e-4 (the model's
  budgets of ``tests/test_torch_model.py``);
* the train step under a mesh against one process on a batch whose masks
  differ between the data blocks: the loss 1e-6 relative, each gradient
  leaf before the optimizer within 1e-4 of its own largest |g|
  (``GRAD_TOL``), the params after the step 1e-2 of each leaf's largest
  value, every rank's params bit-equal;
* the sharded lockstep: validity equal, landmarks 1e-4 relative + 1e-2 mm;
* ``multiprocess_eval``: counts equal, ``err_sum`` and ``mean_err_mm``
  1e-6 relative against the port's world 1; world 1 against JAX's
  ``run_distributed_eval``: counts equal, the mean error within the
  protocol's 0.5 mm a hand-frame (``tests/test_torch_protocol.py``);
* the CLIs at ``--mesh-data 2``/``--model-axis 2``: both eval CLIs'
  pickles within the protocol's 0.5 mm and validity equal, the calibrated
  scales 1e-5 relative, the data CLI's
  errors 1e-6 relative + 1e-4 mm and its printed lines equal, the train
  app's loss lines equal.
"""

import io
import json
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.kinematics import hand_model as jhm
from absolutetrack_tpu.models.config import ModelConfig as JConfig
from absolutetrack_tpu.parallel import make_mesh as jmake_mesh
from absolutetrack_tpu.parallel import shard_batch as jshard_batch
from absolutetrack_tpu.parallel import window_shard as jwindow_shard
from absolutetrack_tpu.parallel import multiprocess_eval as jmpe
from absolutetrack_tpu.training import train as jtrain
from absolutetrack_tpu_torch.apps import pack_sample_data as pack
from absolutetrack_tpu_torch.apps import run_eval_known_skeleton as known
from absolutetrack_tpu_torch.apps import run_eval_unknown_skeleton as unknown
from absolutetrack_tpu_torch.apps import run_inference_torch_data as infer
from absolutetrack_tpu_torch.apps import train as app
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.models.params import export_jax_params
from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
from absolutetrack_tpu_torch.parallel import (
    Mesh,
    allreduce_metrics,
    init_distributed,
    make_mesh,
    multiprocess_eval,
    process_shard,
    shard_batch,
    window_shard,
)

jax.config.update("jax_platforms", "cpu")

SEED = 0
BATCH, T = 8, 3  # tests/test_parallel.py's synthetic_sequence_batch(8, t=3)
LAYOUTS_2 = ((2, 1), (1, 2))
FRAMES = 4  # per recording of the label tree
RECORDINGS = 4
LOCKSTEP_FRAMES = 3
THREADS = 1  # each rank's intra-op threads (the suite's workers keep the cores busy)
STEP_REL = 1e-4
OUTPUT_TOL = 1e-4
LOSS_REL = 1e-6
GRAD_TOL = 1e-4
PARAM_TOL = 1e-2
LOSS_FN_REL = 1e-5
JAX_ANGLE_TOL = 2e-4
JAX_WRIST_TOL = 5e-4
EVAL_REL = 1e-6
PROTOCOL_MM = 0.5
SCALE_REL = 1e-5
DATA_WINDOWS = 4  # --batch-windows, 2 a rank
ALLREDUCE_VALUES = [  # per rank; float32 rounding shows in the sum
    {"err_sum": 16777216.0, "err_count": 0.1, "n": 3.0},
    {"err_sum": 1.0, "err_count": 0.2, "n": 1e-8},
]


def _cli(module, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        ret = module.main(argv)
    return ret, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The hermetic label tree (4 recordings x 4 mesh frames), its generic
    hand model, a reference-named ``.pt`` at tiny width and one at full
    width, and the tree packed (windows of 2) from the scene's own views."""
    root = tmp_path_factory.mktemp("parallel")
    scene = chip_smoke.build_scene(SEED, FRAMES + RECORDINGS - 1, mesh=True)
    data, generic = chip_smoke.protocol_tree(root, scene, RECORDINGS, FRAMES)
    tiny_pt, full_pt = root / "tiny.pt", root / "full.pt"
    torch.save(chip_smoke.reference_state_dict(ModelConfig.tiny(), SEED), tiny_pt)
    torch.save(chip_smoke.reference_state_dict(ModelConfig(), SEED), full_pt)

    def scene_frames(labels, video_path, renderer="mesh"):
        start = int(video_path[-6:-4])  # .../recording_0{i}.mp4
        return list(scene["frames"][start : start + FRAMES])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pack.eval_lib, "frames_for", scene_frames)
        _cli(pack, ["--input-dir", str(data), "--generic-hand-model", str(generic), "--window", "2",
                    "--max-frames", str(FRAMES), "--output-dir", str(root / "packed"), "--torch-device", "cpu"])
    return dict(root=root, data=str(data), generic=str(generic), tiny_pt=str(tiny_pt), full_pt=str(full_pt),
                files=sorted(str(p) for p in data.rglob("*.json")), packed=str(root / "packed"))


def _known_argv(inputs, out):
    return ["--input-dir", inputs["data"], "--output-dir", out, "--checkpoint", inputs["tiny_pt"], "--tiny-arch",
            "--torch-device", "cpu", "--batch-recordings", str(RECORDINGS), "--max-frames", str(FRAMES)]


def _unknown_argv(inputs, out):
    return _known_argv(inputs, out) + ["--generic-hand-model", inputs["generic"], "--calib-mode", "mean"]


def _data_argv(inputs):
    return ["--data-root", inputs["packed"], "--checkpoint", inputs["full_pt"], "--torch-device", "cpu",
            "--batch-windows", str(DATA_WINDOWS), "--limit", str(DATA_WINDOWS), "--prefetch", "1"]


def _train_argv(inputs, save):
    return ["--synthetic", "--tiny-arch", "--steps", "2", "--batch", "2", "--window", "2", "--eval-every", "1",
            "--generic-hand-model", inputs["generic"], "--save", save, "--torch-device", "cpu"]


def _mpe_argv(inputs, out):
    return ["--label-files", *inputs["files"], "--checkpoint", inputs["tiny_pt"], "--max-frames", str(FRAMES),
            "--tiny-arch", "--torch-device", "cpu", "--output", out]


@pytest.fixture(scope="module")
def world2(inputs):
    """Every 2-rank drill in one gloo world on the CPU -> each rank's results."""
    root = inputs["root"]
    parts = {
        "allreduce": dict(values=ALLREDUCE_VALUES),
        "steps": dict(seed=SEED, layouts=LAYOUTS_2, batch=BATCH, t=T),
        "lockstep": dict(seed=SEED, recordings=RECORDINGS, frames=LOCKSTEP_FRAMES),
        "eval": dict(label_files=inputs["files"], checkpoint=inputs["tiny_pt"], max_frames=FRAMES),
        "cli": [
            ("absolutetrack_tpu_torch.apps.run_eval_known_skeleton",
             _known_argv(inputs, str(root / "known_mesh")) + ["--mesh-data", "2", "--backend", "gloo"]),
            ("absolutetrack_tpu_torch.apps.run_inference_torch_data", _data_argv(inputs) + ["--mesh-data", "2"]),
            ("absolutetrack_tpu_torch.apps.run_eval_unknown_skeleton",
             _unknown_argv(inputs, str(root / "unknown_mesh")) + ["--mesh-data", "2", "--backend", "gloo"]),
            ("absolutetrack_tpu_torch.apps.train", _train_argv(inputs, str(root / "mesh.msgpack")) + ["--model-axis", "2"]),
            # last: its main leaves the process group
            ("absolutetrack_tpu_torch.parallel.multiprocess_eval", _mpe_argv(inputs, str(root / "mpe.json"))),
        ],
    }
    return chip_smoke.spawn_world("world_drill", dict(parts=parts, tiny=True, device="cpu"), 2, root / "w2",
                                  "gloo", "cpu", timeout=300, threads=THREADS)


@pytest.fixture(scope="module")
def world4(inputs):
    """The (2, 2) steps in a gloo world of 4 ranks on the CPU."""
    parts = {"steps": dict(seed=SEED, layouts=((2, 2),), batch=BATCH, t=T)}
    return chip_smoke.spawn_world("world_drill", dict(parts=parts, tiny=True, device="cpu"), 4,
                                  inputs["root"] / "w4", "gloo", "cpu", timeout=300, threads=1)


@pytest.fixture(scope="module")
def one_process():
    """The steps' numbers from one process of the port, no mesh."""
    return chip_smoke.one_process_steps(SEED, BATCH, T, tiny=True, device="cpu")


# --------------------------------------------------------------------------
# the helpers against JAX's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape,window,axis", [((2, 6, 3), 3, 1), ((3, 8, 2, 5), 2, 1), ((4, 5, 6), 2, 0),
                                               ((1, 4), 4, 1)])
def test_window_shard_matches_jax(shape, window, axis):
    arr = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want, want_mem = jwindow_shard(arr, window, time_axis=axis)
    got, got_mem = window_shard(arr, window, time_axis=axis)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_mem, want_mem)
    assert got.dtype == want.dtype and got_mem.dtype == want_mem.dtype
    with pytest.raises(ValueError, match="does not divide"):
        window_shard(np.zeros((1, 5)), 2)


def test_shard_batch_blocks_are_jaxs_named_sharding():
    """Each rank's block of a (4, 2) mesh is the one that JAX's
    ``NamedSharding(P("data"))`` places on the device at the same (d, m);
    the data blocks concatenate back to the input; a scalar stays whole."""
    tree = {"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3), "s": np.float32(7.0),
            "y": (np.arange(8 * 2 * 2).reshape(8, 2, 2),)}
    jmesh = jmake_mesh(data=4, model=2)
    placed = jshard_batch(jmesh, tree)
    blocks = {}
    for rank in range(8):
        mesh = Mesh(4, 2, rank, torch.device("cpu"))
        mine = shard_batch(mesh, tree)
        dev = jmesh.devices[mesh.data_index, mesh.model_index]
        for key, got in (("x", mine["x"]), ("y", mine["y"][0])):
            want = [s.data for s in (placed[key] if key == "x" else placed[key][0]).addressable_shards
                    if s.device == dev][0]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(mine["s"]) == 7.0
        blocks.setdefault(mesh.data_index, mine["x"].numpy())
    np.testing.assert_array_equal(np.concatenate([blocks[d] for d in range(4)]), tree["x"])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(Mesh(3, 1, 0, torch.device("cpu")), tree)


def test_one_process_needs_no_group(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed(device="cpu") == (0, 1) == process_shard()
    m = {"err_sum": 3.5, "count": 7.0}
    assert allreduce_metrics(m) == m
    mesh = make_mesh(devices="cpu")
    assert (mesh.shape, mesh.rank, mesh.device, mesh.axis_names) == (
        {"data": 1, "model": 1}, 0, torch.device("cpu"), ("data", "model"))
    with pytest.raises(RuntimeError, match=r"a \(2, 1\) mesh needs a process group of 2 ranks.*torchrun"):
        make_mesh(data=2, devices="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(num_processes=2, device="cpu")


def test_allreduce_metrics_is_jaxs_float32_formula(world2):
    """At world 2: JAX's keys sorted, float32 vectors, gathered, summed by numpy."""
    keys = sorted(ALLREDUCE_VALUES[0])
    gathered = np.stack([np.asarray([v[k] for k in keys], np.float32) for v in ALLREDUCE_VALUES])
    total = np.sum(gathered, axis=0)
    want = {k: float(total[i]) for i, k in enumerate(keys)}
    for rank in world2:
        assert rank["allreduce"] == want
    assert want["err_sum"] != ALLREDUCE_VALUES[0]["err_sum"] + ALLREDUCE_VALUES[1]["err_sum"]  # float32, not float64


# --------------------------------------------------------------------------
# the steps under a mesh
# --------------------------------------------------------------------------


def _layout(world2, world4, layout):
    ranks = world4 if layout == (2, 2) else world2
    return [r["steps"][layout] for r in ranks]


def test_masks_differ_across_data_blocks():
    """The steps' batch: a mean of the data blocks' means is not the batch's."""
    batch, _ = chip_smoke.parallel_batch(ModelConfig.tiny(), BATCH, T, SEED)
    m = batch.sample_mask.astype(np.float64)
    x = np.arange(BATCH, dtype=np.float64)[None] * np.ones((T, 1))
    halves = [(x[:, s] * m[:, s]).sum() / m[:, s].sum() for s in (slice(0, 4), slice(4, 8))]
    assert m[:, :4].sum() != m[:, 4:].sum() and np.mean(halves) != (x * m).sum() / m.sum()


@pytest.mark.parametrize("layout", [(2, 1), (1, 2), (2, 2)])
def test_eval_step_under_mesh_matches_one_process(world2, world4, one_process, layout):
    got = _layout(world2, world4, layout)[0]["evals"]
    for branch in ("known", "unknown"):
        g, w = got[branch], one_process["evals"][branch]
        np.testing.assert_allclose(g["err_sum_m"], w["err_sum_m"], rtol=STEP_REL)
        assert float(g["err_count"]) == float(w["err_count"]) == (chip_smoke.parallel_batch(
            ModelConfig.tiny(), BATCH, T, SEED)[0].sample_mask.sum())
        assert g["joint_angles"].shape == w["joint_angles"].shape == (T, BATCH, 22)
        np.testing.assert_allclose(g["joint_angles"], w["joint_angles"], atol=OUTPUT_TOL)
        np.testing.assert_allclose(g["wrist_xfs"], w["wrist_xfs"], atol=OUTPUT_TOL)
    assert got["known"]["scales"] is None
    np.testing.assert_allclose(got["unknown"]["scales"], one_process["evals"]["unknown"]["scales"], rtol=STEP_REL)


def test_eval_step_under_mesh_matches_jax(world2):
    """The (2, 1) layout against JAX's ``make_eval_step`` under its (2, 1)
    mesh, with the seeded port model's params carried to JAX."""
    cfg = ModelConfig.tiny()
    model = UmeTrackModel(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    params = export_jax_params(model)
    batch, _ = chip_smoke.parallel_batch(cfg, BATCH, T, SEED)
    jh = jhm.scaled_hand_model(jhm.hand_model_from_dict(chip_smoke.synthetic_hand_model()), 0.001)
    jh = jax.tree.map(lambda x: jnp.broadcast_to(x, (BATCH,) + x.shape), jh)
    jbatch = jtrain.SequenceBatch(**batch._asdict())
    mesh = jmake_mesh(data=2, model=1, devices=jax.devices()[:2])
    got = world2[0]["steps"][(2, 1)]["evals"]
    with mesh:
        placed = jax.tree.map(lambda x, s: jax.device_put(np.asarray(x), s), jbatch, jtrain.batch_shardings(mesh),
                              is_leaf=lambda x: x is None)
        for branch in ("known", "unknown"):
            want = jax.tree.map(np.asarray, jtrain.make_eval_step(mesh, JConfig.tiny(), branch)(params, placed, jh))
            g = got[branch]
            assert abs(float(g["err_sum_m"]) - float(want["err_sum_m"])) <= LOSS_FN_REL * abs(float(want["err_sum_m"]))
            assert float(g["err_count"]) == float(want["err_count"])
            np.testing.assert_allclose(g["joint_angles"], want["joint_angles"], atol=JAX_ANGLE_TOL)
            np.testing.assert_allclose(g["wrist_xfs"], want["wrist_xfs"], atol=JAX_WRIST_TOL)
            if branch == "unknown":
                np.testing.assert_allclose(g["scales"], want["scales"], rtol=STEP_REL)


@pytest.mark.parametrize("layout", [(2, 1), (1, 2), (2, 2)])
def test_train_step_under_mesh_matches_one_process(world2, world4, one_process, layout):
    """The loss and every gradient leaf before the optimizer, then the
    params after the step; every rank ends with the same params. A
    gradient counted twice over the model axis, or a mean of the data
    blocks' means, fails the gradient check by far."""
    ranks = _layout(world2, world4, layout)
    got = ranks[0]
    assert len({r["params_digest"] for r in ranks}) == 1
    assert all(r["loss"] == got["loss"] == r["step_loss"] for r in ranks)
    assert abs(got["loss"] - one_process["loss"]) <= LOSS_REL * abs(one_process["loss"])
    for k, v in one_process["metrics"].items():
        assert abs(got["metrics"][k] - v) <= LOSS_REL * abs(v) + 1e-12, k
    for k, g in one_process["grads"].items():
        np.testing.assert_allclose(got["grads"][k], g, rtol=0, atol=GRAD_TOL * max(np.abs(g).max(), 1e-30), err_msg=k)
    for k, p in one_process["params"].items():
        scale = max(np.abs(p).max(), 1e-9)
        np.testing.assert_allclose(got["params"][k] / scale, p / scale, atol=PARAM_TOL, err_msg=k)


# --------------------------------------------------------------------------
# the sharded lockstep and multiprocess_eval
# --------------------------------------------------------------------------


def test_sharded_lockstep_matches_one_process(world2):
    """Each of 2 ranks tracks 2 of 4 recordings; every rank returns all 4."""
    net = chip_smoke.damped(UmeTrackModel(ModelConfig.tiny(), device="cpu",
                                          generator=torch.Generator().manual_seed(SEED)))
    recs = chip_smoke.scene_recordings(
        chip_smoke.build_scene(SEED + 1, n_frames=LOCKSTEP_FRAMES + RECORDINGS - 1), range(RECORDINGS), LOCKSTEP_FRAMES
    )
    plain = known.eval_lib.track_recordings_batched(net, recs, chunk_size=chip_smoke.LOCKSTEP_CHUNK)
    for rank in world2:
        got = rank["lockstep"]["results"]
        assert len(got) == RECORDINGS
        for rs, rp in zip(got, plain):
            np.testing.assert_array_equal(rs.valid_tracking, rp.valid_tracking)
            m = rp.valid_tracking
            assert m.any()
            np.testing.assert_allclose(rs.tracked_keypoints[m], rp.tracked_keypoints[m], rtol=1e-4, atol=1e-2)
            np.testing.assert_array_equal(rs.gt_keypoints, rp.gt_keypoints)


@pytest.fixture(scope="module")
def world1_eval(inputs):
    return multiprocess_eval.run_distributed_eval(
        inputs["files"], cfg=ModelConfig.tiny(), checkpoint=inputs["tiny_pt"], max_frames=FRAMES, device="cpu"
    )


def test_multiprocess_eval_two_ranks_match_world_1(world2, world1_eval, inputs):
    want = world1_eval
    assert want["world_size"] == 1.0 and want["n_recordings"] == RECORDINGS and want["err_count"] > 0
    for merged in [r["eval"]["merged"] for r in world2] + [json.loads((inputs["root"] / "mpe.json").read_text())]:
        assert merged["world_size"] == 2.0
        for k in ("err_count", "n_frames", "n_recordings"):
            assert merged[k] == want[k], k
        np.testing.assert_allclose(merged["err_sum"], want["err_sum"], rtol=EVAL_REL)
        np.testing.assert_allclose(merged["mean_err_mm"], want["mean_err_mm"], rtol=EVAL_REL)
    lines = [line for r in world2 for line in r["cli"][-1]["lines"]]
    assert sorted(line.split(":")[0] for line in lines) == ["rank 0", "rank 1"]


def test_multiprocess_eval_world_1_matches_jax(world1_eval, inputs):
    want = jmpe.run_distributed_eval(inputs["files"], cfg=jmpe.tiny_eval_config(), checkpoint=inputs["tiny_pt"],
                                     max_frames=FRAMES)
    for k in ("err_count", "n_frames", "n_recordings", "world_size"):
        assert world1_eval[k] == want[k], k
    assert abs(world1_eval["mean_err_mm"] - want["mean_err_mm"]) <= PROTOCOL_MM
    assert abs(world1_eval["err_sum"] - want["err_sum"]) <= PROTOCOL_MM * want["err_count"]


# --------------------------------------------------------------------------
# the CLIs in a world of 2
# --------------------------------------------------------------------------


def test_known_cli_mesh_data_2_writes_the_one_process_pickles(world2, inputs):
    out = str(inputs["root"] / "known_one")
    _cli(known, _known_argv(inputs, out))
    want, got = chip_smoke.read_results(out), chip_smoke.read_results(inputs["root"] / "known_mesh")
    assert sorted(got) == sorted(want) and len(want) == RECORDINGS
    assert chip_smoke.results_error(got, want) <= PROTOCOL_MM
    for name in want:
        np.testing.assert_allclose(got[name]["gt_keypoints"], want[name]["gt_keypoints"], atol=1e-3)
    rank0, rank1 = (r["cli"][0]["lines"] for r in world2)
    assert rank0[0] == f"[rank 0] {RECORDINGS} sequences" and rank0[-1].startswith("Final mean error") and not rank1


def test_unknown_cli_mesh_data_2_writes_the_one_process_pickles(world2, inputs):
    """Both passes in lockstep split over 2 ranks: the pickles within the
    protocol's bounds, the calibrated scales 1e-5 relative
    (``tests/test_torch_protocol.py``)."""
    out = str(inputs["root"] / "unknown_one")
    _, lines = _cli(unknown, _unknown_argv(inputs, out))
    want, got = chip_smoke.read_results(out), chip_smoke.read_results(inputs["root"] / "unknown_mesh")
    assert sorted(got) == sorted(want) and len(want) == RECORDINGS
    assert chip_smoke.results_error(got, want) <= PROTOCOL_MM
    for name in want:
        assert abs(got[name]["calibrated_scale"] - want[name]["calibrated_scale"]) <= SCALE_REL * want[name]["calibrated_scale"]
    rank0, rank1 = (r["cli"][2]["lines"] for r in world2)
    assert len(rank0) == len(lines) and rank0[-1].startswith("Final mean error") and not rank1


def test_data_cli_mesh_data_2_prints_the_same_errors(world2, inputs):
    (want, _), lines = _cli(infer, _data_argv(inputs))
    got, _ = world2[0]["cli"][1]["ret"]
    assert got.shape == want.shape == (DATA_WINDOWS, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(world2[1]["cli"][1]["ret"][0], got)
    mesh_lines = world2[0]["cli"][1]["lines"]
    assert mesh_lines[:2] == lines[:2] and mesh_lines[-1] == lines[-1] and not world2[1]["cli"][1]["lines"]
    assert mesh_lines[2].endswith(f"at W={DATA_WINDOWS}")


def test_train_app_model_axis_2_matches_one_process(world2, inputs):
    """``--model-axis 2`` at a world of 2: a (1, 2) mesh, the views over
    the ranks; the same loss lines as one process; rank 0 saves."""
    _, lines = _cli(app, _train_argv(inputs, str(inputs["root"] / "one.msgpack")))
    mesh_lines = world2[0]["cli"][3]["lines"]

    def losses(ls):
        return [re.sub(r" \([0-9.]+s\)$", "", line).replace("mesh.msgpack", "X").replace("one.msgpack", "X")
                for line in ls]

    assert losses(mesh_lines) == losses(lines) and any(line.startswith("step 1: loss=") for line in lines)
    assert not world2[1]["cli"][3]["lines"]
    assert (inputs["root"] / "mesh.msgpack.train").exists()
    steps = world2[0]["cli"][3]["ret"]["metrics"]
    assert [float(m["total"]) for m in steps] == [float(m["total"]) for m in world2[1]["cli"][3]["ret"]["metrics"]]


def test_cli_mesh_data_needs_a_world(inputs):
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        known.main(_known_argv(inputs, str(inputs["root"] / "never")) + ["--mesh-data", "2"])
    assert not (inputs["root"] / "never").exists()
