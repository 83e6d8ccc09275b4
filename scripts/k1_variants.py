"""Time the design steps of kernel K1 against each other on one NVIDIA card.

    python3 scripts/k1_variants.py [--earlier OLD.cu] [--extra NAME=PATH=ARG] [--rounds 3]

Each variant is a text substitution of the committed source,
``absolutetrack_tpu_torch/csrc/bilinear_sample.cu``, that takes one step
of its design back or changes one of its sizes. ``--earlier`` adds a K1
source with the C signature before the int8 mode (``git show
<commit>:absolutetrack_tpu_torch/csrc/bilinear_sample.cu`` gives one);
``--extra`` adds a source with the current signature, called with ARG in
the fourth parameter. All are built by nvcc in parallel, with ``-Xptxas
-v`` printed, held against the plain version at every shape (max |err|
<= 1e-3, in the variant's row-weight mode), and timed by CUDA-graph
replay, variant after variant, for ``--rounds`` rounds in one process.
Shapes, uint8 views padded to 512x640 (valid 480x636), 96x96 crops:

* N=4: frame 0's four slots (the sequential path, one launch a frame),
  as ``chip_smoke.kernel_inputs`` makes them (slot 3 looks down the
  optical axis), and the N=768 chunk's first four slots;
* N=96: those slots jittered 24 times (the non-pipelined lockstep frame);
* N=768: the pipelined lockstep chunk, 24 recordings x 8 frames x 4
  slots, recording r at frames r..r+7 of one 31-frame scene, each sample
  with its own four views (768 views, 252 MB).

Prints the card as ``nvidia-smi`` names it, each build's ptxas lines,
``grid_sample``'s and the byte bound's us at each shape, and one JSON
line a variant and shape (device us: the minimum and the median over
rounds). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from absolutetrack_tpu_torch.ops import warp_kernel  # noqa: E402

# (name, substitutions of the committed source, fourth C argument: pixels
# a crop row, int8 rows)
_WARPS = [("constexpr int kWarps = 4;", "constexpr int kWarps = %d;" % w) for w in (2, 8)]
_FEW = "constexpr int64_t kFewPixels = 1 << 20;"
_ALWAYS_4PX = (_FEW, _FEW.replace("1 << 20", "0"))
_ALWAYS_2PX = (_FEW, _FEW.replace("1 << 20", "INT64_MAX"))
_STREAMING_HINTS = [
    ("x[k] = in ? a.xs[base + i] : -1.f;", "x[k] = in ? __ldcs(a.xs + base + i) : -1.f;"),
    ("y[k] = in ? a.ys[base + i] : -1.f;", "y[k] = in ? __ldcs(a.ys + base + i) : -1.f;"),
    ("a.out[base + i] = valid[k] ? acc : 0.f;", "__stcs(a.out + base + i, valid[k] ? acc : 0.f);"),
]
# the slot's view resolved once a block, through a shared word and a barrier
_VIEW_PER_BLOCK = [
    (
        """    int64_t v = __ldg(a.image_idx + slot);  // one broadcast load a warp
    if (v < 0) v += a.n_views;
    v = v < 0 ? 0 : (v >= a.n_views ? a.n_views - 1 : v);
    const Raw* view = src + v * a.view_stride;""",
        """    __shared__ int64_t view_base;
    if (threadIdx.x == 0) {
      int64_t v = __ldg(a.image_idx + slot);
      if (v < 0) v += a.n_views;
      v = v < 0 ? 0 : (v >= a.n_views ? a.n_views - 1 : v);
      view_base = v * a.view_stride;
    }
    __syncthreads();
    const Raw* view = src + view_base;""",
    ),
    (
        "a.out[base + i] = valid[k] ? acc : 0.f;\n    }\n",
        "a.out[base + i] = valid[k] ? acc : 0.f;\n    }\n"
        "    if (slot + gridDim.y < a.n) __syncthreads();\n",
    ),
]
CROP_W = 96
VARIANTS = [
    ("patch", [], CROP_W, 0),
    ("patch_int8", [], CROP_W, 1),
    ("patch_flat", [], 8, 0),
    ("patch_streaming_hints", _STREAMING_HINTS, CROP_W, 0),
    ("patch_view_per_block", _VIEW_PER_BLOCK, CROP_W, 0),
    ("patch_always_4px", [_ALWAYS_4PX], CROP_W, 0),
    ("patch_always_2px", [_ALWAYS_2PX], CROP_W, 0),
    ("patch_2warps", [_WARPS[0]], CROP_W, 0),
    ("patch_8warps", [_WARPS[1]], CROP_W, 0),
]


def variant_source(subs) -> str:
    text = warp_kernel.SOURCE.read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant substitution target missing: {old!r}")
        text = text.replace(old, new)
    return text


def build_all(sources: dict, out_dir: Path) -> dict:
    """nvcc every source at once; name -> loaded function."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        cmd = warp_kernel.nvcc_command(src, out_dir / f"lib{name}.so")
        cmd.insert(1, "-Xptxas=-v")
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
        fns[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so")).k1_bilinear_sample
        fns[name].restype = ctypes.c_int
    return fns


def chunk_inputs(seed: int = 1, device="cuda"):
    """The N=768 lockstep chunk: (views, view index, x, y) on ``device``."""
    from absolutetrack_tpu_torch.geometry import camera as cam
    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.ops.resample import _crop_source_coords_planar

    r, f = chip_smoke.LOCKSTEP_RECORDINGS, chip_smoke.LOCKSTEP_CHUNK
    crop = ModelConfig().input_size
    ts = chip_smoke.torch_scene(chip_smoke.build_scene(seed, n_frames=r + f - 1), device)
    per_frame = []
    for t in range(r + f - 1):
        idx, src, crop_cams = chip_smoke.slot_cameras(ts, t, crop)
        x, y = _crop_source_coords_planar(src, crop_cams, crop, cam.FISHEYE62, True)
        per_frame.append((idx, x, y))
    frame_of = [ri + fi for ri in range(r) for fi in range(f)]  # recording-major samples
    images = ts["frames"][frame_of].reshape((-1,) + chip_smoke.PAD_HW).contiguous()
    idx = torch.cat([per_frame[t][0] + 4 * s for s, t in enumerate(frame_of)])
    x = torch.cat([per_frame[t][1] for t in frame_of]).view(-1, crop[1], crop[0])
    y = torch.cat([per_frame[t][2] for t in frame_of]).view(-1, crop[1], crop[0])
    return images, idx, x, y


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier", type=Path, help="a K1 source with the signature before the int8 mode")
    ap.add_argument("--extra", action="append", default=[], help="NAME=PATH=ARG: a source with the current signature")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=ROOT / "tmp" / "k1_variants")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    sources = {name: variant_source(subs) for name, subs, _, _ in VARIANTS}
    calls = {name: (arg, int8) for name, _, arg, int8 in VARIANTS}
    for spec in args.extra:
        name, path, arg = spec.split("=")
        sources[name] = Path(path).read_text()
        calls[name] = (int(arg), 0)
    if args.earlier:
        sources["earlier"] = args.earlier.read_text()
    fns = build_all(sources, args.out)

    # N=4 and N=96 exactly as chip_smoke.py's kernel phase makes them
    ts = chip_smoke.torch_scene(chip_smoke.build_scene(0), "cuda")
    k = chip_smoke.kernel_inputs(ts, (CROP_W, CROP_W))
    views4 = ts["frames"][0].contiguous()
    chunk = chunk_inputs()
    shapes = {
        "n4": (views4, k["idx"], k["x4"], k["y4"]),
        # the chunk's first sample: four slots as the tracker makes them
        "n4_chunk": (chunk[0][:4].contiguous(), *(a[:4].contiguous() for a in chunk[1:])),
        "n96": (views4, k["idx96"], k["x96"], k["y96"]),
        "n768": chunk,
    }
    del ts
    h, w = chip_smoke.SRC_HW

    def caller(name, images, ii, xs, ys, out):
        v, hp, wp = images.shape
        n, p = xs.shape[0], xs[0].numel()
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        common = (ii.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(), v, hp * wp, wp, h, w, n, p)
        fn = fns[name]
        if name == "earlier":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + warp_kernel.ARGTYPES[4:]
            return lambda: fn(images.data_ptr(), 0, *common, stream())
        fn.argtypes = warp_kernel.ARGTYPES
        arg, int8 = calls[name]
        return lambda: fn(images.data_ptr(), 0, int8, arg, *common, stream())

    names = list(fns)
    times = {(nm, sh): [] for nm in names for sh in shapes}
    for shape, (images, ii, xs, ys) in shapes.items():
        want = {m: warp_kernel.bilinear_sample_plain(images, ii, (xs, ys), chip_smoke.SRC_HW, m) for m in (False, True)}
        outs = {}
        for name in names:
            out = torch.empty(xs.shape, device="cuda")
            launch = caller(name, images, ii, xs, ys, out)
            err = launch()
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"{name} at {shape}: launch error {err}")
            diff = float((out - want[name != "earlier" and bool(calls[name][1])]).abs().max())
            if not diff <= 1e-3:
                raise RuntimeError(f"{name} at {shape}: max |err| {diff}")
            outs[name] = (launch, out)
        iters = 40 if shape == "n768" else 100
        for _ in range(args.rounds):
            for name in names:
                times[(name, shape)].append(chip_smoke._device_ms(outs[name][0], iters) * 1e3)
        n, p = xs.shape[0], xs[0].numel()
        lib_in = images[ii, :h, :w].float()[:, None].contiguous()
        gx, gy = xs.reshape(n, 1, p), ys.reshape(n, 1, p)
        grid = torch.stack([gx / (w - 1) * 2 - 1, gy / (h - 1) * 2 - 1], -1).contiguous()
        lib = chip_smoke._device_ms(lambda: torch.nn.functional.grid_sample(
            lib_in, grid, mode="bilinear", padding_mode="zeros", align_corners=True), iters) * 1e3
        moved = chip_smoke.touched_source_bytes(images, ii, xs, ys, chip_smoke.SRC_HW) + ii.numel() * 8 + 3 * n * p * 4
        print(json.dumps({"shape": shape, "n": n, "p": p, "grid_sample_us": lib,
                          "bound_us": moved / chip_smoke.HBM_BYTES_PER_S * 1e6, "card": smi}), flush=True)
        del lib_in, grid, outs
        for name in names:
            t = times[(name, shape)]
            print(json.dumps({"variant": name, "shape": shape, "us_min": min(t),
                              "us_median": statistics.median(t), "us_rounds": t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
