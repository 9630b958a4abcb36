#!/usr/bin/env python3
"""Where a rasterized frame's time goes on a CUDA card, stage by stage.

    python scripts/profile_render_prep.py                  # PickCube-v1 rgb @2048, DrawTriangle-v1 rgb @512
    python scripts/profile_render_prep.py --cells pickcube,rotatevalve,drawtriangle,cartpole --steps 2

For each cell it builds the rgb env, resets it and steps it twice, then, on
its first camera:

1. runs ``--steps`` env steps under torch.profiler with every stage of the
   tiled render path labelled (``record_function``): ``world_vertices``,
   ``_screen_faces``, ``_face_rgb``, ``tiled_inputs`` (both of those and
   the back-face cull), ``face_records``, ``bin_faces``, ``raster_setup``
   (where the tree has it), ``raster_tiles``, ``_finish``,
   ``rasterize_tiles`` and ``rasterize`` (each holding the stages under
   it) and ``obs_from_buffer``; prints each label's device and host ms per
   step, the device ms of each ``raster_*_kernel`` (a ctypes launch is
   under no torch operator, so the profiler gives its label no device
   time), and the step's device kernel ms and launches;
2. times each stage alone on the last frame's inputs with CUDA events,
   ``bin_faces`` split into its mask, its sort and its count.

Prints every number beside the card's name and power limit, and writes
them to ``chiprun_out/render_prep.json``. Runs on the tree it is in: the
stages that tree lacks are left out.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CELLS = {
    # name: (env id, envs)
    "pickcube": ("PickCube-v1", 2048),
    "rotatevalve": ("RotateValveLevel2-v1", 2048),
    "drawtriangle": ("DrawTriangle-v1", 512),
    "cartpole": ("CartpoleBalanceBenchmark-v1", 1024),
}


def labelled(fn, label):
    import torch

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return wrapper


def patch_labels():
    """Wrap every stage of the render path in a profiler label."""
    from maniskill_tpu_torch.render import rasterizer, tiled_rasterizer as tr
    from maniskill_tpu_torch.sensors import camera

    rasterizer.SceneMesh.world_vertices = labelled(rasterizer.SceneMesh.world_vertices, "world_vertices")
    for name in ("_screen_faces", "_face_rgb", "tiled_inputs"):
        setattr(rasterizer, name, labelled(getattr(rasterizer, name), name))
    for name in ("face_records", "bin_faces", "_finish"):
        setattr(tr, name, labelled(getattr(tr, name), name))
    rasterizer.rasterize_tiles = labelled(rasterizer.rasterize_tiles, "rasterize_tiles")
    camera.rasterize = labelled(camera.rasterize, "rasterize")
    camera.Camera.obs_from_buffer = labelled(camera.Camera.obs_from_buffer, "obs_from_buffer")
    type(tr.KERNEL).__call__ = labelled(type(tr.KERNEL).__call__, "raster_tiles")
    if hasattr(tr, "SETUP"):
        type(tr.SETUP).__call__ = labelled(type(tr.SETUP).__call__, "raster_setup")


LABELS = ("world_vertices", "_screen_faces", "_face_rgb", "tiled_inputs", "face_records", "bin_faces",
          "raster_setup", "raster_tiles", "_finish", "rasterize_tiles", "rasterize", "obs_from_buffer")


def profile_steps(torch, env, action, n):
    """Per-label (device ms, host ms, calls) per step, and the step's kernel
    ms, launches and host ms, from torch.profiler over ``n`` steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from maniskill_tpu_torch.utils.timing import device_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            env.step(action)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    out = {}
    for e in events:
        if e.key in LABELS and e.device_type != DeviceType.CUDA:
            dev_total = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            out[e.key] = dict(device_ms=dev_total / 1e3 / n, host_ms=e.cpu_time_total / 1e3 / n,
                              calls=e.count / n)
    # device records: the kernels, and each label's span on the device (left out)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in LABELS
               and not e.key.startswith(("Memcpy", "Memset"))]
    for e in kernels:
        name = re.search(r"raster_\w+_kernel", e.key)
        if name:
            out[name.group()] = dict(device_ms=device_us(e) / 1e3 / n, host_ms=0.0, calls=e.count / n)
    step = dict(
        wall_ms=wall_ms / n,
        device_kernel_ms=sum(device_us(e) for e in kernels) / 1e3 / n,
        launches=sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                           "cudaLaunchKernelExC")) / n,
    )
    return out, step


def stage_times(torch, base, cam, reps):
    """Each stage alone on the current frame's inputs: mean ms (CUDA events)."""
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import rasterizer, tiled_rasterizer as tr
    from maniskill_tpu_torch.utils.timing import cuda_ms

    H, W = cam.config.height, cam.config.width
    mesh = cam._get_mesh(tuple(base._hidden_objects))
    gpos, gquat = geom_poses(base.scene.model, base.scene.data)
    wv = mesh.world_vertices(gpos, gquat)
    view, lights = cam._view_matrix(), base.scene.lights
    inputs = rasterizer.tiled_inputs(mesh, wv, view, cam.proj, H, W, lights=lights)
    fx, fy = inputs[0], inputs[1]
    table, valid = tr.face_records(*inputs)

    def mask():
        T = -(-H // tr.TILE_H)
        ymin, ymax = fy.amin(-1), fy.amax(-1)
        xmin, xmax = fx.amin(-1), fx.amax(-1)
        on_screen = valid & (xmax >= 0) & (xmin < W) & (ymax >= 0) & (ymin < H)
        bands = torch.arange(T, dtype=torch.float32, device=fx.device)[None, :, None] * tr.TILE_H
        return on_screen[:, None, :] & (ymax[:, None, :] >= bands) & (ymin[:, None, :] < bands + tr.TILE_H)

    overlap = mask()
    idx, counts, dropped = tr.bin_faces(fx, fy, valid, H, W)
    launches = (tr.KERNEL.launches, getattr(getattr(tr, "SETUP", None), "launches", 0))
    iz, seg, rgb = tr.KERNEL(table, idx, counts, H, W)
    buf = rasterizer.rasterize(mesh, wv, view, cam.proj, H, W, lights=lights)
    stages = {
        "world_vertices": lambda: mesh.world_vertices(gpos, gquat),
        "_screen_faces": lambda: rasterizer._screen_faces(mesh, wv, view, cam.proj, H, W),
        "_face_rgb": lambda: rasterizer._face_rgb(mesh, wv, lights),
        "tiled_inputs": lambda: rasterizer.tiled_inputs(mesh, wv, view, cam.proj, H, W, lights=lights),
        "face_records": lambda: tr.face_records(*inputs),
        "bin_faces": lambda: tr.bin_faces(fx, fy, valid, H, W),
        "bin_faces: mask": mask,
        "bin_faces: sort": lambda: torch.argsort((~overlap).to(torch.uint8), dim=-1, stable=True).to(torch.int32),
        "bin_faces: count": lambda: overlap.sum(-1, dtype=torch.int32),
        "raster_tiles": lambda: tr.KERNEL(table, idx, counts, H, W),
        "_finish": lambda: tr._finish(iz, seg, rgb, dropped),
        "rasterize_tiles": lambda: tr.rasterize_tiles(*inputs, H, W),
        "rasterize": lambda: rasterizer.rasterize(mesh, wv, view, cam.proj, H, W, lights=lights),
        "obs_from_buffer": lambda: cam.obs_from_buffer(buf),
        "camera get_obs": lambda: cam.get_obs(hidden_actors=tuple(base._hidden_objects)),
    }
    if hasattr(tr, "SETUP"):
        stages["raster_setup"] = lambda: tr.SETUP(*inputs, H, W)
    times = {name: cuda_ms(fn, reps) for name, fn in stages.items()}
    tr.KERNEL.launches = launches[0]
    if hasattr(tr, "SETUP"):
        tr.SETUP.launches = launches[1]
    shape = dict(envs=int(fx.shape[0]), faces=int(fx.shape[1]), height=H, width=W,
                 live_entries_per_band=float(counts.float().mean()), fullest_band=int(counts.max()))
    return times, shape


def main(argv=None):
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.render import tiled_rasterizer as tr

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", default="pickcube,drawtriangle")
    p.add_argument("--steps", type=int, default=3, help="profiled env steps per cell")
    p.add_argument("--reps", type=int, default=10, help="timed calls per stage")
    p.add_argument("--out", default="chiprun_out/render_prep.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    card = f"[{smi}]"
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda")
    for k in (tr.KERNEL, getattr(tr, "SETUP", None)):
        if k is not None:
            k.build()
    patch_labels()
    results = {"card": smi}
    for cell in args.cells.split(","):
        uid, n_envs = CELLS[cell]
        env = make(uid, num_envs=n_envs, obs_mode="rgb", device=dev)
        base = env.unwrapped
        action = torch.zeros((n_envs,) + tuple(base.single_action_space.shape), device=dev)
        cam_uid = next(iter(base._sensors))
        env.reset(seed=0)
        for _ in range(2):
            env.step(action)
        labels, step = profile_steps(torch, env, action, args.steps)
        times, shape = stage_times(torch, base, base._sensors[cam_uid], args.reps)
        results[cell] = dict(env=uid, **shape, profiled_steps=args.steps, step=step, labels=labels,
                             alone_ms=times)
        print(f"{uid} rgb x{n_envs} ({shape['height']}x{shape['width']}, {shape['faces']} faces, "
              f"{shape['live_entries_per_band']:.1f} live entries per band, fullest {shape['fullest_band']}) "
              f"{card}")
        print(f"  step under the profiler: {step['wall_ms']:.2f} ms wall, {step['device_kernel_ms']:.3f} ms of "
              f"device kernels, {step['launches']:.0f} launches")
        for name, e in labels.items():
            print(f"  profiled {name:18s} device {e['device_ms']:9.4f} ms  host {e['host_ms']:9.3f} ms  "
                  f"calls {e['calls']:.1f} per step")
        for name, ms in times.items():
            print(f"  alone    {name:18s} {ms:9.4f} ms (CUDA events, {args.reps} calls)")
        del env, base
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"written": args.out}))


if __name__ == "__main__":
    main()
