"""Offline CLI of the PyTorch package: image → point cloud or mesh files, no
HTTP needed.

Counterpart of ``image_to_pointcloud_tpu/cli.py``:

    python -m image_to_pointcloud_tpu_torch convert photo.jpg -o cloud.ply
    python -m image_to_pointcloud_tpu_torch convert *.jpg --format las --density high
    python -m image_to_pointcloud_tpu_torch mesh photo.jpg -o mesh.ply
    python -m image_to_pointcloud_tpu_torch highres big.png --tile 518 --overlap 128
    python -m image_to_pointcloud_tpu_torch metric photo.jpg --fov 70
    python -m image_to_pointcloud_tpu_torch video a.png b.png -o fused.ply [--voxel 0.05]
    python -m image_to_pointcloud_tpu_torch serve --port 8077   # → serve/__main__

Models run on the card (``--device cuda``, bf16, the CUDA kernels) unless
``--device cpu`` asks for the CPU (f32, the plain versions); ``--int8``
serves the int8 W8A8 encoder, as ``IPC_TPU_INT8=1`` does. Same-size inputs
go through one batch. ``train`` and ``convert-ckpt`` are refused: they
need ``train/``, which is not ported yet.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

_NOT_PORTED = ("needs train/, which is not ported to the PyTorch package yet "
               "(see ROADMAP.md)")


def _add_runtime(p: argparse.ArgumentParser) -> None:
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (bf16, the CUDA kernels; the default) or 'cpu' "
                   "(f32, the plain versions)")
    p.add_argument("--int8", action="store_true", default=None,
                   help="int8 W8A8 encoder matmuls (default: IPC_TPU_INT8)")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("images", nargs="+", help="input image file(s)")
    p.add_argument("-o", "--output", default=None,
                   help="output file (single input) or directory")
    p.add_argument("--model", default="depth-anything-v2")
    p.add_argument("--density", default="medium", choices=["low", "medium", "high"])
    p.add_argument("--depth-scale", type=float, default=10.0)
    p.add_argument("--invert-depth", action="store_true", default=True)
    p.add_argument("--no-invert-depth", dest="invert_depth", action="store_false")
    p.add_argument("--smooth-depth", action="store_true")
    p.add_argument("--fov", type=float, default=None,
                   help="horizontal field of view in degrees (default: the "
                   "reference's max(h,w)*1.2 focal heuristic)")
    _add_runtime(p)


def _load_pipeline(args):
    from image_to_pointcloud_tpu_torch.serve.models import ModelManager

    return ModelManager(args.device, checkpoint_dir=args.checkpoint_dir, int8=args.int8).get(
        args.model)


def _decode_all(paths):
    from image_to_pointcloud_tpu_torch.io import decode_image_rgb

    return [decode_image_rgb(Path(p).read_bytes()) for p in paths]


def _out_path(args, src: Path, ext: str, multi: bool) -> Path:
    if args.output is None:
        return src.with_suffix(ext)
    out = Path(args.output)
    if multi or out.is_dir():
        out.mkdir(parents=True, exist_ok=True)
        cand = out / (src.stem + ext)
        # Inputs sharing a stem (dir1/0001.png dir2/0001.png) must not
        # clobber each other in the output directory.
        used = getattr(args, "_assigned_outputs", None)
        if used is None:
            used = args._assigned_outputs = set()
        n = 1
        while cand in used:
            cand = out / f"{src.stem}_{n}{ext}"
            n += 1
        used.add(cand)
        return cand
    return out


def _options(args):
    from image_to_pointcloud_tpu_torch.pipeline.graph import PipelineOptions

    return PipelineOptions(density=args.density, invert_depth=args.invert_depth,
                           smooth_depth=args.smooth_depth, fov=args.fov)


def cmd_convert(args) -> int:
    from collections import defaultdict

    import numpy as np

    from image_to_pointcloud_tpu_torch.io import (
        glb_bytes,
        write_las,
        write_pcd,
        write_ply_points,
        write_xyz,
    )

    def write_glb_points(path, pts, cols):
        with open(path, "wb") as f:
            f.write(glb_bytes(pts, None, colors01=np.clip(cols / 255.0, 0, 1), name="pointcloud"))
        return path

    writers = {"ply": write_ply_points, "las": write_las, "laz": write_las,
               "xyz": write_xyz, "pcd": write_pcd, "glb": write_glb_points}
    fmt = args.format
    if fmt is None:
        # Inferred from the -o extension; an explicit --format wins.
        suffix = Path(args.output).suffix.lower().lstrip(".") if args.output else ""
        fmt = suffix if suffix in writers else "ply"
    writer = writers[fmt]
    ext = ".las" if fmt == "laz" else f".{fmt}"

    pipe = _load_pipeline(args)
    opts = _options(args)
    paths = [Path(p) for p in args.images]
    imgs = _decode_all(paths)
    multi = len(paths) > 1

    # Same-shape images go through one batch.
    groups: dict[tuple, list[int]] = defaultdict(list)
    for i, im in enumerate(imgs):
        groups[im.shape].append(i)
    t0 = time.perf_counter()
    results: dict[int, object] = {}
    for idxs in groups.values():
        outs = pipe.run_batch([imgs[i] for i in idxs], depth_scales=args.depth_scale,
                              options=opts, want_preview=False, want_packed=False)
        results.update(zip(idxs, outs))
    dt = time.perf_counter() - t0

    total_pts = 0
    for i, src in enumerate(paths):
        r = results[i]
        out = _out_path(args, src, ext, multi)
        if fmt == "laz" and out.suffix.lower() == ".laz":
            # The LAZ slot writes uncompressed LAS bytes (as the
            # reference does); a .laz name would pick a LAZ decompressor.
            out = out.with_suffix(".las")
            print(f"note: laz writes uncompressed LAS; output is {out}")
        writer(str(out), r.points, r.colors)
        total_pts += len(r.points)
        print(f"{src} -> {out}  ({len(r.points)} points)")
    print(f"{len(paths)} image(s), {total_pts} points in {dt:.2f}s ({len(paths) / dt:.1f} img/s)")
    return 0


def cmd_mesh(args) -> int:
    from image_to_pointcloud_tpu_torch.io import write_ply_mesh
    from image_to_pointcloud_tpu_torch.pipeline.meshing import (
        grid_mesh_from_packed,
        reconstruct_cloud,
        vertex_normals,
    )

    pipe = _load_pipeline(args)
    opts = _options(args)
    paths = [Path(p) for p in args.images]
    multi = len(paths) > 1
    for src, im in zip(paths, _decode_all(paths)):
        r = pipe.run(im, depth_scale=args.depth_scale, options=opts, want_preview=False)
        if args.method == "grid":
            verts, vcols, faces, _ = grid_mesh_from_packed(r.packed, r.grid_hw)
        else:
            # The reference's Open3D algorithms (poisson, bpa) and the SDF
            # fallback, in the native library.
            rec = reconstruct_cloud(r.points, r.colors, method=args.method,
                                    depth=args.poisson_depth, orient="camera")
            if rec is None:
                print(f"{src}: {args.method} reconstruction failed", file=sys.stderr)
                return 1
            verts, vcols, faces = rec
        out = _out_path(args, src, ".ply", multi)
        write_ply_mesh(str(out), verts, faces, colors=vcols, normals=vertex_normals(verts, faces))
        print(f"{src} -> {out}  ({len(verts)} verts, {len(faces)} tris)")
    return 0


def cmd_video(args) -> int:
    """Frames → one batched depth forward → one fused cloud."""
    import numpy as np

    from image_to_pointcloud_tpu_torch.io import write_ply_points
    from image_to_pointcloud_tpu_torch.ops.unproject import DENSITY_STRIDES
    from image_to_pointcloud_tpu_torch.pipeline.advanced import VideoPipeline

    base = _load_pipeline(args)
    vp = VideoPipeline(base.model, model_target=base.model_target)
    frames = np.stack(_decode_all([Path(p) for p in args.frames]))
    t0 = time.perf_counter()
    pts, cols = vp.run(frames, depth_scale=args.depth_scale, step=DENSITY_STRIDES[args.density],
                       fuse_voxel=args.voxel)
    write_ply_points(args.output, pts, cols)
    print(f"{len(frames)} frames -> {args.output}  ({len(pts)} fused points, "
          f"{time.perf_counter() - t0:.2f}s)")
    return 0


def cmd_highres(args) -> int:
    """Tiled high-resolution depth + a voxel budget."""
    from image_to_pointcloud_tpu_torch.io import write_ply_points
    from image_to_pointcloud_tpu_torch.pipeline.advanced import HighResPipeline

    base = _load_pipeline(args)
    hp = HighResPipeline(base.model, tile=args.tile, overlap=args.overlap,
                         model_target=base.model_target)
    paths = [Path(p) for p in args.images]
    multi = len(paths) > 1
    for src, im in zip(paths, _decode_all(paths)):
        t0 = time.perf_counter()
        pts, cols = hp.run(im, depth_scale=args.depth_scale, voxel_budget=args.voxel_budget)
        out = _out_path(args, src, ".ply", multi)
        write_ply_points(str(out), pts, cols)
        print(f"{src} -> {out}  ({len(pts)} points, {time.perf_counter() - t0:.2f}s)")
    return 0


def cmd_metric(args) -> int:
    """Metric depth with real camera intrinsics."""
    from image_to_pointcloud_tpu_torch.io import write_ply_points
    from image_to_pointcloud_tpu_torch.pipeline.advanced import CameraIntrinsics, MetricPipeline

    if args.fx is None and any(v is not None for v in (args.fy, args.cx, args.cy)):
        print("error: --fy/--cx/--cy require --fx (otherwise the FOV heuristic would "
              "silently discard them)", file=sys.stderr)
        return 2
    base = _load_pipeline(args)
    mp = MetricPipeline(base.model, model_target=base.model_target)
    paths = [Path(p) for p in args.images]
    multi = len(paths) > 1
    for src, im in zip(paths, _decode_all(paths)):
        h, w = im.shape[:2]
        if args.fx is not None:
            intr = CameraIntrinsics(
                fx=args.fx, fy=args.fy or args.fx,
                cx=args.cx if args.cx is not None else w / 2.0,
                cy=args.cy if args.cy is not None else h / 2.0,
            )
        else:
            intr = CameraIntrinsics.from_fov(h, w, args.fov)
        pts, cols = mp.run(im, intr)
        out = _out_path(args, src, ".ply", multi)
        write_ply_points(str(out), pts, cols)
        print(f"{src} -> {out}  ({len(pts)} metric points)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="image_to_pointcloud_tpu_torch",
        description="image→point-cloud CLI on PyTorch (CUDA)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    pc = sub.add_parser("convert", help="image(s) → point cloud file(s)")
    _add_common(pc)
    pc.add_argument("--format", default=None, choices=["ply", "las", "laz", "xyz", "pcd", "glb"],
                    help="output format (default: inferred from the -o file extension, else ply)")
    pc.set_defaults(fn=cmd_convert)

    pm = sub.add_parser("mesh", help="image(s) → surface mesh PLY")
    _add_common(pm)
    pm.add_argument("--method", default="grid", choices=["grid", "poisson", "bpa", "sdf"],
                    help="grid: exact depth-grid triangulation (default); poisson/bpa: "
                    "the reference's Open3D algorithms, native reimplementations; sdf: "
                    "fast implicit fallback")
    pm.add_argument("--poisson-depth", type=int, default=8,
                    help="grid resolution exponent for poisson/sdf (reference depth=8)")
    pm.set_defaults(fn=cmd_mesh)

    ph = sub.add_parser("highres", help="tiled high-resolution depth → cloud with a voxel budget")
    ph.add_argument("images", nargs="+")
    ph.add_argument("-o", "--output", default=None)
    ph.add_argument("--model", default="depth-anything-v2")
    ph.add_argument("--depth-scale", type=float, default=10.0)
    ph.add_argument("--tile", type=int, default=518)
    ph.add_argument("--overlap", type=int, default=128)
    ph.add_argument("--voxel-budget", type=int, default=1_000_000)
    _add_runtime(ph)
    ph.set_defaults(fn=cmd_highres)

    pme = sub.add_parser("metric",
                         help="metric depth with real camera intrinsics → metric-scale cloud")
    pme.add_argument("images", nargs="+")
    pme.add_argument("-o", "--output", default=None)
    pme.add_argument("--model", default="zoedepth-small",
                     help="a metric-head preset (zoedepth[-small], depth-anything-v2-metric-*)")
    pme.add_argument("--fx", type=float, default=None)
    pme.add_argument("--fy", type=float, default=None)
    pme.add_argument("--cx", type=float, default=None)
    pme.add_argument("--cy", type=float, default=None)
    pme.add_argument("--fov", type=float, default=60.0, help="used when fx/fy/cx/cy are not given")
    _add_runtime(pme)
    pme.set_defaults(fn=cmd_metric)

    pv = sub.add_parser("video", help="frame sequence → one fused point cloud")
    pv.add_argument("frames", nargs="+", help="ordered frame images")
    pv.add_argument("-o", "--output", default="video_cloud.ply")
    pv.add_argument("--model", default="depth-anything-v2")
    pv.add_argument("--density", default="medium", choices=["low", "medium", "high"])
    pv.add_argument("--depth-scale", type=float, default=10.0)
    pv.add_argument("--voxel", type=float, default=None,
                    help="fuse with voxel-grid downsampling at this cell size")
    _add_runtime(pv)
    pv.set_defaults(fn=cmd_video)

    # The JAX CLI's training commands: on the command line, refused.
    for name, text in (("train", "fine-tune a depth model"),
                       ("convert-ckpt", "HF safetensors weights → a serving checkpoint")):
        sub.add_parser(name, help=f"{text} (not ported)", add_help=False).set_defaults(fn=None)
    ps = sub.add_parser("serve", help="run the HTTP service", add_help=False)
    ps.set_defaults(fn=None)

    args, rest = parser.parse_known_args(argv)
    if args.command in ("train", "convert-ckpt"):
        parser.error(f"{args.command} {_NOT_PORTED}")
    if args.command == "serve":
        from image_to_pointcloud_tpu_torch.serve.__main__ import main as serve_main

        sys.argv = ["serve", *rest]
        serve_main()
        return 0
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
