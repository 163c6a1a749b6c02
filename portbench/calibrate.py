"""Readings that set a workload's limits (``portbench/limits/``): per seed,
the program's numbers (the workload's pipeline entry at its batch and
size, on the workload's sampled uploads) and the control's (the
reference in float8 e4m3 in the program's place), each against the f32
reference, in one process.

    python3 -m portbench.calibrate --workload dptl-bulk --seeds 11 12 13 [--control-only]

Prints one JSON line a seed: {"seed", "program": {number: value},
"control": {number: value}}. The runs of ``portbench.run`` give the timed
path's own readings besides.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--control-only", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from portbench import spec, synth
    from portbench.compare import compare_cloud, reduce_numbers
    from portbench.reference.pipeline import reference_cloud
    from portbench.run import scale_and_density
    from portbench.weights import make_state_dict, seeded_manager

    w = spec.workload(args.workload)
    cfg, tr = w["config"], w["traffic"]
    scale, density = scale_and_density(tr)
    h, wd = tr.get("upload_hw") or tr["frame_hw"]
    dtype = getattr(torch, cfg["dtype"])
    for seed in args.seeds:
        imgs = synth.frames(seed, args.images, h, wd)
        if "jpeg_quality" in tr:
            imgs = [synth.decode(synth.jpeg(im, tr["jpeg_quality"])) for im in imgs]
        out = {"seed": seed}
        if not args.control_only:
            from image_to_pointcloud_tpu_torch.pipeline.graph import PipelineOptions

            pipe = seeded_manager(make_state_dict(cfg, seed, "cuda", dtype), "cuda",
                                  model_target=cfg["preprocess"]["target"]).get(cfg["preset"])
            batch = tr.get("batch", 1)
            opts = PipelineOptions(**tr.get("options", {"density": density}))
            served = []
            for i in range(0, len(imgs), batch):
                chunk = imgs[i:i + batch]
                chunk += [chunk[-1]] * (batch - len(chunk))
                res = pipe.collect(pipe.submit_batch(chunk, depth_scales=[scale] * batch, options=opts),
                                   want_packed=False, want_preview_rgb=False)
                served += [(r.points, r.colors) for r in res]
            del pipe
            torch.cuda.empty_cache()
        sd = {k: v.float() for k, v in make_state_dict(cfg, seed, "cuda", dtype).items()}
        prog, ctl = [], []
        for k, im in enumerate(imgs):
            ref = reference_cloud(im, sd, cfg, depth_scale=scale, density=density)
            c = reference_cloud(im, sd, cfg, depth_scale=scale, density=density, fp8=True)
            ctl.append(compare_cloud(c.points[c.keep], c.colors[c.keep].astype(np.float32), ref, scale))
            if not args.control_only:
                prog.append(compare_cloud(*served[k], ref, scale))
        if prog:
            out["program"] = reduce_numbers(prog)
        out["control"] = reduce_numbers(ctl)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
