"""The control: the reference in float8 e4m3 (the step below the served
bf16) put in the program's place fails a limit of each workload.

On the CPU at the workloads' own widths and upload size, one upload; on
the card (``cuda``) at the workload's sample size, on three seeds, by
``portbench.calibrate``'s readings."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import spec, synth
from portbench.compare import compare_cloud, judge, load_limits, reduce_numbers
from portbench.reference.pipeline import reference_cloud
from portbench.run import scale_and_density
from portbench.weights import make_state_dict

CELLS = [c["name"] for c in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_cpu(cell):
    w = spec.workload(cell)
    cfg, tr = w["config"], w["traffic"]
    scale, density = scale_and_density(tr)
    h, wd = tr.get("upload_hw") or tr["frame_hw"]
    seed = 2**31 + 101
    sd = {k: v.float() for k, v in make_state_dict(cfg, seed, "cpu", torch.bfloat16).items()}
    im = synth.frames(seed, 1, h, wd)[0]
    ref = reference_cloud(im, sd, cfg, depth_scale=scale, density=density)
    ctl = reference_cloud(im, sd, cfg, depth_scale=scale, density=density, fp8=True)
    correct, checks = judge(reduce_numbers([compare_cloud(ctl.points[ctl.keep], ctl.colors[ctl.keep],
                                                          ref, scale)]),
                            load_limits(spec.HERE, cell))
    assert correct is False, checks
    # The reference against itself passes, at the codec's rounding.
    same, _ = judge(reduce_numbers([compare_cloud(ref.points[ref.keep], ref.colors[ref.keep], ref, scale)]),
                    load_limits(spec.HERE, cell))
    assert same is True


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cuda_card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.calibrate", "--workload", cell, "--control-only",
                          "--seeds", "2147483911", "2147483912", "2147483913"],
                         cwd=spec.ROOT, capture_output=True, text=True, check=True)
    limits = load_limits(spec.HERE, cell)
    for line in out.stdout.splitlines():
        correct, checks = judge(json.loads(line)["control"], limits)
        assert correct is False, checks
