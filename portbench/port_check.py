"""The port check: where a configuration and the port's preset it names
part. Beside the reference, not in it: the reference imports nothing of
the port, and this reads the port's preset and builds its model on the
meta device."""

from __future__ import annotations

import functools

from portbench.reference.model import family, param_specs


def _plain(v):
    """Sequences as tuples, all the way down, so a list from a JSON file
    compares equal to the port's tuple."""
    return tuple(_plain(x) for x in v) if isinstance(v, (list, tuple)) else v


def port_mismatches(cfg: dict) -> list[str]:
    """Every parameter of ``param_specs`` against the served state dict,
    name for name and shape for shape, then every field of the family's
    ``port_fields`` against the preset config. Empty where they agree."""
    import torch

    from image_to_pointcloud_tpu_torch.models.depth_anything import build_model, preset

    pcfg = preset(cfg["preset"])
    with torch.device("meta"):
        model = build_model(pcfg)
    ours = {n: tuple(s) for n, s, _, _ in param_specs(cfg["arch"])}
    theirs = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    bad = [f"parameter {n}: {ours.get(n)} here, {theirs.get(n)} in the port"
           for n in sorted(ours.keys() | theirs.keys()) if ours.get(n) != theirs.get(n)]
    for path, want in family(cfg["arch"]).port_fields(cfg):
        got = functools.reduce(getattr, path.split("."), pcfg)
        if _plain(got) != _plain(want):
            bad.append(f"{path}: {want!r} here, {got!r} in the port")
    return bad
