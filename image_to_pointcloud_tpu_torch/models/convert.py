"""HF checkpoints → the port's ``state_dict``, and a safetensors reader.

Counterpart of ``image_to_pointcloud_tpu/models/convert.py``. An HF state
dict (``Depth-Anything-V2-*-hf``, ``Intel/dpt-large``,
``Intel/zoedepth-nyu-kitti`` layouts, and ``SegformerForSemanticSegmentation``
for the v2 matte) is first mapped onto the JAX package's Flax parameter
tree as numpy arrays, the same name map as the JAX converters, and then
through :func:`.bridge.state_dict_from_flax`; so one map per family serves
both the checkpoint path and the parity tests.
The layout changes on the way to Flax:

* Linear ``(out, in)`` → kernel ``(in, out)``,
* Conv OIHW → HWIO,
* ConvTranspose(k=s) ``(in, out, k, k)`` → matmul kernel ``(k, k, in, out)``,
* the patch conv → the flattened patchify kernel ``(p·p·3, D)`` in (row,
  column, channel) order.

:func:`load_safetensors` reads the file format itself (F32, F16, BF16,
I64), with no ``safetensors`` package.
"""

from __future__ import annotations

import json
from typing import Mapping

import numpy as np
import torch

from image_to_pointcloud_tpu_torch.models.bridge import state_dict_from_flax
from image_to_pointcloud_tpu_torch.models.dpt_classic import DPTClassicConfig
from image_to_pointcloud_tpu_torch.models.zoedepth import ZoeDepthConfig

__all__ = [
    "convert_checkpoint",
    "convert_depth_anything",
    "convert_dpt_classic",
    "convert_segformer",
    "convert_zoedepth",
    "load_safetensors",
]

# The float weights, and I64 for the BatchNorm step counters
# (``num_batches_tracked``) that HF SegFormer checkpoints carry.
_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "I64": torch.int64}


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Read a ``.safetensors`` file into CPU tensors: an 8-byte
    little-endian header length, a JSON header of ``{name: {dtype, shape,
    data_offsets}}`` (offsets relative to the end of the header), then the
    raw little-endian buffers."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8 : 8 + n])
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        dtype = _DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // dtype.itemsize
        t = (
            torch.frombuffer(data, dtype=dtype, count=count, offset=8 + n + start)
            if count
            else torch.empty(0, dtype=dtype)
        )
        # frombuffer views the file's bytes: clone so each tensor owns its
        # memory.
        out[name] = t.reshape(info["shape"]).clone()
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().float().numpy()  # bf16 has no numpy dtype


def _dense(sd, name):
    return {"kernel": _np(sd[f"{name}.weight"]).T, "bias": _np(sd[f"{name}.bias"])}


def _conv(sd, name, bias=True):
    out = {"kernel": _np(sd[f"{name}.weight"]).transpose(2, 3, 1, 0)}
    if bias:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def _convtrans(sd, name):
    return {
        "kernel": _np(sd[f"{name}.weight"]).transpose(2, 3, 0, 1),
        "bias": _np(sd[f"{name}.bias"]),
    }


def _ln(sd, name):
    return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


def _patch(sd, prefix) -> dict:
    w = _np(sd[f"{prefix}.patch_embeddings.projection.weight"])
    p, d = w.shape[-1], w.shape[0]
    return {
        "cls_token": _np(sd[f"{prefix}.cls_token"]),
        "patch_embed": w.transpose(2, 3, 1, 0).reshape(p * p * 3, d),
        "patch_bias": _np(sd[f"{prefix}.patch_embeddings.projection.bias"]),
    }


def _reassemble(sd, tree: dict, readout: bool) -> None:
    for i in range(4):
        pre = f"neck.reassemble_stage.layers.{i}"
        if readout:
            tree[f"readout{i}"] = _dense(sd, f"neck.reassemble_stage.readout_projects.{i}.0")
        tree[f"proj{i}"] = _conv(sd, f"{pre}.projection")
        if i in (0, 1):
            tree[f"up{i}"] = _convtrans(sd, f"{pre}.resize")
        elif i == 3:
            tree["down3"] = _conv(sd, f"{pre}.resize")


def _convs_and_fusion(sd, tree: dict) -> None:
    for i in range(4):
        tree[f"conv{i}"] = _conv(sd, f"neck.convs.{i}", bias=False)
    for j in range(4):
        pre = f"neck.fusion_stage.layers.{j}"
        tree[f"fusion{j}"] = {
            "projection": _conv(sd, f"{pre}.projection"),
            "res2": {
                "conv1": _conv(sd, f"{pre}.residual_layer2.convolution1"),
                "conv2": _conv(sd, f"{pre}.residual_layer2.convolution2"),
            },
        }
        if j > 0:
            # layers.0's residual_layer1 is checkpoint dead weight: the
            # deepest fusion stage has no residual input.
            tree[f"fusion{j}"]["res1"] = {
                "conv1": _conv(sd, f"{pre}.residual_layer1.convolution1"),
                "conv2": _conv(sd, f"{pre}.residual_layer1.convolution2"),
            }


def convert_depth_anything(sd: Mapping, num_layers: int) -> dict:
    """Flax-layout numpy tree from an HF DepthAnything state dict."""
    backbone = {
        **_patch(sd, "backbone.embeddings"),
        "pos_embed": _np(sd["backbone.embeddings.position_embeddings"]),
        "norm": _ln(sd, "backbone.layernorm"),
    }
    for i in range(num_layers):
        pre = f"backbone.encoder.layer.{i}"
        backbone[f"block{i}"] = {
            "norm1": _ln(sd, f"{pre}.norm1"),
            "q": _dense(sd, f"{pre}.attention.attention.query"),
            "k": _dense(sd, f"{pre}.attention.attention.key"),
            "v": _dense(sd, f"{pre}.attention.attention.value"),
            "proj": _dense(sd, f"{pre}.attention.output.dense"),
            "ls1": _np(sd[f"{pre}.layer_scale1.lambda1"]),
            "norm2": _ln(sd, f"{pre}.norm2"),
            "mlp": {"fc1": _dense(sd, f"{pre}.mlp.fc1"), "fc2": _dense(sd, f"{pre}.mlp.fc2")},
            "ls2": _np(sd[f"{pre}.layer_scale2.lambda1"]),
        }
    neck: dict = {}
    _reassemble(sd, neck, readout=False)
    _convs_and_fusion(sd, neck)
    for k in (1, 2, 3):
        neck[f"head_conv{k}"] = _conv(sd, f"head.conv{k}")
    return {"backbone": backbone, "neck": neck}


def convert_dpt_classic(sd: Mapping, num_layers: int) -> dict:
    """Flax-layout numpy tree from an HF ``DPTForDepthEstimation`` state
    dict (non-hybrid, e.g. ``Intel/dpt-large`` = MiDaS 3.0)."""
    backbone = {
        **_patch(sd, "dpt.embeddings"),
        "pos_embed": _np(sd["dpt.embeddings.position_embeddings"]),
    }
    for i in range(num_layers):
        pre = f"dpt.encoder.layer.{i}"
        backbone[f"block{i}"] = {
            "norm1": _ln(sd, f"{pre}.layernorm_before"),
            "q": _dense(sd, f"{pre}.attention.attention.query"),
            "k": _dense(sd, f"{pre}.attention.attention.key"),
            "v": _dense(sd, f"{pre}.attention.attention.value"),
            "proj": _dense(sd, f"{pre}.attention.output.dense"),
            "norm2": _ln(sd, f"{pre}.layernorm_after"),
            "mlp": {
                "fc1": _dense(sd, f"{pre}.intermediate.dense"),
                "fc2": _dense(sd, f"{pre}.output.dense"),
            },
        }
    neck: dict = {}
    _reassemble(sd, neck, readout=True)
    _convs_and_fusion(sd, neck)
    for k, idx in ((1, 0), (2, 2), (3, 4)):
        neck[f"head_conv{k}"] = _conv(sd, f"head.head.{idx}")
    return {"backbone": backbone, "neck": neck}


def convert_zoedepth(sd: Mapping, num_layers: int) -> dict:
    """Flax-layout numpy tree from an HF ZoeDepth state dict
    (``Intel/zoedepth-nyu-kitti`` layout)."""
    backbone = _patch(sd, "backbone.embeddings")
    for i in range(num_layers):
        pre = f"backbone.encoder.layer.{i}"
        att = f"{pre}.attention.attention"
        backbone[f"block{i}"] = {
            "norm1": _ln(sd, f"{pre}.layernorm_before"),
            "attn": {
                "q": _dense(sd, f"{att}.query"),
                "k": {"kernel": _np(sd[f"{att}.key.weight"]).T},
                "v": _dense(sd, f"{att}.value"),
                "proj": _dense(sd, f"{pre}.attention.output.dense"),
                "rel_pos_table": _np(
                    sd[f"{att}.relative_position_bias.relative_position_bias_table"]
                ),
            },
            "ls1": _np(sd[f"{pre}.lambda_1"]),
            "ls2": _np(sd[f"{pre}.lambda_2"]),
            "norm2": _ln(sd, f"{pre}.layernorm_after"),
            "fc1": _dense(sd, f"{pre}.intermediate.dense"),
            "fc2": _dense(sd, f"{pre}.output.dense"),
        }
    reassemble: dict = {}
    _reassemble(sd, reassemble, readout=True)
    params: dict = {"backbone": backbone, "reassemble": reassemble}
    _convs_and_fusion(sd, params)
    for k in (1, 2, 3):
        params[f"rel_conv{k}"] = _conv(sd, f"relative_head.conv{k}")
    mh = "metric_head"
    params["mh_conv2"] = _conv(sd, f"{mh}.conv2")
    params["seed_conv1"] = _conv(sd, f"{mh}.seed_bin_regressor.conv1")
    params["seed_conv2"] = _conv(sd, f"{mh}.seed_bin_regressor.conv2")
    params["seed_projector"] = {
        "conv1": _conv(sd, f"{mh}.seed_projector.conv1"),
        "conv2": _conv(sd, f"{mh}.seed_projector.conv2"),
    }
    for i in range(4):
        for name, hf in (("projector", "projectors"), ("attractor", "attractors")):
            params[f"{name}{i}"] = {
                "conv1": _conv(sd, f"{mh}.{hf}.{i}.conv1"),
                "conv2": _conv(sd, f"{mh}.{hf}.{i}.conv2"),
            }
    params["cond_log_binomial"] = {
        "mlp1": _conv(sd, f"{mh}.conditional_log_binomial.mlp.0"),
        "mlp2": _conv(sd, f"{mh}.conditional_log_binomial.mlp.2"),
    }
    return params


def convert_segformer(sd: Mapping) -> dict[str, torch.Tensor]:
    """The port's :class:`.segformer.SegformerMatte` ``state_dict`` from an
    HF ``SegformerForSemanticSegmentation`` state dict (e.g. a matte-head
    fine-tune of nvidia/mit-b0); the stages and blocks are counted from
    the checkpoint's keys."""
    tree: dict = {}
    enc = "segformer.encoder"
    stage = 0
    while f"{enc}.patch_embeddings.{stage}.proj.weight" in sd:
        tree[f"embed{stage}"] = _conv(sd, f"{enc}.patch_embeddings.{stage}.proj")
        tree[f"embed_norm{stage}"] = _ln(sd, f"{enc}.patch_embeddings.{stage}.layer_norm")
        tree[f"stage_norm{stage}"] = _ln(sd, f"{enc}.layer_norm.{stage}")
        j = 0
        while f"{enc}.block.{stage}.{j}.layer_norm_1.weight" in sd:
            pre = f"{enc}.block.{stage}.{j}"
            attn = {
                "q": _dense(sd, f"{pre}.attention.self.query"),
                "k": _dense(sd, f"{pre}.attention.self.key"),
                "v": _dense(sd, f"{pre}.attention.self.value"),
                "proj": _dense(sd, f"{pre}.attention.output.dense"),
            }
            if f"{pre}.attention.self.sr.weight" in sd:
                attn["sr"] = _conv(sd, f"{pre}.attention.self.sr")
                attn["sr_norm"] = _ln(sd, f"{pre}.attention.self.layer_norm")
            tree[f"stage{stage}_block{j}"] = {
                "norm1": _ln(sd, f"{pre}.layer_norm_1"),
                "attn": attn,
                "norm2": _ln(sd, f"{pre}.layer_norm_2"),
                "mlp": {
                    "fc1": _dense(sd, f"{pre}.mlp.dense1"),
                    "dwconv": _conv(sd, f"{pre}.mlp.dwconv.dwconv"),
                    "fc2": _dense(sd, f"{pre}.mlp.dense2"),
                },
            }
            j += 1
        stage += 1
    for i in range(stage):
        tree[f"linear_c{i}"] = _dense(sd, f"decode_head.linear_c.{i}.proj")
    tree["linear_fuse"] = _conv(sd, "decode_head.linear_fuse", bias=False)
    bn = "decode_head.batch_norm"
    tree["bn"] = {
        "scale": _np(sd[f"{bn}.weight"]),
        "bias": _np(sd[f"{bn}.bias"]),
        "mean": _np(sd[f"{bn}.running_mean"]),
        "var": _np(sd[f"{bn}.running_var"]),
    }
    tree["classifier"] = _conv(sd, "decode_head.classifier")
    return state_dict_from_flax(tree)


def convert_checkpoint(cfg, sd: Mapping) -> dict[str, torch.Tensor]:
    """HF state dict → the port's ``state_dict`` for the family ``cfg``
    selects."""
    if isinstance(cfg, ZoeDepthConfig):
        tree = convert_zoedepth(sd, cfg.backbone.num_layers)
    elif isinstance(cfg, DPTClassicConfig):
        tree = convert_dpt_classic(sd, cfg.backbone.num_layers)
    else:
        tree = convert_depth_anything(sd, cfg.backbone.num_layers)
    return state_dict_from_flax(tree)
