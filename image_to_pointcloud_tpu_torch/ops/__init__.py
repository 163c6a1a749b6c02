"""Tensor ops of the depth→point-cloud path, with their CUDA kernels.

Counterpart of ``image_to_pointcloud_tpu/ops/__init__.py``: the same
package-level names, ``unproject_cuda`` (K3's wrapper) in the place of
``unproject_pallas``. Every submodule imports torch and the port's
``cuda`` module only.
"""

from image_to_pointcloud_tpu_torch.ops.colormap import PLASMA_RGB, apply_colormap
from image_to_pointcloud_tpu_torch.ops.depthnorm import normalize_depth
from image_to_pointcloud_tpu_torch.ops.gaussian import gaussian_blur, gaussian_kernel1d
from image_to_pointcloud_tpu_torch.ops.outlier import (
    knn_mean_distances,
    statistical_outlier_mask,
)
from image_to_pointcloud_tpu_torch.ops.resize import (
    resize2d,
    resize_area,
    resize_batched,
    resize_bicubic_pil,
    resize_linear,
)
from image_to_pointcloud_tpu_torch.ops.unproject import (
    DENSITY_STRIDES,
    focal_length,
    num_points,
    unproject,
    unproject_cuda,
)
from image_to_pointcloud_tpu_torch.ops.voxel import voxel_downsample

__all__ = [
    "PLASMA_RGB",
    "apply_colormap",
    "normalize_depth",
    "gaussian_blur",
    "gaussian_kernel1d",
    "knn_mean_distances",
    "statistical_outlier_mask",
    "resize2d",
    "resize_batched",
    "resize_area",
    "resize_bicubic_pil",
    "resize_linear",
    "DENSITY_STRIDES",
    "focal_length",
    "num_points",
    "unproject",
    "unproject_cuda",
    "voxel_downsample",
]
