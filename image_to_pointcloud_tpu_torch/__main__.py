"""``python -m image_to_pointcloud_tpu_torch`` → the CLI."""

from image_to_pointcloud_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
