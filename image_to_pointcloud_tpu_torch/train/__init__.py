"""Fine-tuning of the depth models on one device: losses, metrics, data, checkpoints, the trainer."""
