"""The batched depth→point-cloud pipeline."""
