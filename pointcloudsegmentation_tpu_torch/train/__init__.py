"""Model registry, trainer, metrics and checkpoints (mirror of
``pointcloudsegmentation_tpu.train`` for the flagship's single-card
training path)."""
