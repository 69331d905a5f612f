"""Model registry, trainer, metrics, checkpoints and the training CLI
(mirror of ``pointcloudsegmentation_tpu.train`` on one card)."""
