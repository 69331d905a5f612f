"""Model registry (mirror of ``pointcloudsegmentation_tpu.train.model_zoo``);
the trainer is not ported yet."""
