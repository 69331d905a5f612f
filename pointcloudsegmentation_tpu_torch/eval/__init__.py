"""Full-scene inference (mirror of ``pointcloudsegmentation_tpu.eval``)."""
