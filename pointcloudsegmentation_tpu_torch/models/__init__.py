"""Model modules (mirror of ``pointcloudsegmentation_tpu.models``)."""
