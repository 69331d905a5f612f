"""Geometry and neighborhood ops (mirror of
``pointcloudsegmentation_tpu.ops``)."""
