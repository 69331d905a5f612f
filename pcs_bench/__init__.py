"""The benchmark of ``pointcloudsegmentation_tpu_torch`` on one H100: cells
of a configuration and a traffic mix, found by name from the files beside
this one (see README.md)."""
