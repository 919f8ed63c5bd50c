"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of the
ScaleGANN reproduction: one command runs one cell (a configuration under a
traffic mix) once on one H100.  See README.md."""
