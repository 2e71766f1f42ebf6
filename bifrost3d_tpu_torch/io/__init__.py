"""I/O: PNG output. Port of the slice's part of ``bifrost3d_tpu/io``."""
