"""Sampling: uint32 hashes, Owen-scrambled Sobol and the distributions the
slice samples from. Port of the slice's part of ``bifrost3d_tpu/sampling``.
"""
