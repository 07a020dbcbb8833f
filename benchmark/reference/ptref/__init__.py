"""A frozen plain copy of the path tracer's estimator, the reference that
decides the benchmark's ``correct``.

Copied from the program's plain PyTorch versions (core/, scene/, bsdf/,
emitters/, media/, ops/intersect, models/path_tracer, models/volume_pt)
and cut to what the benchmark's cells run: the segment form of the
sorted-wavefront estimator (the surface bounce and the homogeneous-media
bounce), the scenes of its configurations, the area emitters and the
envmap, pcg streams. Every walk is the brute force over all prims
(ops/intersect); no tree, kernel, grid medium, Sobol sampler, light
tracer or differentiable mode is left. It imports nothing of the
program, so a later change to the program cannot move it. Keep it frozen:
the benchmark's limits were set against it.
"""
