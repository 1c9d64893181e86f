"""The benchmark's plain reference renderer.

A frozen copy of the plain PyTorch modules of the program's MIS path
tracer (sampler, camera, scene loading, BSDFs, lights, materials, analytic
prims, film, postprocess), taken from ``raytracer_tpu_torch`` and never
imported from it, so that later changes to the program cannot move the
yardstick.  Mesh intersection is the reference's own (``ops/traverse.py``);
``trace.py`` traces any set of (pixel, pass) samples in one wavefront.
Everything runs in float32 with TF32 off; ``ops.traverse.LOW_PRECISION``
and ``trace.lower`` give the bfloat16 control.
"""
