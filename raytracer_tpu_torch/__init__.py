"""raytracer_tpu_torch — the PyTorch / CUDA port of ``raytracer_tpu``.

The JAX package beside it is the reference: every module here mirrors the
module at the same path under ``raytracer_tpu/`` and keeps its public names
and signatures, so a test can feed both the same numpy inputs.

This first slice is the MIS path tracer on analytic scenes and on triangle
meshes through the wave2 sort-join engine:

    render/      Viewport, render_passes, film accumulation
    integrators/ path_tracer (naive + MIS, fused shadow query)
    scene/       SoA scene NamedTuples, camera, builder, clusters, BVH perm
    ops/         intersect, traverse, wave2 engine (+ CUDA MT kernel), BSDF,
                 lights, materials
    math/        SoA vector math, sampling, microfacet, fresnel, transforms
    sampler/     counter-based deterministic sample streams (+ Halton)
    io/          reference-format JSON scene loading
    csrc/        hand-written CUDA C++ kernels (built with nvcc at first use)

The package imports torch, numpy and the stdlib, and never jax.  Every
tensor lives on the device the caller names: ``Viewport(..., device=)``,
``SceneBuilder.build(device)``; nothing picks a device by default.
"""

__version__ = "0.1.0"
