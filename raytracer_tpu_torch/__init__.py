"""raytracer_tpu_torch — the PyTorch / CUDA port of ``raytracer_tpu``.

The JAX package beside it is the reference: every module here mirrors the
module at the same path under ``raytracer_tpu/`` and keeps its public names
and signatures, so a test can feed both the same numpy inputs.

So far: the MIS path tracer on analytic scenes and on triangle meshes, the
mesh through a selectable traversal backend (the wave2 sort-join engine by
default; the binned-wavefront ``wave`` engine; the skip-link ``bvh`` walk;
the block-candidate ``sorted-pallas`` path; the per-ray ``cluster`` path),
differentiable by autograd through ``render.renderer.trace_rows``; the
light tracer, VCM and the debug renderer; the scene effects (motion blur
of prims, instances and the camera, bokeh shapes, decals, spectral
rendering with dispersive materials); adaptive block rendering,
checkpoint / resume and per-pixel path replay; and multi-device rendering
over ``torch.distributed`` (pixel-row bands, VCM's photon gather, the
sharded train step):

    render/      Viewport, render_passes, film accumulation, trace_rows,
                 trace_pixels, adaptive (AdaptiveViewport), checkpoint,
                 path_debug (debug_pixel_path), postprocess
    parallel/    mesh: init_distributed, make_mesh, make_multihost_mesh,
                 film_sharding / gather_film, render_pass_sharded,
                 render_pass_vcm_sharded, train_step(_sharded)
    integrators/ path_tracer (naive + MIS, fused shadow query)
    scene/       SoA scene NamedTuples, camera, builder, clusters, BVH perm
    ops/         intersect, traverse (mode dispatch), wave2 and wave engines,
                 block-candidate and per-ray cluster traversal, BSDF, lights,
                 materials, the launch probe, the CUDA kernel build
    math/        SoA vector math, sampling, microfacet, fresnel, transforms,
                 packed codecs (octahedral, fp16, RGBE, YCoCg, R11G11B10)
    utils/       leveled logger; profiler: spans and host-sync counters on the
                 torch.profiler clock, Chrome traces with the spans
    color/       sRGB / tonemapping, the spectral resolve
    sampler/     counter-based deterministic sample streams (+ Halton)
    io/          reference-format JSON scene loading, OBJ meshes
    native/      the C++ BVH builder (built with g++ at first use)
    csrc/        hand-written CUDA C++ kernels (built with nvcc at first use)

The package imports torch, numpy and the stdlib, never jax and nothing of
``raytracer_tpu``.  Every
tensor lives on the device the caller names: ``Viewport(..., device=)``,
``SceneBuilder.build(device)``; nothing picks a device by default.
"""

__version__ = "0.1.0"
