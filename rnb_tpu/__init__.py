"""rnb_tpu — reflectance+normal multi-view surface reconstruction in JAX.

A from-scratch JAX/XLA framework with the capabilities of RNb-NeuS
(CVPR 2024): NeuS-style neural-SDF surface reconstruction supervised by
photometric-stereo normal/albedo maps re-rendered under virtual lights.

Layer map (mirrors the reference's layering, reference files cited per module):

  cli / exp entrypoint      rnb_tpu.cli
  runner (train/validate)   rnb_tpu.train.runner
  volume renderer           rnb_tpu.models.renderer
  neural fields             rnb_tpu.models.fields, rnb_tpu.models.embedder
  dataset / cameras/lights  rnb_tpu.data.dataset, rnb_tpu.data.lights
  parallelism               rnb_tpu.parallel  (greenfield: mesh/shard_map/psum)
  host kernels              rnb_tpu.ops       (C++ marching cubes)

Numerics: the program's matmul precision has one home,
``rnb_tpu.train.step.TrainConfig.matmul_precision`` ('high'; on an H100 an
f32 dot at 'high' runs in TF32 with f32 accumulation). Nothing is set at
import.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ=_os.environ) -> str:
    """Where compiled programs are cached: ``JAX_COMPILATION_CACHE_DIR`` when
    set (JAX reads it itself), else the fixed ``<checkout>/.jax_cache``. The
    path is part of the cache key, so it never depends on time, pid or a temp
    dir."""
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_REPO_ROOT, ".jax_cache"))


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
