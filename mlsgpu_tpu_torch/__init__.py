"""mlsgpu_tpu_torch — the PyTorch/CUDA port of mlsgpu_tpu.

The same reconstruction (MLS implicit surface over binned splats, marching
tetrahedra, out-of-core mesher) with the device stages written in PyTorch and
the MLS field kernel hand-written in CUDA C++ for Hopper
(`csrc/mls_field.cu`). The JAX package `mlsgpu_tpu` is the reference; this
package carries its own copy of the host layer (config, io, blobs,
bucketing, mesher, native helpers) and imports neither `mlsgpu_tpu` nor
`jax`.
"""

__version__ = "0.1.0"
