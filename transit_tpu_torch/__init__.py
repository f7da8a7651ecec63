"""transit_tpu_torch: the PyTorch/CUDA port of transit_tpu.

The same line-by-line radiative-transfer model as the JAX package, on
tensors: host-side numpy planners and readers, torch ops for the spectrum
assembly, and hand-written CUDA kernels (``csrc/``) in place of the JAX
package's Pallas kernels.  Module names mirror ``transit_tpu`` so each
counterpart is easy to find.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
