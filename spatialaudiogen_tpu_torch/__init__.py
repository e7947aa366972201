"""spatialaudiogen_tpu_torch — PyTorch/CUDA port of spatialaudiogen_tpu.

The JAX package beside it is the reference. This package mirrors its module
names (config, ops.dft, models.layers/resnet/sptaudiogen, deploy.deploy,
cli.deploy) so each port sits next to its counterpart, and reuses the JAX
package's framework-free host modules (dsp.geometry, data.readers/packed,
utils.io_audio, data.generic). It imports torch and numpy, never jax.

Covered so far: the flagship model's forward pass and the batch deploy
engine (`deploy.deploy.MonoToAmbix`), with the fused masked comb-ISTFT as a
hand-written CUDA kernel (ops/csrc/masked_istft.cu).
"""

__version__ = "0.1.0"
