"""spatialaudiogen_tpu_torch — PyTorch/CUDA port of spatialaudiogen_tpu.

The JAX package beside it is the reference. This package mirrors its module
names (config, dsp, data, ops.dft, models, train, deploy.deploy, cli) so
each port sits next to its counterpart, and keeps its own copies of the
framework-free host modules it needs (dsp.geometry, data.readers/packed,
utils.io_audio, ...). It imports torch and numpy, never jax and nothing of
the JAX package.

Covered so far: the flagship model's forward pass, the batch deploy engine
(`deploy.deploy.MonoToAmbix`) and training on one device
(`train.trainer.Trainer`, `cli.train`), with the fused masked comb-ISTFT
and its fused backward as hand-written CUDA kernels (ops/csrc/).
"""

__version__ = "0.1.0"
