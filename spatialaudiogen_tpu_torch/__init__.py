"""spatialaudiogen_tpu_torch — PyTorch/CUDA port of spatialaudiogen_tpu.

The JAX package beside it is the reference. This package mirrors its module
names (config, dsp, data, ops.dft, models, train, deploy.deploy, cli) so
each port sits next to its counterpart, and keeps its own copies of the
framework-free host modules it needs (dsp.geometry, data.readers/packed,
utils.io_audio, ...). It imports torch and numpy, never jax and nothing of
the JAX package.

It covers all that the JAX package does: the model (with its remat and
hermitian_dft configurations), deploy, training on one card or several,
eval, streaming serving, the flow ETL, the tools around the model and the
generic library (ResNets, recurrent layers, GenericHarness, image
preprocessing, profiling). The JAX package's three Pallas kernels are
hand-written CUDA kernels here (ops/csrc/); the JAX names with no
counterpart are JAX machinery (ROADMAP.md lists each with its reason).
"""

__version__ = "0.1.0"
