"""PyTorch/CUDA port of ev2hands_tpu for NVIDIA Hopper.

The JAX package ``ev2hands_tpu`` is the reference; this package imports
nothing of it and nothing of JAX. Entry points: ``serve.InferencePipeline``
(inference) and ``train.make_train_step`` (one training step).
Hand-written kernels live in ``csrc/`` and are built on first use
(``ops/_build.py``).
"""
