"""PyTorch/CUDA port of ev2hands_tpu for NVIDIA Hopper.

The JAX package ``ev2hands_tpu`` is the reference; this package imports
nothing of it and nothing of JAX. Entry points: ``serve.InferencePipeline``
(inference), ``train`` (``make_train_step``, one training step, and the
training loop, ``python -m ev2hands_tpu_torch.train``), ``finetune``
(finetuning on Ev2Hands-R) and ``evaluate`` / ``evaluate_real`` (Ev2Hands-S
and Ev2Hands-R evaluation). Hand-written kernels and the host batch loader
live in ``csrc/`` and are built on first use (``ops/_build.py``).
"""
