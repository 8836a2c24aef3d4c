"""The plain reference of TEHNet with ERPC, MANO and the training losses.

Plain PyTorch, float32, no kernels, no chunking and no caches: the
published PointNet++ multi-scale grouping (a ball query of the first K
in-radius points, a gather, the conv/BN/ReLU chain, a max over the K slots)
at every set-abstraction layer, in eval and in training. It imports nothing
of the measured program and nothing of JAX. Its parameter names are the
original Ev2Hands torch names (``sa1.conv_blocks.0.0.weight``, ...), so one
state dict feeds it and the program alike.

Random draws (the ERPC noise and resample, the FPS starts of training,
dropout) are taken from a ``torch.Generator`` in the order and at the shapes
the published training step takes them, so a generator seeded alike gives
both sides the same draws.

``precision="tf32"`` is the control: every matrix product and convolution
runs with its operands rounded to TF32 (on the card the tensor cores' TF32
mode, on the CPU an emulation that rounds the operands' mantissas to 10
bits).
"""
