"""Device kernels launched a training step: the kernels in torch.profiler's
trace of the profiled segment (copies and fills not counted) over its
steps."""


def read(t):
    if t.kind != "train" or not t.iters or not t.device_ops:
        return None
    return len(t.kernels()) / t.iters
