"""The whole training step's share of the card's peak, in percent: three
times the published forward's operations of the windows of the untraced
segment (``counts.train_flops``) over its host-clock seconds and the dense
TF32 tensor-core peak."""

import counts


def read(t):
    if t.kind != "train" or not t.plain_s or t.device_name in ("", "cpu"):
        return None
    flops = counts.train_flops(t.model) * t.plain_windows
    return 100.0 * flops / t.plain_s / counts.PEAKS["tf32_flop_per_s"]
