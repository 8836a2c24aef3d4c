"""The whole inference step's share of the card's peak, in percent: the
published algorithm's operations of the windows of the untraced segment
(``counts.forward_flops``) over its host-clock seconds and the dense TF32
tensor-core peak."""

import counts

INFER = ("stream", "eval")


def read(t):
    if t.kind not in INFER or not t.plain_s or t.device_name in ("", "cpu"):
        return None
    flops = counts.forward_flops(t.model) * t.plain_windows
    return 100.0 * flops / t.plain_s / counts.PEAKS["tf32_flop_per_s"]
