"""The device's idle share of a training loop, in percent. The device's
busy seconds a window come from torch.profiler's trace of the device alone
(the union of its operations' intervals over the device-profiled segment);
the window is the untraced segment's host-clock seconds, whose windows
the busy time is scaled to. The profiler slows the host (by about a third
for the training step's ~5,000 launches), so the traced segment's own
wall time would overstate the idle share of a run."""


def read(t):
    if t.kind != "train" or not t.windows or not t.plain_s or not t.device_ops:
        return None
    busy = t.busy_s() * t.plain_windows / t.windows
    return 100.0 * (1.0 - busy / t.plain_s)
