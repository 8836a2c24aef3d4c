"""Host syncs of one training step, counted under
``torch.cuda.set_sync_debug_mode("warn")`` (the sites go to the result's
``sync_sites``)."""


def read(t):
    if t.kind != "train" or t.syncs is None or not t.sync_steps:
        return None
    return t.syncs / t.sync_steps
