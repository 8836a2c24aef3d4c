"""Device milliseconds a window in the two MANO regressor heads
(``left_mano_regressor`` and ``right_mano_regressor`` of the program's
TEHNet), from CUDA events on their forward hooks over the hooked segment."""


def read(t):
    if t.heads_ms is None or not t.heads_windows:
        return None
    return t.heads_ms / t.heads_windows
