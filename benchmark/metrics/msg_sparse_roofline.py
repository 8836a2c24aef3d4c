"""The block-sparse grouping kernel's share of its roofline at sa1, in
percent: the least time the card could take for the pairs it had to do
(``counts.roofline_seconds`` of the selected pairs through layers 2 and 3,
and of the bytes each input and output needs once) over the device time of
its launches (``msg_sparse_kernel``, K2 one launch a scale, K3 one fused
launch) in the profiled segment. The selected pairs are the reference's
``min(in-radius, K)`` counts for the same windows."""

import counts

INFER = ("stream", "eval")


def read(t):
    if t.kind not in INFER or t.pairs is None:
        return None
    secs, launches = t.kernel_seconds("msg_sparse_kernel")
    if not launches or secs <= 0:
        return None
    m = t.model
    flops = sum(p * counts.sparse_pair_flops(w) for p, (_, _, w) in zip(t.pairs, counts.SA1_SCALES))
    nbytes = t.iters * counts.sparse_bytes(t.batch, 512, m["n_points"], m["pallas_nb"],
                                           m["pallas_fused_msg"])
    return 100.0 * counts.roofline_seconds(flops, nbytes) / secs
